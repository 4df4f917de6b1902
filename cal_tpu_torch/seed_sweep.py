"""Run one ``main_syn`` training configuration over several seeds at once.

    python -m cal_tpu_torch.seed_sweep --seeds 666-675 --parallel 4 \
        --out build/seed_sweep -- --model CausalGAT --bias 0.9 --lr 0.002 \
        --min_lr 5e-6 --dtype bfloat16

Each seed runs ``python -m cal_tpu_torch.main_syn <args> --seed S
--metrics_path <out>/seed_S.jsonl`` with its output in ``<out>/seed_S.log``;
at most ``--parallel`` runs share the card at a time (the training steps are
host-bound, so a few runs fill it better than one).  At the end the script
prints, per seed, the test accuracies of the selected epoch (co, c, o), the
selected epoch, and the mean and standard deviation of the val o-accuracy
over the late epochs (``--late``), then the medians, and writes the same as
JSON to ``<out>/summary.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _seeds(spec: str) -> list[int]:
    if "-" in spec:
        lo, hi = (int(v) for v in spec.split("-"))
        return list(range(lo, hi + 1))
    return [int(v) for v in spec.split(",")]


def summarize(path: str, late: tuple[int, int]) -> dict:
    """Selection and late-val statistics of one run's metrics jsonl."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    final = next(r for r in recs if r["event"] == "final")
    vals = [100 * r["val_acc_o"] for r in recs
            if r["event"] == "epoch" and late[0] <= r["epoch"] <= late[1]]
    return {"co": 100 * final["test_acc_co"], "c": 100 * final["test_acc_c"],
            "o": 100 * final["test_acc_o"], "epoch": final["epoch"],
            "late_val_mean": statistics.mean(vals) if vals else None,
            "late_val_sd": statistics.pstdev(vals) if len(vals) > 1 else None}


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="666-675")
    p.add_argument("--parallel", type=int, default=3)
    p.add_argument("--out", default="build/seed_sweep")
    p.add_argument("--late", default="51-100", help="epoch range of the val sd")
    args = p.parse_args(argv[:split])
    train_args = argv[split + 1:]
    late = tuple(int(v) for v in args.late.split("-"))
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")

    pending, running, results = list(_seeds(args.seeds)), {}, {}
    t0 = time.perf_counter()
    while pending or running:
        while pending and len(running) < args.parallel:
            s = pending.pop(0)
            metrics = os.path.join(args.out, f"seed_{s}.jsonl")
            if os.path.exists(metrics):
                os.unlink(metrics)
            log = open(os.path.join(args.out, f"seed_{s}.log"), "w")
            cmd = [sys.executable, "-m", "cal_tpu_torch.main_syn", *train_args,
                   "--seed", str(s), "--metrics_path", metrics]
            running[s] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                           env=env), log, metrics)
        time.sleep(2)
        for s, (proc, log, metrics) in list(running.items()):
            if proc.poll() is None:
                continue
            log.close()
            del running[s]
            if proc.returncode != 0:
                results[s] = {"error": f"exit {proc.returncode}"}
            else:
                results[s] = summarize(metrics, late)
            print(f"seed {s}: {results[s]} ({time.perf_counter() - t0:.0f} s)",
                  flush=True)

    ok = [r for r in results.values() if "error" not in r]
    med = {k: statistics.median(r[k] for r in ok) for k in ("co", "c", "o")} if ok else {}
    summary = {"args": train_args, "late": list(late),
               "seeds": {str(s): results[s] for s in sorted(results)},
               "median": med, "seconds": time.perf_counter() - t0}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("seed | co | c | o | epoch | late val mean ± sd")
    for s in sorted(results):
        r = results[s]
        if "error" in r:
            print(f"{s} | {r['error']}")
        else:
            print(f"{s} | {r['co']:.2f} | {r['c']:.2f} | {r['o']:.2f} | {r['epoch']} | "
                  f"{r['late_val_mean']:.1f} ± {r['late_val_sd']:.1f}")
    print("median:", json.dumps(med))
    if len(ok) != len(results):
        raise SystemExit(1)
    return summary


if __name__ == "__main__":
    main()
