"""Chip smoke test of the PyTorch/CUDA port (cal_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds every CUDA kernel of the serving path from cal_tpu_torch/csrc
   (one nvcc per source, all at once);
2. kernel phase: on a real synthetic batch at the serving shapes (B=128,
   N=256, H=128), holds each kernel against its plain PyTorch twin on the
   card, in bf16 and f32, and times kernel, twin and (where one exists) a
   single PyTorch call computing the same function, with CUDA events on a
   cold L2;
3. serving phase: saves a seeded CausalGCN (hidden 128, 3 layers, bf16) with
   the port's checkpointer, drives ``cal_tpu_torch.main_syn --inference``
   with the launch counters set to 0 just before, and fails unless every
   kernel of the path launched; then checks the forward against the plain
   twins on the card (bf16) and against the CPU on a small f32 input.

Prints one JSON line per result, then a ``{"kernels": [...]}`` line, the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
CUDA or the package is missing, or when any check fails.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B, TEST_GRAPHS, H, LAYERS = 128, 256, 128, 3
DATA_NUM = 320            # test split = 8 * int(0.1 * DATA_NUM) = 256 graphs
SEED = 666
# Published dense peaks (NVIDIA data sheets): bytes/s, bf16 FLOP/s, f32 FLOP/s
# (f32 outside the tensor cores: the f32 paths keep full f32, no TF32).
PEAKS = {"H100 SXM": (3.35e12, 989e12, 67e12), "H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12), "H200": (4.8e12, 989e12, 67e12)}
# Kernel vs plain twin on the card.  adj: exact.  f32: the same f32 math with
# sums in another order and the approximate rsqrtf (2 ulp).  bf16: a norm
# entry can round to the neighbouring bf16 value when the f32 degree differs
# in its last bits (2^-8 of a norm <= 1, times |x| of a few), and the output
# is itself rounded to bf16 (2^-8 relative).
DUAL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 1.6e-2)}   # (atol, rtol)
# Whole forward, log-probs: bf16 as in tests/test_torch_port_model.py (single
# bf16 ulps propagate through BatchNorm and the f32 readouts); f32 on a small
# input, card against CPU (cuBLAS and the CPU sum in other orders).
FWD_TOL = {"bfloat16": (5e-2, 5e-2), "float32": (1e-4, 1e-4)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def peaks_for(name: str):
    for key in ("H200", "PCIe", "NVL"):
        if key in name:
            return next(v for k, v in PEAKS.items() if key in k), key
    return PEAKS["H100 SXM"], "H100 SXM"


def time_ms(torch, fn, flush, reps=30, warmup=3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``, each after a write
    of a buffer larger than L2 (inputs come from device memory).  A short
    device-side sleep ahead of the start event keeps the card busy while the
    host enqueues ``fn``, so the host's launch cost is not timed."""
    sleep = getattr(torch.cuda, "_sleep", None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if sleep is not None:
            sleep(1_000_000)            # ~0.5 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_excess(torch, got, ref, atol, rtol):
    """(max |got - ref|, max of |got - ref| - (atol + rtol |ref|))."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    return float(err.max()), float((err - (atol + rtol * ref.abs())).max())


def kernel_phase(torch, batch, peaks, flush):
    from cal_tpu_torch.ops.adj_build import adj_build, adj_build_plain
    from cal_tpu_torch.ops.fused_gcn import (
        fused_gcn_dense_att_dual, fused_gcn_dense_att_dual_plain)

    bw, bf16_peak, f32_peak = peaks
    ef = batch.edge_flat
    bsz, n, _ = batch.x.shape
    e = ef.shape[0]
    ef64 = ef.long()
    results = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        elt = torch.tensor([], dtype=dt).element_size()
        adj_k = adj_build(ef, bsz, n, dt)
        adj_p = adj_build_plain(ef, bsz, n, dt)
        torch.cuda.synchronize()
        check(torch.equal(adj_k, adj_p), f"adj_build {dt_name} differs from its plain twin")
        a_bytes = e * ef.element_size() + bsz * n * n * elt
        adj = {
            "name": "adj_build", "dtype": dt_name, "max_abs_err": 0.0,
            "kernel_ms": time_ms(torch, lambda: adj_build(ef, bsz, n, dt), flush),
            "plain_ms": time_ms(torch, lambda: adj_build_plain(ef, bsz, n, dt), flush),
            "library_ms": time_ms(
                torch, lambda: torch.bincount(ef64, minlength=bsz * n * n + 1), flush),
            "library_call": "torch.bincount(edge_flat.long(), minlength=B*N*N+1)",
            "bytes": a_bytes, "flops": 0,
            "bound_ms": a_bytes / bw * 1e3, "bound_by": "bytes",
            "edges": e, "real_edges": int((ef < bsz * n * n).sum()),
        }
        emit({"phase": "kernel", **adj})

        gen = torch.Generator(device="cuda").manual_seed(SEED)
        xc = torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt)
        xo = torch.randn((bsz, n, H), generator=gen, device="cuda").to(dt)
        src = torch.randn((bsz, n), generator=gen, device="cuda").to(dt)
        dst = (2.0 * torch.randn((bsz, n), generator=gen, device="cuda")).to(dt)
        args = (xc, xo, adj_k, src, dst)
        oc_k, oo_k = fused_gcn_dense_att_dual(*args)
        oc_p, oo_p = fused_gcn_dense_att_dual_plain(*args)
        torch.cuda.synchronize()
        atol, rtol = DUAL_TOL[dt_name]
        err_c, over_c = max_excess(torch, oc_k, oc_p, atol, rtol)
        err_o, over_o = max_excess(torch, oo_k, oo_p, atol, rtol)
        check(bool(torch.isfinite(oc_k.float()).all() and torch.isfinite(oo_k.float()).all()),
              f"dual forward {dt_name} not finite")
        check(max(over_c, over_o) <= 0,
              f"dual forward {dt_name} differs from its plain twin: {err_c} {err_o}")
        d_bytes = (bsz * n * n + 4 * bsz * n * H + 2 * bsz * n) * elt
        d_flops = 2 * 2 * bsz * n * n * H
        t_bytes = d_bytes / bw
        t_ops = d_flops / (bf16_peak if dt == torch.bfloat16 else f32_peak)
        dual = {
            "name": "fused_gcn_dense_att_dual_fwd", "dtype": dt_name,
            "max_abs_err": max(err_c, err_o), "atol": atol, "rtol": rtol,
            "kernel_ms": time_ms(torch, lambda: fused_gcn_dense_att_dual(*args), flush),
            "plain_ms": time_ms(torch, lambda: fused_gcn_dense_att_dual_plain(*args), flush),
            "library_ms": None, "bytes": d_bytes, "flops": d_flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        emit({"phase": "kernel", **dual})
        results[dt_name] = (adj, dual)
    return results


def profile_forward(torch, model, batch, to_dense, top=16) -> None:
    """Device time of one warm bf16 forward (adjacency build included), by
    operator, from torch.profiler; and its wall time on the host clock
    (median of 10, each ending in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    run = lambda: model(to_dense(batch, torch.bfloat16), eval_random=False)
    with torch.no_grad():
        walls = []
        for _ in range(12):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        fwd_ms = statistics.median(walls[2:])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    # device-side events only: the operator-level rows repeat their kernels' time
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    rows = sorted(((e.key, dev(e) / 1e3, e.count) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and dev(e) > 0),
                  key=lambda r: -r[1])
    emit({"phase": "profile_forward", "batch": list(batch.x.shape), "wall_ms": fwd_ms,
          "device_ms": sum(r[1] for r in rows),
          "top": [{"op": k, "device_ms": t, "calls": c} for k, t, c in rows[:top]]})


def serving_phase(torch, test_set):
    from unittest import mock

    import cal_tpu_torch.graph as graph_mod
    import cal_tpu_torch.models.causal as causal_mod
    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.main_syn import main
    from cal_tpu_torch.models.factory import get_model
    from cal_tpu_torch.ops.adj_build import adj_build, adj_build_plain
    from cal_tpu_torch.ops.fused_gcn import (
        fused_gcn_dense_att_dual, fused_gcn_dense_att_dual_plain)
    from cal_tpu_torch.train.causal import evaluate_causal
    from cal_tpu_torch.utils.checkpoint import Checkpointer
    from cal_tpu_torch.utils.config import Config

    save_dir = os.path.join(HERE, "build", "chip_smoke_ckpt")
    argv = ["--model", "CausalGCN", "--inference", "true", "--save_dir", save_dir,
            "--data_num", str(DATA_NUM), "--seed", str(SEED), "--dtype", "bfloat16",
            "--hidden", str(H), "--layers", str(LAYERS), "--batch_size", str(B),
            "--device", "cuda"]
    cfg = Config(model="CausalGCN", hidden=H, layers=LAYERS, batch_size=B,
                 dtype="bfloat16", seed=SEED)
    feat = test_set[0].x.shape[1]
    model = get_model(cfg, feat, cfg.num_classes)
    Checkpointer(save_dir).save(0, model, {"epoch": 0})

    kernels = (adj_build, fused_gcn_dense_att_dual)
    for k in kernels:
        k.launches = 0
    res = main(argv)
    launches = {k.__name__: k.launches for k in kernels}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the serving path never launched: {launches}")
    emit({"phase": "serving", "graphs": res["graphs"], "seconds": res["seconds"],
          "graphs_per_s": res["graphs"] / res["seconds"],
          "test_acc_co": res["test_acc_co"], "test_acc_c": res["test_acc_c"],
          "test_acc_o": res["test_acc_o"], "launches": launches,
          "hidden": H, "layers": LAYERS, "batch": B, "dtype": "bfloat16"})
    check(res["graphs"] == len(test_set), "serving sweep missed graphs")
    warm = evaluate_causal(test_set, Config(
        model="CausalGCN", inference=True, save_dir=save_dir, data_num=DATA_NUM,
        seed=SEED, dtype="bfloat16", hidden=H, layers=LAYERS, batch_size=B,
        device="cuda"))
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in Loader(test_set, B).host_batches())
    pack_s = time.perf_counter() - t0
    emit({"phase": "serving_warm", "graphs": warm["graphs"], "seconds": warm["seconds"],
          "graphs_per_s": warm["graphs"] / warm["seconds"],
          "host_pack_ms_per_batch": pack_s / n_batches * 1e3})

    # the same forward through the plain twins, on the card
    batch = next(Loader(test_set, B).host_batches()).to("cuda")
    model = model.to("cuda").eval()
    with torch.no_grad():
        g = graph_mod.to_dense(batch, torch.bfloat16)
        check(g.adj.shape[1] == 256, f"node budget {g.adj.shape[1]} != 256")
        out_k = model(g, eval_random=False)
        with mock.patch.object(graph_mod, "adj_build", adj_build_plain), \
                mock.patch.object(causal_mod, "fused_gcn_dense_att_dual",
                                  fused_gcn_dense_att_dual_plain):
            out_p = model(graph_mod.to_dense(batch, torch.bfloat16), eval_random=False)
    profile_forward(torch, model, batch, graph_mod.to_dense)
    atol, rtol = FWD_TOL["bfloat16"]
    errs = []
    for a, b in zip(out_k, out_p):
        check(a.shape == (B, cfg.num_classes) and bool(torch.isfinite(a).all()),
              "serving log-probs not finite or misshapen")
        err, over = max_excess(torch, a, b, atol, rtol)
        check(over <= 0, f"bf16 forward differs from the plain twins by {err}")
        errs.append(err)

    # small f32 input: card (kernels) against the CPU (plain twins)
    cfg32 = cfg.replace(dtype="float32")
    m32 = get_model(cfg32, feat, cfg.num_classes).eval()
    small = next(Loader(test_set[:16], 16).host_batches())
    with torch.no_grad():
        ref = m32(graph_mod.to_dense(small.to("cpu"), torch.float32), eval_random=False)
        got = m32.to("cuda")(graph_mod.to_dense(small.to("cuda"), torch.float32),
                             eval_random=False)
    atol32, rtol32 = FWD_TOL["float32"]
    errs32 = []
    for a, b in zip(got, ref):
        err, over = max_excess(torch, a.cpu(), b, atol32, rtol32)
        check(over <= 0, f"f32 forward on the card differs from the CPU by {err}")
        errs32.append(err)
    emit({"phase": "forward_check", "bf16_vs_plain_max_abs_err": max(errs),
          "bf16_tol": [atol, rtol], "f32_card_vs_cpu_max_abs_err": max(errs32),
          "f32_tol": [atol32, rtol32], "f32_graphs": 16})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "cal_tpu_torch")):
        print("chip_smoke: the cal_tpu_torch package is missing", file=sys.stderr)
        return 2
    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
    from cal_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks, peaks_of = peaks_for(name)
    t0 = time.perf_counter()
    report = build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "nvidia_smi": smi, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_seconds": build_s,
          "peaks_of": peaks_of, "bytes_per_s": peaks[0],
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in report.items()}})

    t0 = time.perf_counter()
    ds = generate_synthetic_dataset(data_num=DATA_NUM, seed=SEED)
    _, _, test_set, _ = dataset_bias_split(ds, bias=0.5, total=DATA_NUM * 4, seed=SEED)
    check(len(test_set) == TEST_GRAPHS, f"test split has {len(test_set)} graphs")
    batch = next(Loader(test_set, B).host_batches()).to("cuda")
    check(tuple(batch.x.shape[:2]) == (B, 256), f"batch shape {tuple(batch.x.shape)}")
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "test_graphs": len(test_set), "batch_shape": list(batch.x.shape)})

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = kernel_phase(torch, batch, peaks, flush)
    launches = serving_phase(torch, test_set)

    sources = {"adj_build": ("cal_tpu_torch/csrc/adj_build.cu",
                             "cal_tpu/ops/pallas_adj.py:38"),
               "fused_gcn_dense_att_dual_fwd": ("cal_tpu_torch/csrc/fused_gcn.cu",
                                                "cal_tpu/ops/pallas_gcn.py:283")}
    counters = {"adj_build": launches["adj_build"],
                "fused_gcn_dense_att_dual_fwd": launches["fused_gcn_dense_att_dual"]}
    rows = []
    for r in results["bfloat16"]:
        src, rep = sources[r["name"]]
        rows.append({"name": r["name"], "route": "cuda", "source": src, "replaces": rep,
                     "launches": counters[r["name"]], "max_abs_err": r["max_abs_err"],
                     "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "dtype": "bfloat16"})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
