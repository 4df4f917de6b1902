"""Headline benchmarks of the port: causal-training throughput (edges/s) on
one card.  Counterpart of the root ``bench.py``, with its four configs and
metric names, one JSON line each (headline first):

1. ``causal_train_edges_per_s``: the canonical dev loop (main_syn defaults:
   CausalGCN, hidden 128, 3 layers, batch 128, synthetic BA/tree + motif
   graphs, bf16 conv stack), the whole train step (forward, three-branch
   loss, backward, Adam), dense layout;
2. ``causal_gat_train_edges_per_s``: the same loop with CausalGAT;
3. ``sparse_pack_train_edges_per_s``: CausalGCN on budget-packed sparse
   batches of 256 REDDIT-shaped threads (degree + one-hot degree features),
   ``vs_baseline`` against the same graphs under the worst-case budgets;
4. ``spmm_tiled_edges_per_s``: forward plus backward (in x, src and dst) of
   the single sigmoid-weighted sparse aggregate (kernel-table row 12, K13-K16)
   on a V = 8,192, E = 131,072 graph, H = 128, x in bf16 and the logits in
   f32 (the root bench's), 50 chained iterations; ``vs_baseline`` is its plain PyTorch twin's time on the same
   card over the kernels'; ``pct_hbm_roofline`` is cal_tpu's byte floor (one
   gathered f32 row read and one written per live edge, three passes: the
   forward SpMM, the dx SpMM and the SDDMM) over the card's HBM rate.

Configs 1-3 time the port's training on batches staged on the device
once: a warm-up of at least 40 steps, then a timed window that reads
nothing back and does not synchronize (``torch.cuda.set_sync_debug_mode``
holds it to that) until one read at its end; the time is the host's wall
clock around the window.  Configs 1-3 time the device-side epoch
(``make_causal_train_epoch``: on the card, each step a replay of one CUDA
graph of the step), ``epochs_per_call`` epochs a call as the root bench's
superstep (``max(1, 30 // batches)``), and report ``steps_per_call``.
Steps of a packed epoch's empty batches count as steps (the epoch skips
them on the host), as the root bench's skipped scan steps do.  ``vs_baseline`` of
configs 1-2 divides by the CPU torch loop of ``benchmarks/baseline_perf.json``.

Left out, because their definitions are TPU mechanisms: ``pct_mxu_peak``
and ``pct_mxu_floor`` (one-hot MXU tiles) and configs 1-2's
``pct_hbm_roofline`` (XLA's compiled cost analysis).

    python -m cal_tpu_torch.bench [--device cpu] [--scale 0.25]

The first line names the card and its power limit.  ``--device cpu`` runs
the same code on the kernels' plain twins; ``--scale`` shortens each timed
window (and config 4's iterations) by that factor, the warm-ups kept.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time

import numpy as np
import torch

from cal_tpu_torch.data.feature_expansion import FeatureExpander
from cal_tpu_torch.data.loader import Loader, compute_budgets, compute_packed_budgets
from cal_tpu_torch.data.reddit_synthetic import make_graph
from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
from cal_tpu_torch.graph import HostGraph, sparse_batch
from cal_tpu_torch.ops.spmm import (
    gcn_aggregate_sparse_sigmoid,
    gcn_aggregate_sparse_sigmoid_plain,
)
from cal_tpu_torch.train.causal import resolve_device
from cal_tpu_torch.train.optim import cosine_lr
from cal_tpu_torch.train.steps import init_state, make_causal_train_epoch, ship, stack_batches_host
from cal_tpu_torch.utils.config import Config
from cal_tpu_torch.utils.profiling import spmm_roofline

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BASELINE_PATH = os.path.join(_ROOT, "benchmarks", "baseline_perf.json")
WARMUP_STEPS = 40
SPMM_ITERS = 50


def _train_workload(data_num: int = 64):
    """Config 1-2's batches: the train split of ``data_num`` x 4 x 2
    synthetic graphs at bias 0.9, shuffled once, full batches only; and the
    mean real (directed) edges per batch, the throughput's numerator."""
    cfg = Config(model="CausalGCN", bias=0.9, lr=0.002, min_lr=5e-6, dtype="bfloat16")
    dataset = generate_synthetic_dataset(
        data_num=data_num, node_num=cfg.node_num, max_degree=cfg.max_degree,
        noise=cfg.noise, seed=cfg.seed)
    train_set, _, _, _ = dataset_bias_split(dataset, bias=cfg.bias, total=data_num * 4,
                                            seed=cfg.seed)
    budgets = compute_budgets(train_set, cfg.batch_size, cfg.layout)
    loader = Loader(train_set, cfg.batch_size, shuffle=True, layout=cfg.layout,
                    budgets=budgets, seed=cfg.seed, drop_remainder=True)
    batches = list(loader.host_batches())
    edges = [int((b.edge_flat < b.x.shape[0] * b.x.shape[1] ** 2).sum()) for b in batches]
    return cfg, batches, float(np.mean(edges))


def _no_sync(device: torch.device):
    """Raise on any synchronizing CUDA call inside the block (the timed
    window must not wait for the card)."""
    if device.type != "cuda":
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def guard():
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    return guard()


def bench_causal_train(model_name: str, cfg: Config, batches, edges_per_batch: float,
                       target_steps: int = 400) -> dict:
    """Training of ``model_name`` on ``batches`` (host batches, staged on
    ``cfg.device`` once and taken in order, epoch after epoch) from a fresh
    model: at least WARMUP_STEPS steps of warm-up, then calls until
    ``target_steps`` steps have run in the timed window, through the
    device-side epoch, ``epochs_per_call`` epochs a call.  Returns edges/s,
    the steps and seconds of the window, the window's mean loss, and the
    steps and epochs of a call."""
    cfg = cfg.replace(model=model_name)
    device = resolve_device(cfg.device)
    state = init_state(cfg, batches[0].x.shape[-1], cfg.num_classes, device)
    schedule = cosine_lr(cfg.lr, cfg.min_lr, cfg.epochs, len(batches))
    epoch_fn = make_causal_train_epoch(state, schedule, cfg.c, cfg.o, cfg.co, True, cfg.seed)
    stacked = ship(stack_batches_host(batches), device)
    epochs_per_call = max(1, 30 // len(batches))
    steps_per_call = epochs_per_call * len(batches)

    def call(sums):
        for _ in range(epochs_per_call):
            m = epoch_fn(stacked)
            sums = m if sums is None else sums + m
        return sums

    n, sums = 0, None
    while n < max(WARMUP_STEPS, 2 * steps_per_call):
        sums = call(sums)
        n += steps_per_call
    float(sums[0])
    n_steps, sums = 0, None
    t0 = time.perf_counter()
    with _no_sync(device):
        while n_steps < target_steps:
            sums = call(sums)
            n_steps += steps_per_call
    loss = float(sums[0] / sums[5])
    dt = time.perf_counter() - t0
    return {"edges_per_s": n_steps / dt * edges_per_batch, "steps": n_steps,
            "seconds": dt, "loss": loss, "steps_per_call": steps_per_call,
            "epochs_per_call": epochs_per_call}


def _sparse_pack_workload(n_graphs: int = 256) -> list[HostGraph]:
    """REDDIT-shaped threads (heavy-tailed sizes, no node labels; the
    generator of benchmarks/gen_reddit_synthetic.py) with the deg + odeg10
    feature expansion of the REDDIT protocol, as the root bench builds
    them."""
    fx = FeatureExpander(degree=True, onehot_maxdeg=10)
    rng = np.random.default_rng(0)
    graphs = []
    for g in range(n_graphs):
        n, edges = make_graph(rng, g % 2)
        e = np.asarray(edges, np.int64).T
        e = np.concatenate([e, e[::-1]], axis=1)
        x, e, _ = fx(None, e, n)
        graphs.append(HostGraph(x=np.asarray(x, np.float32),
                                senders=np.asarray(e[0], np.int32),
                                receivers=np.asarray(e[1], np.int32), y=g % 2))
    return graphs


def bench_sparse_pack(cfg: Config, n_graphs: int = 256, target_steps: int = 60) -> dict:
    """CausalGCN on the sparse layout over ``n_graphs`` REDDIT-shaped
    threads in their identity order: budget-packed batches against the
    worst-case budgets (the sum of the ``batch_size`` largest graphs).
    Returns the packed run's edges/s, the speedup over the worst-case run,
    and both runs' graphs/s and batch counts."""
    graphs = _sparse_pack_workload(n_graphs)
    cfg = cfg.replace(layout="sparse")
    results = {}
    for tag, budgets in (("packed", compute_packed_budgets(graphs, cfg.batch_size)),
                         ("worst", compute_budgets(graphs, cfg.batch_size, "sparse"))):
        loader = Loader(graphs, cfg.batch_size, shuffle=False, layout="sparse",
                        budgets=budgets, seed=0)
        batches = list(loader.host_batches())
        live = float(sum(int(b.edge_mask.sum()) for b in batches))
        r = bench_causal_train("CausalGCN", cfg, batches, live / len(batches), target_steps)
        r["graphs_per_s"] = r["steps"] / len(batches) * n_graphs / r["seconds"]
        r["batches"] = len(batches)
        r["budgets"] = {k: budgets[k] for k in ("node_budget", "edge_budget")}
        results[tag] = r
    out = dict(results["packed"])
    out["speedup_vs_worst_case_padding"] = (
        results["packed"]["edges_per_s"] / results["worst"]["edges_per_s"])
    out["worst"] = results["worst"]
    return out


def spmm_workload(v: int, e: int, h: int, device, dtype: torch.dtype):
    """Config 4's seeded graph on ``device``: ``e`` edges with random
    senders and sorted random receivers over ``v`` nodes, the last 10% dead
    (the root bench's), with x [v, h] in ``dtype`` and the logits src, dst
    [v] in f32.  Returns (graph, x, src, dst)."""
    rng = np.random.default_rng(0)
    senders = rng.integers(0, v, size=e)
    receivers = np.sort(rng.integers(0, v, size=e))
    edge_mask = np.arange(e) < int(e * 0.9)
    x = torch.tensor(rng.standard_normal((v, h)).astype(np.float32)).to(device, dtype)
    src, dst = (torch.tensor(rng.standard_normal(v).astype(np.float32)).to(device)
                for _ in range(2))
    g = sparse_batch(np.zeros((v, 1), np.float32), senders, receivers, edge_mask,
                     np.ones(v, bool), np.zeros(v, np.int32), np.zeros(1, np.int32),
                     np.ones(1, bool)).to(device)
    return g, x, src, dst


def bench_spmm_tiled(v: int = 8192, e: int = 131072, h: int = 128, iters: int = SPMM_ITERS,
                     device: str = "cuda", dtype: torch.dtype = torch.bfloat16) -> dict:
    """Forward plus backward of the single sigmoid-weighted aggregate (the
    causal masked conv, w = sigmoid(src[s] + dst[r])) through K13-K16,
    against its plain twin, on a seeded graph: random senders, sorted
    receivers, the last 10% of the edges dead.  Each of ``iters`` chained
    iterations differentiates sum(out^2) in x, src and dst and feeds x + 1e-9
    dx (+ 1e-12 of the logit gradients' sums) to the next; one warm-up
    chain, then a timed one, wall clock with one read at its end.  Each
    kernel runs 2 * ``iters`` times (``kernel_iterations``)."""
    dev = resolve_device(device)
    g, x, src, dst = spmm_workload(v, e, h, dev, dtype)
    live_edges = float(g.edge_mask.sum())
    src, dst = src.requires_grad_(), dst.requires_grad_()

    def chain(fn, c):
        for _ in range(iters):
            xv = c.detach().requires_grad_()
            out = fn(xv, src, dst, g)
            dx, dsrc, ddst = torch.autograd.grad((out.float() ** 2).sum(), (xv, src, dst))
            c = c + 1e-9 * dx + 1e-12 * (dsrc.sum() + ddst.sum())
        return c

    def timeit(fn, guard):
        float(chain(fn, x)[0, 0])
        t0 = time.perf_counter()
        with guard:
            c = chain(fn, x)
        float(c[0, 0])
        return (time.perf_counter() - t0) / iters

    # the kernels' chain is held to no synchronization; the twin is timed as
    # PyTorch runs it
    dt = timeit(gcn_aggregate_sparse_sigmoid, _no_sync(dev))
    dt_plain = timeit(gcn_aggregate_sparse_sigmoid_plain, contextlib.nullcontext())
    passes = 3.0
    rl = spmm_roofline(live_edges * passes, h, dt)
    return {"edges_per_s": rl["edges_per_s"] / passes, "speedup_vs_plain": dt_plain / dt,
            "pct_hbm_roofline": round(rl["pct_hbm_floor"], 1), "ms": dt * 1e3,
            "plain_ms": dt_plain * 1e3, "kernel_iterations": 2 * iters}


def _card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "# device: cpu (the kernels' plain twins)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    return f"# device: {smi[torch.cuda.current_device()]}"


def _baseline(key: str) -> float | None:
    if not os.path.exists(_BASELINE_PATH):
        return None
    with open(_BASELINE_PATH) as f:
        return json.load(f).get(key)


def main(argv: list[str] | None = None) -> tuple[list[dict], dict]:
    """Prints the card line and the four JSON lines; returns the lines and
    each config's full result by metric name."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=float, default=1.0,
                   help="fraction of each timed window's steps and config 4's iterations")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    steps = lambda n: max(1, round(n * args.scale))
    print(_card_line(device), flush=True)

    cfg, batches, edges_per_batch = _train_workload()
    cfg = cfg.replace(device=args.device)
    lines, results = [], {}
    for metric, model, target, key in (
            ("causal_train_edges_per_s", "CausalGCN", 400, "train_edges_per_s"),
            ("causal_gat_train_edges_per_s", "CausalGAT", 200, "gat_train_edges_per_s")):
        r = results[metric] = bench_causal_train(model, cfg, batches, edges_per_batch,
                                                 steps(target))
        base = _baseline(key)
        lines.append({"metric": metric, "value": round(r["edges_per_s"], 1), "unit": "edges/s",
                      "vs_baseline": round(r["edges_per_s"] / base, 2) if base else 1.0,
                      "steps_per_call": r["steps_per_call"]})

    r = results["sparse_pack_train_edges_per_s"] = bench_sparse_pack(
        cfg, target_steps=steps(60))
    lines.append({"metric": "sparse_pack_train_edges_per_s", "value": round(r["edges_per_s"], 1),
                  "unit": "edges/s",
                  "vs_baseline": round(r["speedup_vs_worst_case_padding"], 2),
                  "steps_per_call": r["steps_per_call"]})

    r = results["spmm_tiled_edges_per_s"] = bench_spmm_tiled(iters=steps(SPMM_ITERS),
                                                             device=args.device)
    lines.append({"metric": "spmm_tiled_edges_per_s", "value": round(r["edges_per_s"], 1),
                  "unit": "edges/s", "vs_baseline": round(r["speedup_vs_plain"], 2),
                  "pct_hbm_roofline": r["pct_hbm_roofline"]})
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines, results


if __name__ == "__main__":
    main()
