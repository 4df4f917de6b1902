"""CUDA-graph capture of a step: the port's counterpart of jit-compiling the
JAX package's scanned epoch (cal_tpu/train/steps.py make_causal_train_epoch).

``GraphedCall`` runs a function that reads and writes only tensors fixed for
the run (static input buffers the caller fills, the model's parameters and
buffers, the optimizer's state, a static sums buffer): its first call runs
the function eagerly on a side stream (the warm-up: the kernels' libraries
load, Adam's state and the cuBLAS workspace of that stream are made), its
second call captures the function into one CUDA graph on that stream and
replays it, and every later call replays it.  A replay relaunches every
kernel of the function with one host call.

The kernels' ``.launches`` counters are Python side effects: a capture
would count a recording, and a replay nothing.  So a capture puts the
counters back as they were and keeps what it would have added; each replay
adds that, and the counters read as the eager calls would have left them.

Generators the function draws from are registered with the graph: the
caller seeds them (``manual_seed``) before each call, and a replay draws
what an eager call from that seed draws.
"""
from __future__ import annotations

import torch


def launch_counters() -> list:
    """Every launch-counted kernel wrapper of the port (callables with a
    ``.launches`` int)."""
    from cal_tpu_torch.ops import (
        adj_build, coo_spmm, edge_gat, flash_gat, fused_gcn, gat_sparse, pool, spmm)

    out = []
    for mod in (adj_build, fused_gcn, flash_gat, edge_gat, spmm, pool, gat_sparse, coo_spmm):
        out += [f for f in vars(mod).values()
                if callable(f) and isinstance(getattr(f, "launches", None), int)
                and getattr(f, "__module__", None) == mod.__name__]
    return out


class GraphedCall:
    """``fn()`` eagerly at the first call, then one CUDA graph of it.

    ``fn`` takes no argument and returns a tensor (or None); the tensor a
    replay returns is the graph's static output, overwritten by the next
    replay.  ``generators``: the CUDA generators ``fn`` draws from.
    ``replays`` counts the replays."""

    def __init__(self, fn, device: torch.device, generators=()):
        self.fn = fn
        self.device = device
        self.generators = list(generators)
        self.stream = torch.cuda.Stream(device)
        self.graph = None
        self.out = None
        self.calls = 0
        self.replays = 0
        self.captured_launches: dict = {}

    def _on_side_stream(self, fn):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def _capture(self) -> None:
        counters = launch_counters()
        before = {f: f.launches for f in counters}
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # thread_local: the epoch prefetcher's threads copy to the card meanwhile
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
            self.out = self.fn()
        self.captured_launches = {f: f.launches - n for f, n in before.items()
                                  if f.launches != n}
        for f, n in before.items():
            f.launches = n
        self.graph = graph

    def replay(self):
        self.graph.replay()
        for f, n in self.captured_launches.items():
            f.launches += n
        self.replays += 1
        return self.out

    def __call__(self):
        self.calls += 1
        if self.calls == 1:
            return self._on_side_stream(self.fn)
        if self.graph is None:
            self._capture()
        return self.replay()
