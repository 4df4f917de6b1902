"""Static-shape batching for the dense layout.

Counterpart of cal_tpu/data/loader.py (``compute_budgets`` and ``Loader``,
dense layout, NumPy packer).  The node budget rule is the same, so both
packages batch to the same N: the largest graph rounded up to 8, or to 128
when that pads by at most 15%.  Every epoch yields ceil(len / batch_size)
batches; the last one is padded and masked.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Sequence

import numpy as np

from cal_tpu_torch.graph import HostGraph, PackedDenseBatch, pack_dense


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def compute_budgets(graphs: Sequence[HostGraph], batch_size: int) -> dict:
    """Static dense budgets covering any batch drawn from ``graphs``."""
    node_budget = _round_up(max(g.num_nodes for g in graphs), 8)
    aligned = _round_up(node_budget, 128)
    if aligned <= 1.15 * node_budget:
        node_budget = aligned
    e_sorted = sorted((g.num_edges for g in graphs), reverse=True)
    edge_budget = _round_up(max(sum(e_sorted[:batch_size]), 1), 128)
    return {"node_budget": node_budget, "edge_budget": edge_budget,
            "edge_per_graph": max(e_sorted[0], 1)}


class Loader:
    """Shuffling, padding, static-shape batch iterator (dense layout)."""

    def __init__(self, graphs: Sequence[HostGraph], batch_size: int,
                 shuffle: bool = False, budgets: dict | None = None,
                 seed: int = 0):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.budgets = dict(budgets or compute_budgets(self.graphs, batch_size))
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return math.ceil(len(self.graphs) / self.batch_size)

    def _make_batch_host(self, idx: np.ndarray) -> PackedDenseBatch:
        b = self.budgets
        p = pack_dense([self.graphs[j] for j in idx], self.batch_size,
                       b["node_budget"], b["edge_budget"])
        return dataclasses.replace(p, eg_budget=b["edge_per_graph"])

    def host_batches(self) -> Iterator[PackedDenseBatch]:
        """One epoch of NumPy-leaf batches (same shuffle stream as the JAX
        loader for the same seed)."""
        for idx in self._chunks():
            yield self._make_batch_host(idx)

    def _chunks(self):
        order = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        return [order[i * bs:(i + 1) * bs] for i in range(len(self))]
