"""Static-shape batching for the dense and sparse layouts.

Counterpart of cal_tpu/data/loader.py (``compute_budgets`` and ``Loader``,
dense and sparse layouts without budget packing).  The budget rules are the
same, so both packages batch to the same shapes: dense, the node budget N is
the largest graph rounded up to 8, or to 128 when that pads by at most 15%;
sparse, V and E cover the ``batch_size`` largest graphs (``pad_sizes_for``).
Every epoch yields ceil(len / batch_size) batches; the last one is padded
and masked.

The sparse packer works on whole-dataset concatenated arrays, as cal_tpu's
native packer does: each graph's edges are sorted by (receiver, sender)
once, so the concatenation of a batch's graphs with increasing node offsets
is already receiver-sorted (padded edges sit at node V-1, the largest id),
and each graph's stable sender order is precomputed too, so the sender CSR
needs no per-batch sort either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Sequence

import numpy as np

from cal_tpu_torch.graph import (
    GraphBatch,
    HostGraph,
    PackedDenseBatch,
    pack_dense,
    pad_sizes_for,
    sparse_batch,
)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def compute_budgets(graphs: Sequence[HostGraph], batch_size: int,
                    layout: str = "dense") -> dict:
    """Static budgets covering any batch drawn from ``graphs``."""
    if layout == "sparse":
        pad_n, pad_e = pad_sizes_for(graphs, batch_size)
        return {"node_budget": pad_n, "edge_budget": pad_e,
                "max_graph_nodes": max(g.num_nodes for g in graphs)}
    if layout != "dense":
        raise ValueError(f"unknown layout {layout!r}")
    node_budget = _round_up(max(g.num_nodes for g in graphs), 8)
    aligned = _round_up(node_budget, 128)
    if aligned <= 1.15 * node_budget:
        node_budget = aligned
    e_sorted = sorted((g.num_edges for g in graphs), reverse=True)
    edge_budget = _round_up(max(sum(e_sorted[:batch_size]), 1), 128)
    return {"node_budget": node_budget, "edge_budget": edge_budget,
            "edge_per_graph": max(e_sorted[0], 1)}


def pack_ratio(graphs: Sequence[HostGraph], batch_size: int) -> float:
    """Nodes of the worst-case batch (the ``batch_size`` largest graphs) over
    those of a mean batch."""
    ns = np.array([g.num_nodes for g in graphs], np.float64)
    k = min(batch_size, len(ns))
    return float(np.sort(ns)[-k:].sum() / (ns.mean() * k))


def want_pack(layout: str, pack_batches: str, graphs: Sequence[HostGraph],
              batch_size: int) -> bool:
    """cal_tpu's ``_want_pack`` (train/causal.py): budget-packed sparse
    batching when asked for, or in "auto" when the worst-case batch holds
    over 1.5x the nodes of a mean one (``pack_ratio``)."""
    if layout != "sparse" or pack_batches == "false":
        return False
    if pack_batches == "true":
        return True
    return pack_ratio(graphs, batch_size) > 1.5


class _SparseDataset:
    """Whole-dataset concatenated arrays of the sparse packer: node features,
    edges sorted by (receiver, sender) within each graph (local ids), and
    each graph's stable sender order as global edge ids."""

    def __init__(self, graphs: Sequence[HostGraph]):
        ns = np.array([g.num_nodes for g in graphs], np.int64)
        es = np.array([g.num_edges for g in graphs], np.int64)
        self.node_off = np.concatenate([[0], np.cumsum(ns)])
        self.edge_off = np.concatenate([[0], np.cumsum(es)])
        self.x = np.concatenate([g.x for g in graphs]).astype(np.float32)
        self.y = np.array([g.y for g in graphs], np.int32)
        gid = np.repeat(np.arange(len(graphs)), es)
        send = np.concatenate([g.senders for g in graphs]).astype(np.int64)
        recv = np.concatenate([g.receivers for g in graphs]).astype(np.int64)
        order = np.lexsort((send, recv, gid))
        self.send, self.recv = send[order], recv[order]
        self.send_order = np.lexsort((self.send, gid))   # stable: ties keep receiver order

    def pack(self, idx: np.ndarray, num_graphs: int, num_nodes: int,
             num_edges: int) -> GraphBatch:
        idx = np.asarray(idx, np.int64)
        ns = self.node_off[idx + 1] - self.node_off[idx]
        es = self.edge_off[idx + 1] - self.edge_off[idx]
        tot_n, tot_e = int(ns.sum()), int(es.sum())
        if len(idx) > num_graphs or tot_n > num_nodes or tot_e > num_edges:
            raise ValueError(f"batch needs ({len(idx)} graphs, {tot_n} nodes, {tot_e} edges)"
                             f" > budget ({num_graphs}, {num_nodes}, {num_edges})")
        b_noff = np.concatenate([[0], np.cumsum(ns)[:-1]])
        b_eoff = np.concatenate([[0], np.cumsum(es)[:-1]])
        # global node / edge ids of the batch, in batch order
        nodes = np.repeat(self.node_off[idx] - b_noff, ns) + np.arange(tot_n)
        shift_e = np.repeat(self.edge_off[idx] - b_eoff, es)
        edges = shift_e + np.arange(tot_e)
        node_shift = np.repeat(b_noff, es)
        x = np.zeros((num_nodes, self.x.shape[1]), np.float32)
        x[:tot_n] = self.x[nodes]
        senders = np.full(num_edges, num_nodes - 1, np.int32)
        receivers = np.full(num_edges, num_nodes - 1, np.int32)
        senders[:tot_e] = self.send[edges] + node_shift
        receivers[:tot_e] = self.recv[edges] + node_shift
        send_perm = np.arange(num_edges, dtype=np.int64)
        send_perm[:tot_e] = self.send_order[edges] - shift_e
        node_graph = np.full(num_nodes, num_graphs, np.int32)
        node_graph[:tot_n] = np.repeat(np.arange(len(idx), dtype=np.int32), ns)
        y = np.zeros(num_graphs, np.int32)
        y[:len(idx)] = self.y[idx]
        return sparse_batch(x, senders, receivers, np.arange(num_edges) < tot_e,
                            np.arange(num_nodes) < tot_n, node_graph, y,
                            np.arange(num_graphs) < len(idx), send_perm=send_perm)


class Loader:
    """Shuffling, padding, static-shape batch iterator (dense or sparse
    layout; the sparse budget-packed mode is not ported)."""

    def __init__(self, graphs: Sequence[HostGraph], batch_size: int,
                 shuffle: bool = False, budgets: dict | None = None,
                 seed: int = 0, layout: str = "dense"):
        if layout not in ("dense", "sparse"):
            raise ValueError(f"unknown layout {layout!r}")
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.layout = layout
        self.budgets = dict(budgets or compute_budgets(self.graphs, batch_size, layout))
        self.rng = np.random.default_rng(seed)
        # an empty split yields no batch and needs no packer
        self._sparse = (_SparseDataset(self.graphs) if layout == "sparse" and self.graphs
                        else None)

    def __len__(self) -> int:
        return math.ceil(len(self.graphs) / self.batch_size)

    def _make_batch_host(self, idx: np.ndarray):
        b = self.budgets
        if self.layout == "sparse":
            return self._sparse.pack(idx, self.batch_size, b["node_budget"],
                                     b["edge_budget"])
        p = pack_dense([self.graphs[j] for j in idx], self.batch_size,
                       b["node_budget"], b["edge_budget"])
        return dataclasses.replace(p, eg_budget=b["edge_per_graph"])

    def host_batches(self) -> Iterator[PackedDenseBatch | GraphBatch]:
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
