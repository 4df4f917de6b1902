"""Static-shape batching for the dense and sparse layouts.

Counterpart of cal_tpu/data/loader.py (``compute_budgets``,
``compute_packed_budgets`` and ``Loader``, dense and sparse layouts and the
sparse layout's budget-packed mode).  The budget rules are the same, so both
packages batch to the same shapes: dense, the node budget N is the largest
graph rounded up to 8, or to 128 when that pads by at most 15%; sparse, V
and E cover the ``batch_size`` largest graphs (``pad_sizes_for``); packed,
V and E sit at 1.25x the mean batch.  Every epoch yields ceil(len /
batch_size) batches (floor with ``drop_remainder``); the last one is padded
and masked.  A packed epoch closes a batch early when the next graph would
overflow a budget, and pads the epoch with empty batches to a fixed step
count.

Batches are collated by the native C++ packer (``cal_tpu_torch/native``,
cal_tpu's ``PackedDataset``), built with g++ at first use; the NumPy packers
(``graph.pack_dense`` and ``_SparseDataset``) are its plain twins, which a
loader takes only when asked (``packer="numpy"``).  Both work on
whole-dataset concatenated arrays: each graph's edges are sorted by (receiver, sender)
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
from cal_tpu_torch.native import PackedDataset


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def compute_packed_budgets(graphs: Sequence[HostGraph], batch_size: int) -> dict:
    """Budgets of budget-packed sparse batching (heavy-tailed datasets): V and
    E at 1.25 times the mean batch (V at least the largest graph + 1,
    E at least the largest graph's edges), rounded up to 128, so
    ``batch_size`` becomes an upper bound on the graphs of a batch."""
    headroom = 1.25
    ns = np.array([g.num_nodes for g in graphs], np.int64)
    es = np.array([g.num_edges for g in graphs], np.int64)
    node_budget = int(max(headroom * batch_size * ns.mean(), ns.max() + 1))
    edge_budget = int(max(headroom * batch_size * es.mean(), es.max(), 1))
    return {"node_budget": _round_up(node_budget, 128),
            "edge_budget": _round_up(edge_budget, 128),
            "pack": True, "max_graph_nodes": int(ns.max())}


def compute_budgets(graphs: Sequence[HostGraph], batch_size: int,
                    layout: str = "dense", pack: bool = False) -> dict:
    """Static budgets covering any batch drawn from ``graphs`` (``pack``:
    the budget-packed ones, sparse layout only)."""
    if pack:
        if layout != "sparse":
            raise ValueError("budget-packed batching is sparse-layout only")
        return compute_packed_budgets(graphs, batch_size)
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


def batch_nodes(graphs: Sequence[HostGraph], batch_size: int) -> tuple[float, float]:
    """Nodes of the worst-case batch (the ``batch_size`` largest graphs) and
    of a mean batch."""
    ns = np.array([g.num_nodes for g in graphs], np.float64)
    k = min(batch_size, len(ns))
    return float(np.sort(ns)[-k:].sum()), float(ns.mean() * k)


def pack_ratio(graphs: Sequence[HostGraph], batch_size: int) -> float:
    """Nodes of the worst-case batch over those of a mean batch."""
    worst, mean_batch = batch_nodes(graphs, batch_size)
    return worst / mean_batch


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
        # each graph's first node and edge in the batch (any count, 0 included)
        b_noff = np.cumsum(ns) - ns
        b_eoff = np.cumsum(es) - es
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
    layout; budgets with ``"pack": True`` switch the sparse layout to
    budget-packed batches).

    Pack mode fixes the epoch at ``len(self)`` steps: the most batches that
    the identity order and 16 simulated shuffles (drawn from ``seed ^
    0x5EED``) pack into, plus one.  Each epoch draws permutations from the
    loader's stream until one packs within that count (at most 32 draws)
    and pads the epoch with empty chunks.  ``schedule_steps`` is the mean
    count of the simulations: the optimizer steps an epoch takes, pad
    batches excluded.  cal_tpu's loader also redraws an epoch whose chunks
    overflow its tile budget (a TPU tile-plan size); the port has no tile
    plans, so its shuffle stream equals cal_tpu's wherever cal_tpu's plans
    are off or never force a redraw."""

    def __init__(self, graphs: Sequence[HostGraph], batch_size: int,
                 shuffle: bool = False, budgets: dict | None = None,
                 seed: int = 0, layout: str = "dense", drop_remainder: bool = False,
                 packer: str = "native"):
        if layout not in ("dense", "sparse"):
            raise ValueError(f"unknown layout {layout!r}")
        if packer not in ("native", "numpy"):
            raise ValueError(f"unknown packer {packer!r}")
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.layout = layout
        self.budgets = dict(budgets or compute_budgets(self.graphs, batch_size, layout))
        self.rng = np.random.default_rng(seed)
        self.drop_remainder = drop_remainder
        self.pack = bool(self.budgets.get("pack", False))
        if self.pack:
            if layout != "sparse":
                raise ValueError("pack budgets require layout='sparse'")
            if drop_remainder:
                raise ValueError("pack mode keeps every graph per epoch")
            self._sizes_n = np.array([g.num_nodes for g in self.graphs], np.int64)
            self._sizes_e = np.array([g.num_edges for g in self.graphs], np.int64)
            sim = np.random.default_rng(seed ^ 0x5EED)
            counts = [len(self._pack_chunks(np.arange(len(self.graphs))))]
            counts += [len(self._pack_chunks(sim.permutation(len(self.graphs))))
                       for _ in range(16)]
            # an empty split yields no batch, not even padding
            self._steps_budget = max(counts) + 1 if self.graphs else 0
            self._sched_steps = max(int(round(float(np.mean(counts)))), 1)
        # an empty split yields no batch and needs no packer
        self.packer = packer
        self._packed = None
        if self.graphs and packer == "native":
            self._packed = PackedDataset(self.graphs)
        self._sparse = (_SparseDataset(self.graphs)
                        if layout == "sparse" and self.graphs and packer == "numpy" else None)

    def __len__(self) -> int:
        if self.pack:
            return self._steps_budget
        n = len(self.graphs)
        return n // self.batch_size if self.drop_remainder else math.ceil(n / self.batch_size)

    @property
    def schedule_steps(self) -> int:
        """Optimizer steps per epoch (pack mode: without the pad batches)."""
        return self._sched_steps if self.pack else len(self)

    def _pack_chunks(self, order: np.ndarray) -> list:
        """Greedy budget packing: close a batch when the next graph would
        overflow the node or edge budget or the graph-count cap."""
        nb, eb = self.budgets["node_budget"], self.budgets["edge_budget"]
        bs = self.batch_size
        chunks, cur, cn, ce = [], [], 0, 0
        for j in order:
            n, e = int(self._sizes_n[j]), int(self._sizes_e[j])
            if cur and (cn + n > nb or ce + e > eb or len(cur) == bs):
                chunks.append(np.asarray(cur))
                cur, cn, ce = [], 0, 0
            cur.append(int(j))
            cn += n
            ce += e
        if cur:
            chunks.append(np.asarray(cur))
        return chunks

    def _make_batch_host(self, idx: np.ndarray):
        b = self.budgets
        if self.layout == "sparse":
            pack = (self._packed.pack_sparse_batch if self._packed is not None
                    else self._sparse.pack)
            return pack(idx, self.batch_size, b["node_budget"], b["edge_budget"])
        if self._packed is not None:
            p = self._packed.pack_dense_batch(idx, self.batch_size, b["node_budget"],
                                              b["edge_budget"])
        else:
            p = pack_dense([self.graphs[j] for j in idx], self.batch_size,
                           b["node_budget"], b["edge_budget"])
        return dataclasses.replace(p, eg_budget=b["edge_per_graph"])

    def host_batches(self) -> Iterator[PackedDenseBatch | GraphBatch]:
        """One epoch of NumPy-leaf batches (same shuffle stream as the JAX
        loader for the same seed; pack mode ends with its empty batches)."""
        for idx in self._chunks():
            yield self._make_batch_host(idx)

    def _chunks(self):
        order = np.arange(len(self.graphs))
        if self.pack and self.graphs:
            for _ in range(32):
                if self.shuffle:
                    order = self.rng.permutation(len(self.graphs))
                chunks = self._pack_chunks(order)
                if len(chunks) <= self._steps_budget:
                    break
                if not self.shuffle:   # the identity order is one of the simulations
                    raise AssertionError("unreachable: the identity order packed longer")
            else:
                raise RuntimeError(
                    "budget packing exceeded the step budget 32 shuffles in a row: "
                    "budgets too tight for this dataset")
            return chunks + [np.empty((0,), np.int64)] * (self._steps_budget - len(chunks))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        return [order[i * bs:(i + 1) * bs] for i in range(len(self))]
