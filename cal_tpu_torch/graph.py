"""Graph containers of the dense layout: host graphs, packed and dense batches.

Counterpart of cal_tpu/graph.py (HostGraph, PackedDenseBatch,
DenseGraphBatch, pack_dense, to_dense).  The host ships each batch in packed
form: node features, ONE sorted flat index ``(g*N + receiver)*N + sender``
per directed edge (padding holds ``B*N*N`` and is dropped), the node count
of each graph slot and the labels.  ``to_dense`` rebuilds the [B, N, N]
count adjacency on the device with the ``adj_build`` kernel and derives the
masks: ``node_mask`` from ``n_nodes`` and ``graph_mask = n_nodes > 0`` (real
graphs form a contiguous prefix of the slots).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from cal_tpu_torch.ops.adj_build import adj_build


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """A single un-batched graph on the host (NumPy)."""

    x: np.ndarray          # [n, feat] float32
    senders: np.ndarray    # [e] int (undirected graphs store both directions)
    receivers: np.ndarray  # [e] int
    y: int

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


@dataclasses.dataclass(frozen=True)
class PackedDenseBatch:
    """Compact host->device form of a dense batch (NumPy or torch leaves).

    x [B, N, F]; edge_flat [E] int32 (int64 when B*N*N >= 2^31), sorted;
    n_nodes [B] int32 (0 for padded slots); y [B] int32; eg_budget: the
    largest edge count of one graph (kept for the dense GAT slice)."""

    x: object
    edge_flat: object
    n_nodes: object
    y: object
    eg_budget: int = 0

    def to(self, device) -> "PackedDenseBatch":
        t = lambda a: torch.as_tensor(a).to(device)
        return PackedDenseBatch(t(self.x), t(self.edge_flat), t(self.n_nodes),
                                t(self.y), self.eg_budget)


@dataclasses.dataclass(frozen=True)
class DenseGraphBatch:
    """x [B, N, F]; adj [B, N, N] with adj[b, r, s] = multiplicity of edge
    s -> r (row = receiver, no self loops added); node_mask [B, N] bool;
    y [B]; graph_mask [B] bool."""

    x: torch.Tensor
    adj: torch.Tensor
    node_mask: torch.Tensor
    y: torch.Tensor
    graph_mask: torch.Tensor


def pack_dense(graphs: Sequence[HostGraph], num_graphs: int, node_budget: int,
               edge_budget: int) -> PackedDenseBatch:
    """Collate host graphs into a PackedDenseBatch with NumPy leaves."""
    if len(graphs) > num_graphs:
        raise ValueError(f"{len(graphs)} graphs > budget {num_graphs}")
    tot_e = sum(gr.num_edges for gr in graphs)
    if tot_e > edge_budget:
        raise ValueError(f"{tot_e} edges > budget {edge_budget}")
    feat = graphs[0].x.shape[1]
    nb = node_budget
    x = np.zeros((num_graphs, nb, feat), np.float32)
    edge_flat = np.full((edge_budget,), num_graphs * nb * nb, np.int64)
    n_nodes = np.zeros((num_graphs,), np.int32)
    y = np.zeros((num_graphs,), np.int32)
    e_off = 0
    for i, gr in enumerate(graphs):
        n, e = gr.num_nodes, gr.num_edges
        if n > nb:
            raise ValueError(f"graph has {n} nodes > node budget {nb}")
        x[i, :n] = gr.x
        edge_flat[e_off:e_off + e] = (
            (i * nb + gr.receivers.astype(np.int64)) * nb + gr.senders)
        n_nodes[i] = n
        y[i] = gr.y
        e_off += e
    edge_flat[:e_off].sort(kind="stable")
    eg = max((gr.num_edges for gr in graphs), default=0)
    idx = np.int32 if num_graphs * nb * nb < 2**31 else np.int64
    return PackedDenseBatch(x, edge_flat.astype(idx), n_nodes, y, eg)


def to_dense(p: PackedDenseBatch, dtype: torch.dtype | None = None) -> DenseGraphBatch:
    """Materialize adjacency and masks on the batch's device."""
    dtype = dtype or p.x.dtype
    b, n, _ = p.x.shape
    adj = adj_build(p.edge_flat, b, n, dtype)
    node_mask = torch.arange(n, device=p.x.device)[None, :] < p.n_nodes[:, None]
    return DenseGraphBatch(x=p.x.to(dtype), adj=adj, node_mask=node_mask,
                           y=p.y, graph_mask=p.n_nodes > 0)
