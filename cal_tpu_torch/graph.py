"""Graph containers: host graphs, the dense layout's packed and dense
batches, and the sparse layout's padded edge-list batch.

Counterpart of cal_tpu/graph.py (HostGraph, PackedDenseBatch,
DenseGraphBatch, pack_dense, to_dense, GraphBatch, pad_sizes_for,
batch_graphs).

Dense layout: the host ships each batch in packed form: node features, ONE
sorted flat index ``(g*N + receiver)*N + sender`` per directed edge (padding
holds ``B*N*N`` and is dropped), the node count of each graph slot and the
labels.  ``to_dense`` rebuilds the [B, N, N] count adjacency on the device
with the ``adj_build`` kernel and derives the masks: ``node_mask`` from
``n_nodes`` and ``graph_mask = n_nodes > 0`` (real graphs form a contiguous
prefix of the slots).

Sparse layout: a ``GraphBatch`` is the disjoint union of its graphs, padded
to V nodes and E edges (padded edges point at node V-1 with ``edge_mask``
False; padded nodes belong to the trash segment G).  Edges are sorted by
receiver.  In place of the TPU's block-COO tile plans the batch carries the
CSR form of both orientations (``EdgeCsr``), the structure the SpMM and
degree kernels walk: rows cut into up to ``MAX_CHUNKS`` chunks, so a hub
row (or the padded-edge run at node V-1) spreads over many warps and every
sum keeps a single owner.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from cal_tpu_torch.ops.adj_build import adj_build
from cal_tpu_torch.ops.edge_gat import EdgeIndex


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """A single un-batched graph on the host (NumPy)."""

    x: np.ndarray          # [n, feat] float32
    senders: np.ndarray    # [e] int (undirected graphs store both directions)
    receivers: np.ndarray  # [e] int
    y: int
    xg: np.ndarray | None = None   # [1, k*(1+feat)] group_degree super-nodes (TU data)

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

    def leaves(self) -> tuple:
        return self.x, self.edge_flat, self.n_nodes, self.y

    def with_leaves(self, leaves) -> "PackedDenseBatch":
        """The batch with ``leaves`` (in ``leaves()`` order) in place of its
        own, the same ``eg_budget``."""
        return PackedDenseBatch(*leaves, self.eg_budget)

    def to(self, device) -> "PackedDenseBatch":
        return self.with_leaves([_tensor(a, device) for a in self.leaves()])


@dataclasses.dataclass(frozen=True)
class DenseGraphBatch:
    """x [B, N, F]; adj [B, N, N] with adj[b, r, s] = multiplicity of edge
    s -> r (row = receiver, no self loops added); node_mask [B, N] bool;
    y [B]; graph_mask [B] bool.  ``edge_flat`` (the sorted int32 flat edge
    list of the packed batch, or None) and ``eg_budget`` (the largest edge
    count of one graph) feed the edge-formulated GAT kernel, and
    ``edge_index`` (``ops.edge_gat.EdgeIndex`` of ``edge_flat``, or None)
    its walk: built on the batch's device when a layer first needs it, then
    shared by every GAT layer's forward and backward of the batch."""

    x: torch.Tensor
    adj: torch.Tensor
    node_mask: torch.Tensor
    y: torch.Tensor
    graph_mask: torch.Tensor
    edge_flat: torch.Tensor | None = None
    eg_budget: int = 0
    edge_index: EdgeIndex | None = None


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
    """Materialize adjacency and masks on the batch's device.  The edge list
    is passed on, as cal_tpu's ``to_dense`` does, only when the batch has an
    edge budget and int32 indices (B*N*N < 2^31), with its (not yet built)
    EdgeIndex."""
    dtype = dtype or p.x.dtype
    b, n, _ = p.x.shape
    adj = adj_build(p.edge_flat, b, n, dtype)
    node_mask = torch.arange(n, device=p.x.device)[None, :] < p.n_nodes[:, None]
    carry = p.eg_budget > 0 and p.edge_flat.dtype == torch.int32
    return DenseGraphBatch(x=p.x.to(dtype), adj=adj, node_mask=node_mask,
                           y=p.y, graph_mask=p.n_nodes > 0,
                           edge_flat=p.edge_flat if carry else None, eg_budget=p.eg_budget,
                           edge_index=EdgeIndex(p.edge_flat, b, n) if carry else None)


# A CSR row is cut into groups of CHUNK_EDGES edges (one per warp lane) and
# the groups into at most MAX_CHUNKS chunks of equal group counts.
# csrc/csr_rows.cuh derives the same split from the row length with the same
# two constants.  A row of one chunk (at most CHUNK_EDGES edges) is light:
# the walks take it by row, several a warp, and take only the chunks of the
# other (heavy) rows from their list, a warp a chunk, whose last chunk to
# finish sums the row.
CHUNK_EDGES = 32
MAX_CHUNKS = 64


def _tensor(a, device):
    return torch.as_tensor(a).to(device)


def heavy_capacity(num_edges: int) -> int:
    """The length of a CSR's heavy list over ``num_edges`` edges, whatever
    the batch: a row of L > CHUNK_EDGES edges has at most ceil(L / 32) <
    L / 16 chunks, so the heavy chunks of any batch number at most E // 16
    (the bound of ``ops.edge_gat.EdgeIndex.cap_h``)."""
    return num_edges // 16 + 1


@dataclasses.dataclass(frozen=True)
class EdgeCsr:
    """One orientation of a batch's edges in CSR form (NumPy or torch leaves).

    ``perm`` [E] lists the edge ids in row order (None: the edges are
    already in row order); row v owns ``perm[ptr[v]:ptr[v+1]]``.  A row of
    ``len`` edges has ``groups = max(1, ceil(len / CHUNK_EDGES))`` groups,
    cut into ``ceil(groups / per)`` chunks of ``per = ceil(groups /
    MAX_CHUNKS)`` groups: ``chunk_ptr`` [V+1] gives each row's first chunk,
    ``chunk_row`` each chunk's row.  Every row has at least one chunk, so a
    kernel that writes per chunk writes every row exactly once.
    ``heavy_chunks`` lists, ascending, the chunks of the heavy rows (rows
    of more than one chunk): the light rows, one chunk each, and the listed
    chunks cover every row exactly once.  ``heavy_masked`` marks the listed
    chunks whose edges are all masked out (the padded run at node V-1),
    which no masked conv has to walk: it holds for the batch's edge_mask
    and for any mask that turns more edges off.  ``arrivals`` int32 zeros
    are the walk's per-chunk arrival counters on the device, 0 between
    launches (a launch sets back what it counted): the batch's launches on
    one stream share them.

    Every leaf has a length fixed by the budgets alone, so the batches of a
    run share one shape and a captured step (a CUDA graph over static
    buffers) takes any of them: ``heavy_chunks``, ``heavy_masked`` and
    ``arrivals`` hold ``heavy_capacity(E)`` entries, of which the first
    ``heavy_count`` [1] int32 are live (the kernels read that count on the
    device), and ``chunk_row`` holds ``V + heavy_capacity(E)`` entries, of
    which the first ``chunk_ptr[V]`` are live; the rest is padding (0,
    False) that nothing reads."""

    ptr: object
    chunk_ptr: object
    chunk_row: object
    heavy_chunks: object
    heavy_masked: object
    heavy_count: object
    arrivals: object
    perm: object = None

    @property
    def num_chunks(self) -> int:
        """The live chunks (a read from the device for torch leaves)."""
        return int(self.chunk_ptr[-1])

    @property
    def n_heavy(self) -> int:
        """The live heavy chunks (a read from the device for torch leaves)."""
        return int(self.heavy_count[0])

    def leaves(self) -> tuple:
        """The arrays, ``perm`` last where there is one."""
        own = (self.ptr, self.chunk_ptr, self.chunk_row, self.heavy_chunks,
               self.heavy_masked, self.heavy_count, self.arrivals)
        return own if self.perm is None else own + (self.perm,)

    def to(self, device) -> "EdgeCsr":
        return EdgeCsr(*(_tensor(a, device) for a in self.leaves()))


def edge_csr(rows: np.ndarray, num_nodes: int, perm: np.ndarray | None = None,
             edge_mask: np.ndarray | None = None) -> EdgeCsr:
    """CSR of edges whose row ids, taken in row order, are ``rows``
    (non-decreasing; ``rows = keys[perm]`` when ``perm`` is given), in the
    padded form of ``EdgeCsr``.  ``edge_mask`` (in edge order; None: every
    edge in) marks the heavy chunks that hold masked-out edges alone."""
    counts = np.bincount(rows, minlength=num_nodes)
    ptr = np.zeros(num_nodes + 1, np.int32)
    np.cumsum(counts, out=ptr[1:])
    groups = np.maximum(1, -(-counts // CHUNK_EDGES))
    per = -(-groups // MAX_CHUNKS)
    chunks = -(-groups // per)
    chunk_ptr = np.zeros(num_nodes + 1, np.int32)
    np.cumsum(chunks, out=chunk_ptr[1:])
    chunk_row = np.repeat(np.arange(num_nodes, dtype=np.int32), chunks)
    heavy = chunks > 1
    heavy_chunks = np.flatnonzero(heavy[chunk_row]).astype(np.int32)
    masked = np.zeros(heavy_chunks.size, bool)
    if edge_mask is not None and heavy_chunks.size:
        live = np.asarray(edge_mask, bool)
        live = live if perm is None else live[perm]
        cum = np.concatenate([[0], np.cumsum(live)])
        r = chunk_row[heavy_chunks]
        span = per[r] * CHUNK_EDGES
        beg = ptr[r] + (heavy_chunks - chunk_ptr[r]) * span
        masked = cum[np.minimum(beg + span, ptr[r + 1])] == cum[beg]
    cap = heavy_capacity(rows.size)
    if heavy_chunks.size > cap:
        raise RuntimeError(f"{heavy_chunks.size} heavy chunks over the capacity {cap}")
    pad = lambda a, n, dtype: np.concatenate([a, np.zeros(n - a.size, dtype)])
    return EdgeCsr(ptr, chunk_ptr, pad(chunk_row, num_nodes + cap, np.int32),
                   pad(heavy_chunks, cap, np.int32), pad(masked, cap, bool),
                   np.array([heavy_chunks.size], np.int32), np.zeros(cap, np.int32),
                   None if perm is None else perm.astype(np.int32))


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A padded disjoint-union batch (sparse layout), NumPy or torch leaves.

    x [V, F] f32; senders, receivers [E] int32 (receiver-sorted; padded
    edges at node V-1); edge_mask [E] bool; node_mask [V] bool; node_graph
    [V] int32 (non-decreasing; padded nodes in the trash segment G); y [G]
    int32; graph_mask [G] bool (a contiguous prefix of real graphs).
    ``recv``: receiver CSR (edges already in order); ``send``: sender CSR
    with the stable sender-sorted permutation.  ``recv`` and ``send`` are the
    counterpart of cal_tpu's ``(tiles_fwd, tiles_bwd)``.  ``derived`` holds
    what the kernels derive from the graph alone, computed at first use
    and shared by every later call on the batch (``ops.spmm.plain_norm``:
    the plain conv's degree); every new batch, ``to``, ``with_leaves`` and
    ``dataclasses.replace`` included, starts it empty.  The steps hand
    the model a new batch each step (``train.steps._as_graph``), so a step
    computes it once, and a captured step at each replay, from the leaves
    that step reads."""

    x: object
    senders: object
    receivers: object
    edge_mask: object
    node_mask: object
    node_graph: object
    y: object
    graph_mask: object
    recv: EdgeCsr
    send: EdgeCsr
    derived: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False)

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_graphs(self) -> int:
        return int(self.y.shape[0])

    def leaves(self) -> tuple:
        """Every array of the batch, both CSRs' included, in one order."""
        return (self.x, self.senders, self.receivers, self.edge_mask, self.node_mask,
                self.node_graph, self.y, self.graph_mask) + self.recv.leaves() + self.send.leaves()

    def with_leaves(self, leaves) -> "GraphBatch":
        """A batch of the same form with ``leaves`` (in ``leaves()`` order)."""
        leaves = list(leaves)
        n = len(self.recv.leaves())
        return GraphBatch(*leaves[:8], EdgeCsr(*leaves[8:8 + n]), EdgeCsr(*leaves[8 + n:]))

    def to(self, device) -> "GraphBatch":
        return self.with_leaves([_tensor(a, device) for a in self.leaves()])


def sparse_batch(x, senders, receivers, edge_mask, node_mask, node_graph, y, graph_mask,
                 send_perm: np.ndarray | None = None) -> GraphBatch:
    """A GraphBatch of NumPy arrays with both CSR forms.  ``receivers`` must
    be non-decreasing; ``send_perm`` is the stable sender-sorted order of the
    edges (computed when not given)."""
    v = x.shape[0]
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    if receivers.size and (np.diff(receivers) < 0).any():
        raise ValueError("sparse_batch: receivers must be sorted")
    if send_perm is None:
        send_perm = np.argsort(senders, kind="stable")
    return GraphBatch(
        x=np.asarray(x, np.float32), senders=senders, receivers=receivers,
        edge_mask=np.asarray(edge_mask, bool), node_mask=np.asarray(node_mask, bool),
        node_graph=np.asarray(node_graph, np.int32), y=np.asarray(y, np.int32),
        graph_mask=np.asarray(graph_mask, bool), recv=edge_csr(receivers, v, None, edge_mask),
        send=edge_csr(senders[send_perm], v, send_perm, edge_mask))


def pad_sizes_for(graphs: Sequence[HostGraph], batch_size: int,
                  multiple: int = 128) -> tuple[int, int]:
    """Static (node, edge) budgets covering any ``batch_size``-graph batch:
    the sum of the ``batch_size`` largest graphs (+1 node, so node V-1 is
    free for the padded edges when the budget allows), rounded up."""
    n_nodes = sorted((g.num_nodes for g in graphs), reverse=True)
    n_edges = sorted((g.num_edges for g in graphs), reverse=True)
    rup = lambda v: -(-v // multiple) * multiple
    return rup(sum(n_nodes[:batch_size]) + 1), rup(max(sum(n_edges[:batch_size]), 1))


def batch_graphs(graphs: Sequence[HostGraph], num_graphs: int, num_nodes: int,
                 num_edges: int) -> GraphBatch:
    """Collate host graphs into one padded GraphBatch (NumPy): concatenation
    with node offsets, then a stable sort of the edges by receiver."""
    tot_n = sum(g.num_nodes for g in graphs)
    tot_e = sum(g.num_edges for g in graphs)
    if len(graphs) > num_graphs or tot_n > num_nodes or tot_e > num_edges:
        raise ValueError(f"batch needs ({len(graphs)} graphs, {tot_n} nodes, {tot_e} edges)"
                         f" > budget ({num_graphs}, {num_nodes}, {num_edges})")
    feat = graphs[0].x.shape[1]
    x = np.zeros((num_nodes, feat), np.float32)
    senders = np.full(num_edges, num_nodes - 1, np.int32)
    receivers = np.full(num_edges, num_nodes - 1, np.int32)
    edge_mask = np.zeros(num_edges, bool)
    node_graph = np.full(num_nodes, num_graphs, np.int32)
    y = np.zeros(num_graphs, np.int32)
    n_off = e_off = 0
    for i, g in enumerate(graphs):
        n, e = g.num_nodes, g.num_edges
        x[n_off:n_off + n] = g.x
        senders[e_off:e_off + e] = g.senders + n_off
        receivers[e_off:e_off + e] = g.receivers + n_off
        edge_mask[e_off:e_off + e] = True
        node_graph[n_off:n_off + n] = i
        y[i] = g.y
        n_off += n
        e_off += e
    order = np.argsort(receivers, kind="stable")
    return sparse_batch(x, senders[order], receivers[order], edge_mask[order],
                        np.arange(num_nodes) < n_off, node_graph, y,
                        np.arange(num_graphs) < len(graphs))
