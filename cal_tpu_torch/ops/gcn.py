"""GCN aggregation with implicit self loops, dense and sparse layouts.

Counterpart of cal_tpu/ops/gcn.py (``gcn_aggregate_dense``,
``gcn_aggregate_sparse`` and the layout dispatch of ``gcn_aggregate``).
Semantics of the reference GCNConv: self loops are dropped and re-added with
weight 1, the degree is the SENDER degree (dense: a column sum of
adj[b, r, s], row = receiver), and edge s -> r contributes
``deg_s^-1/2 * w * deg_r^-1/2 * x_s``; the self loop adds ``x_r / deg_r``.

Dense: the unweighted backbone conv is a plain batched product, as in the
JAX package (not a kernel there either); the weighted causal convs go
through the fused kernel of ``ops/fused_gcn.py``.  Sparse: the backbone conv
runs the CSR kernels of ``ops/spmm.py`` (the causal convs call
``gcn_aggregate_sparse_pair`` there directly); ``gcn_aggregate_sparse`` is
the plain reference of the whole sparse contract, and
``gcn_aggregate_sparse_coo`` the weighted conv over the coefficient SpMM of
``ops/coo_spmm.py`` (cal_tpu's ``gcn_aggregate_sparse_pallas``), which only
the on-card parity entry point (``cal_tpu_torch/parity.py``) calls.
"""
from __future__ import annotations

import torch

from cal_tpu_torch.graph import DenseGraphBatch, GraphBatch
from cal_tpu_torch.ops.coo_spmm import coo_aggregate
from cal_tpu_torch.ops.segment import segment_sum
from cal_tpu_torch.ops.spmm import gcn_aggregate_sparse_plain


def gcn_aggregate_dense(x: torch.Tensor, adj: torch.Tensor,
                        edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, N, H] (already transformed), adj [B, N, N] counts -> [B, N, H];
    optional [B, N, N] ``edge_weight`` (weight of edge s -> r at [b, r, s]).
    Rounds like the JAX version: the norm is built in the adjacency dtype,
    the degree sums in f32, the product accumulates f32."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    m = adj * (1.0 - eye)
    if edge_weight is not None:
        m = m * edge_weight.to(adj.dtype)
    deg = m.sum(dim=-2, dtype=torch.float32) + 1.0
    dis = torch.rsqrt(deg).to(m.dtype)
    norm = dis[..., :, None] * m * dis[..., None, :]
    out = torch.matmul(norm.float(), x.float()).to(x.dtype)
    return out + x / deg[..., None].to(x.dtype)


def gcn_aggregate_sparse(x: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
                         edge_mask: torch.Tensor,
                         edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """x [V, H]; senders/receivers/edge_mask [E]; optional per-edge weight
    [E] of edge senders[e] -> receivers[e].  Drops dead edges, self loops
    and their weights; computes in x's dtype like the JAX version."""
    v = x.shape[0]
    s, r = senders.long(), receivers.long()
    ew = torch.ones(s.shape, dtype=x.dtype, device=x.device) if edge_weight is None \
        else edge_weight
    ew = torch.where(edge_mask & (s != r), ew, torch.zeros((), dtype=ew.dtype,
                                                          device=x.device))
    deg = segment_sum(ew, s, v) + 1.0
    dis = torch.rsqrt(deg)
    norm = dis[s] * ew * dis[r]
    return segment_sum(norm[:, None] * x[s], r, v) + x / deg[:, None]


def gcn_aggregate_sparse_coo(x: torch.Tensor, g: GraphBatch,
                             edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """``gcn_aggregate_sparse`` with the neighbour sum on the coefficient SpMM
    (counterpart of cal_tpu's ``gcn_aggregate_sparse_pallas``): the per-edge
    coefficient chain dis[s] w dis[r] is f32 (dead edges and self loops
    weigh 0), K11 sums coef * x[s] by receiver in f32, the self term x/deg
    is added in f32 and the result rounded once to x's dtype.  Differentiable
    in x (K11T) and in ``edge_weight`` [E] (through K12's dcoef)."""
    s, r = g.senders.long(), g.receivers.long()
    ew = (torch.ones(s.shape, dtype=torch.float32, device=x.device) if edge_weight is None
          else edge_weight.float())
    ew = torch.where(g.edge_mask & (s != r), ew, torch.zeros((), device=x.device))
    deg = torch.zeros(g.num_nodes, device=x.device).index_add(0, s, ew) + 1.0
    dis = torch.rsqrt(deg)
    x32 = x.float()
    out = coo_aggregate(x32, dis[s] * ew * dis[r], g)
    return (out + x32 / deg[:, None]).to(x.dtype)


def gcn_aggregate(x, g):
    """Layout dispatch of the unweighted (backbone) aggregate."""
    if isinstance(g, DenseGraphBatch):
        return gcn_aggregate_dense(x, g.adj)
    if isinstance(g, GraphBatch):
        return gcn_aggregate_sparse_plain(x, g)
    raise TypeError(f"gcn_aggregate: unsupported batch {type(g).__name__}")
