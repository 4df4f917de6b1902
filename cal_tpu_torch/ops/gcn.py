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
the plain reference of the whole sparse contract.
"""
from __future__ import annotations

import torch

from cal_tpu_torch.graph import DenseGraphBatch, GraphBatch
from cal_tpu_torch.ops.segment import segment_sum
from cal_tpu_torch.ops.spmm import gcn_aggregate_sparse_plain


def gcn_aggregate_dense(x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """x [B, N, H] (already transformed), adj [B, N, N] counts -> [B, N, H].
    Rounds like the JAX version: the norm is built in the adjacency dtype,
    the product accumulates f32."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    m = adj * (1.0 - eye)
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


def gcn_aggregate(x, g):
    """Layout dispatch of the unweighted (backbone) aggregate."""
    if isinstance(g, DenseGraphBatch):
        return gcn_aggregate_dense(x, g.adj)
    if isinstance(g, GraphBatch):
        return gcn_aggregate_sparse_plain(x, g)
    raise TypeError(f"gcn_aggregate: unsupported batch {type(g).__name__}")
