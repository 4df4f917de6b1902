"""GCN aggregation with implicit self loops, dense layout.

Counterpart of cal_tpu/ops/gcn.py (``gcn_aggregate_dense`` and the dense
branch of ``gcn_aggregate``).  Semantics of the reference GCNConv: self
loops are dropped and re-added with weight 1, the degree is the SENDER
degree (a column sum of adj[b, r, s], row = receiver), and edge s -> r
contributes ``deg_s^-1/2 * m_rs * deg_r^-1/2 * x_s``; the self loop adds
``x_r / deg_r``.  The unweighted backbone conv is a plain batched product,
as in the JAX package (not a kernel there either).  The weighted causal
convs go through the fused kernel of ``ops/fused_gcn.py``.
"""
from __future__ import annotations

import torch

from cal_tpu_torch.graph import DenseGraphBatch


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


def gcn_aggregate(x, g):
    """Layout dispatch: only the dense layout is ported."""
    if not isinstance(g, DenseGraphBatch):
        raise NotImplementedError(
            "sparse layout not ported yet (ROADMAP queue 1 item 9)")
    return gcn_aggregate_dense(x, g.adj)
