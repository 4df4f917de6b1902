"""GIN neighbourhood sum, PyG-1.1.0 ``GINConv`` aggregation.

Counterpart of cal_tpu/ops/gin.py ``gin_aggregate`` at its fixed eps 0:
``x + sum_{u -> v} x_u`` with no self-loop manipulation (a self loop in the edge
list adds x_v once more; duplicate edges count each time).  The MLP lives in
the layer (``nn/layers.py`` ``GINConvLayer``).

Dense: a plain f32 product of the count adjacency and x, rounded once to x's
dtype (cal_tpu's einsum is plain XLA, not a kernel).  Sparse: the
coefficient SpMM of ``ops/coo_spmm.py`` (K11 forward, K11T backward) with
``coef = edge_mask``: only padding is dead.  cal_tpu takes that kernel only
on tiled batches (node budget >= 2048) and sums with ``segment_sum`` in x's
dtype below; the port always runs K11, which sums in f32 and rounds once
(equal in f32, within bf16 rounding in bf16).  The add ``x + agg`` runs
in x's dtype.
"""
from __future__ import annotations

import torch

from cal_tpu_torch.graph import DenseGraphBatch, GraphBatch
from cal_tpu_torch.ops.coo_spmm import coo_aggregate


def gin_aggregate(x: torch.Tensor, g) -> torch.Tensor:
    """x + neighbour sum; x [B, N, H] (dense) or [V, H] (sparse)."""
    if isinstance(g, DenseGraphBatch):
        agg = torch.matmul(g.adj.float(), x.float()).to(x.dtype)
    elif isinstance(g, GraphBatch):
        agg = coo_aggregate(x, g.edge_mask.float(), g).to(x.dtype)
    else:
        raise TypeError(f"gin_aggregate: unsupported batch {type(g).__name__}")
    return x + agg
