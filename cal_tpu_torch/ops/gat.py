"""Multi-head GAT aggregation, dense layout, written with plain tensor ops.

Counterpart of cal_tpu/ops/gat.py ``gat_aggregate_dense``: PyG-1.1.0
``GATConv`` attention over the [B, N, N] count adjacency.  Per graph, head
h and edge s -> r: ``e = leaky_relu(att_dst . xh_r + att_src . xh_s, 0.2)``,
softmaxed over the receiver's incoming edges with each duplicate edge one
term and an analytic self loop of multiplicity 1; ``out_r = sum_s alpha
xh_s``.  It materializes [B, N, N, heads] scores, so the model path never
calls it: the layer runs the flash-GAT kernel (``ops/flash_gat.py``), and
the tests hold that kernel's plain twin against this reference.  Attention
dropout lives in ``ops/flash_gat.py`` (Philox bits the backward replays).
"""
from __future__ import annotations

import torch

NEG_SLOPE = 0.2   # PyG 1.1.0 GATConv default negative_slope
_BIG_NEG = -1e30


def gat_aggregate_dense(xh: torch.Tensor, adj: torch.Tensor, att_dst: torch.Tensor,
                        att_src: torch.Tensor) -> torch.Tensor:
    """xh [B, N, heads, d]; adj [B, N, N] counts (row = receiver);
    att_dst / att_src [heads, d] (receiver / sender half).  Returns
    [B, N, heads, d] in xh's dtype; the aggregate accumulates in f32."""
    ti = torch.einsum("bnhd,hd->bnh", xh, att_dst)
    tj = torch.einsum("bnhd,hd->bnh", xh, att_src)
    score = torch.nn.functional.leaky_relu(ti[:, :, None, :] + tj[:, None, :, :], NEG_SLOPE)
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    counts = adj * (1.0 - eye) + eye          # self loop has multiplicity 1
    allowed = (counts > 0)[..., None]
    masked = torch.where(allowed, score, torch.full_like(score, _BIG_NEG))
    m = masked.amax(dim=2, keepdim=True)
    num = torch.exp(masked - m) * counts[..., None]
    alpha = num / num.sum(dim=2, keepdim=True)
    return torch.einsum("brsh,bshd->brhd", alpha.float(), xh.float()).to(xh.dtype)
