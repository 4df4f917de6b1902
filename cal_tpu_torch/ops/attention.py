"""Causal/shortcut attention splits and graph pooling, dense and sparse
layouts.

Counterpart of cal_tpu/ops/attention.py.  A linear layer on the
concatenation ``[x_sender ‖ x_receiver] @ W`` equals
``x_sender @ W_src + x_receiver @ W_dst``, and a softmax over the two
(context, object) channels equals the sigmoid of the channel difference,
so the edge attention is two node vectors ([B, N] dense, [V] sparse: the
factored form of both layouts) instead of a per-edge tensor.
"""
from __future__ import annotations

import torch

from cal_tpu_torch.graph import GraphBatch
from cal_tpu_torch.ops.fused_gcn import SigmoidEdgeWeight
from cal_tpu_torch.ops.pool import segment_pool


def matvec(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x @ v`` in x's dtype, accumulated in f32 (XLA's dot on bf16)."""
    return torch.matmul(x.float(), v.float()).to(x.dtype)


def edge_attention(x, w_src, w_dst, b):
    """Factored (context, object) edge weights, x [B, N, H] or [V, H].

    ``w_src`` [H, 2] multiplies sender features, ``w_dst`` receiver
    features (first and second half of the reference ``edge_att_mlp``
    kernel).  Weights are cast to x's dtype before the channel difference,
    as in the JAX version.  Returns two ``SigmoidEdgeWeight`` sharing src/dst.
    """
    w_src, w_dst, b = w_src.to(x.dtype), w_dst.to(x.dtype), b.to(x.dtype)
    src = matvec(x, w_src[:, 0] - w_src[:, 1]) + (b[0] - b[1])   # [B, N]
    dst = matvec(x, w_dst[:, 0] - w_dst[:, 1])                   # [B, N]
    return (SigmoidEdgeWeight(src, dst, negate=False),
            SigmoidEdgeWeight(src, dst, negate=True))


def node_attention(x, w, b):
    """Per-node (context, object) softmax weights; returns two [...] tensors."""
    logits = matvec(x, w.to(x.dtype)) + b.to(x.dtype)
    att = torch.softmax(logits, dim=-1)
    return att[..., 0], att[..., 1]


def global_add_pool(x, g):
    """Sum of node features per graph, accumulated and returned in f32 (the
    readouts run in full precision).  Dense: masked sum, [B, N, H] -> [B, H].
    Sparse: the segment-sum kernel of ``ops/pool.py`` over ``node_graph``,
    [V, H] -> [G, H] with the trash segment G (padded nodes) dropped."""
    if isinstance(g, GraphBatch):
        return segment_pool(x, g.node_graph, g.num_graphs + 1)[:g.num_graphs]
    return (x * g.node_mask[..., None].to(x.dtype)).sum(dim=1, dtype=torch.float32)
