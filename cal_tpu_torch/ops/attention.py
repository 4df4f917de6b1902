"""Causal/shortcut attention splits and graph pooling, dense layout.

Counterpart of cal_tpu/ops/attention.py.  A linear layer on the
concatenation ``[x_sender ‖ x_receiver] @ W`` equals
``x_sender @ W_src + x_receiver @ W_dst``, and a softmax over the two
(context, object) channels equals the sigmoid of the channel difference,
so the edge attention is two [B, N] vectors instead of a [B, N, N, 2] tensor.
"""
from __future__ import annotations

import torch

from cal_tpu_torch.ops.fused_gcn import SigmoidEdgeWeight


def matvec(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x @ v`` in x's dtype, accumulated in f32 (XLA's dot on bf16)."""
    return torch.matmul(x.float(), v.float()).to(x.dtype)


def edge_attention(x, w_src, w_dst, b):
    """Factored (context, object) edge weights of the dense layout.

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


def global_add_pool(x, node_mask):
    """Masked sum over nodes, [B, N, H] -> [B, H], accumulated and returned
    in f32 (the readouts run in full precision)."""
    return (x * node_mask[..., None].to(x.dtype)).sum(dim=1, dtype=torch.float32)
