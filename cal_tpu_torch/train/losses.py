"""Loss library — counterpart of cal_tpu/train/losses.py (mask-aware: padded
graph slots are excluded).

Reference three-branch loss:
  c_loss  = KL(uniform || .), torch ``kl_div(c_logs, uniform, 'batchmean')``
  o_loss  = NLL(o_logs, y)
  co_loss = NLL(co_logs, y)
  loss    = c * c_loss + o * o_loss + co * co_loss
"""
from __future__ import annotations

import math

import torch


def nll_loss(log_probs: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over real graphs (F.nll_loss)."""
    n = torch.clamp(mask.sum(), min=1)
    picked = torch.gather(log_probs, -1, y[:, None].long())[:, 0]
    return -(picked * mask).sum() / n


def kl_to_uniform(log_probs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """torch F.kl_div(log_probs, uniform, reduction='batchmean') over real
    graphs: sum_g sum_k u (log u - log_probs) / num_graphs."""
    u = 1.0 / log_probs.shape[-1]
    n = torch.clamp(mask.sum(), min=1)
    per_graph = (u * (math.log(u) - log_probs)).sum(dim=-1)
    return (per_graph * mask).sum() / n


def causal_losses(c_logs, o_logs, co_logs, y, graph_mask, c_w: float, o_w: float,
                  co_w: float):
    """Returns (total, (c_loss, o_loss, co_loss))."""
    mask = graph_mask.to(c_logs.dtype)
    c_loss = kl_to_uniform(c_logs, mask)
    o_loss = nll_loss(o_logs, y, mask)
    co_loss = nll_loss(co_logs, y, mask)
    total = c_w * c_loss + o_w * o_loss + co_w * co_loss
    return total, (c_loss, o_loss, co_loss)


def correct_count(log_probs: torch.Tensor, y: torch.Tensor,
                  graph_mask: torch.Tensor) -> torch.Tensor:
    """Number of real graphs whose argmax class equals the label."""
    pred = torch.argmax(log_probs, dim=-1)
    return ((pred == y) & graph_mask).sum()
