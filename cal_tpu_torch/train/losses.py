"""Loss library — counterpart of cal_tpu/train/losses.py (eval part)."""
from __future__ import annotations

import torch


def correct_count(log_probs: torch.Tensor, y: torch.Tensor,
                  graph_mask: torch.Tensor) -> torch.Tensor:
    """Number of real graphs whose argmax class equals the label."""
    pred = torch.argmax(log_probs, dim=-1)
    return ((pred == y) & graph_mask).sum()
