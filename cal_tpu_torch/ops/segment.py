"""Segment reductions — counterpart of cal_tpu/ops/segment.py (``segment_sum``)."""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of the rows of ``data`` with ``segment_ids == s``; ids
    outside [0, num_segments) are dropped, as ``jax.ops.segment_sum`` does."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids[keep], data[keep])
