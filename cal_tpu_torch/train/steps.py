"""Eval step — counterpart of cal_tpu/train/steps.py (``_as_graph`` and
``make_causal_eval_step``)."""
from __future__ import annotations

import torch

from cal_tpu_torch.graph import DenseGraphBatch, PackedDenseBatch, to_dense
from cal_tpu_torch.train.losses import correct_count


def _as_graph(batch: PackedDenseBatch, dtype: torch.dtype | None = None
              ) -> DenseGraphBatch:
    """Materialize the device graph; the adjacency is built directly in the
    model's compute dtype."""
    return to_dense(batch, dtype)


def make_causal_eval_step(model, eval_random: bool):
    """Returns fn(batch, generator) -> dict of correct counts and n (tensors).

    eval_random defaults to False: the intervention is the identity at eval,
    and the co-branch is the deterministic xc + xo."""

    @torch.no_grad()
    def step(batch: PackedDenseBatch, generator: torch.Generator | None = None):
        g = _as_graph(batch, model.dtype)
        c_logs, o_logs, co_logs = model(g, eval_random=eval_random, train=False,
                                        generator=generator)
        return {
            "correct_co": correct_count(co_logs, g.y, g.graph_mask),
            "correct_c": correct_count(c_logs, g.y, g.graph_mask),
            "correct_o": correct_count(o_logs, g.y, g.graph_mask),
            "n": g.graph_mask.sum(),
        }

    return step
