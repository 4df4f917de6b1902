"""Train and eval steps — counterpart of cal_tpu/train/steps.py (``init_state``,
``_causal_step_fn``/``make_causal_train_step``, ``make_causal_eval_step``,
``_baseline_step_fn``/``make_baseline_train_step``, ``make_baseline_eval_step``).

PyTorch runs the step eagerly: forward with ``train=True``, the three
losses, backward (the dual masked conv's and, for CausalGAT, the flash-GAT
backward kernels on the dense layout; the sparse convs', the pool's and,
for CausalGAT, the sparse GAT backward kernels on the sparse one), Adam,
and the BatchNorm running stats,
which the forward moves in place.  Both steps take a dense batch
(``PackedDenseBatch``) or a sparse one (``GraphBatch``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cal_tpu_torch.graph import DenseGraphBatch, GraphBatch, PackedDenseBatch, to_dense
from cal_tpu_torch.models.factory import get_model
from cal_tpu_torch.train.losses import causal_losses, correct_count, nll_loss
from cal_tpu_torch.train.optim import make_optimizer, set_lr
from cal_tpu_torch.utils.config import Config


@dataclasses.dataclass
class TrainState:
    """Model, optimizer and the count of optimizer steps taken (the
    schedule's and the intervention stream's clock)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _as_graph(batch: PackedDenseBatch | GraphBatch, dtype: torch.dtype | None = None
              ) -> DenseGraphBatch | GraphBatch:
    """The device graph: a dense batch's adjacency is built directly in the
    model's compute dtype; a sparse batch is used as it is (the model casts
    its features)."""
    if isinstance(batch, GraphBatch):
        return batch
    return to_dense(batch, dtype)


# SeedSequence pads its entropy with zeros ([s, t] and [s, t, 0] give one
# state), so the attention-dropout seeds carry a stream word of their own
# that keeps them apart from the intervention and eval seeds.
_GAT_DROPOUT_STREAM = 0x6761745F
# the GAT baseline's dropout before its classifier: a stream of its own
_HEAD_DROPOUT_STREAM = 0x68656164


def step_seed(seed: int, *counters: int) -> int:
    """A well-mixed 64-bit seed from (seed, counters...): the counterpart of
    ``fold_in(rng, step)`` for a ``torch.Generator``."""
    return int(np.random.SeedSequence([seed, *counters]).generate_state(1, np.uint64)[0])


def dropout_seeds(model, seed: int, step: int) -> list[int] | None:
    """The GAT layers' attention-dropout seeds of train step ``step``, one
    per layer (None for backbones without dropout), for the causal models
    and the baselines alike: a rerun and a resumed run draw the same
    masks."""
    if model.backbone != "gat":
        return None
    return [step_seed(seed, step, _GAT_DROPOUT_STREAM, i) for i in range(model.num_layers)]


def init_state(cfg: Config, num_features: int, num_classes: int,
               device: torch.device) -> TrainState:
    """The model named by ``cfg`` (weights from ``cfg.seed``) on ``device``,
    and its Adam optimizer."""
    model = get_model(cfg, num_features, num_classes).to(device)
    return TrainState(model, make_optimizer(model.parameters(), cfg.weight_decay))


def has_real_graph(batch: PackedDenseBatch | GraphBatch) -> bool:
    """Whether a host batch (NumPy leaves) holds a real graph; a packed
    epoch's padding batches hold none."""
    real = (np.asarray(batch.graph_mask) if isinstance(batch, GraphBatch)
            else np.asarray(batch.n_nodes) > 0)
    return bool(real.any())


def _fill_unused_grads(params) -> None:
    for p in params:
        if p.grad is None:
            # unused by the forward (the gfn projection's bias): a zero
            # gradient as jax.grad gives, so Adam still applies L2 to it
            p.grad = torch.zeros_like(p)


def make_causal_train_step(state: TrainState, schedule, c_w: float, o_w: float,
                           co_w: float, with_random: bool, seed: int):
    """Returns fn(host_batch, sums) -> sums.

    ``sums`` is None or an f32 device tensor of per-batch sums accumulated
    over the epoch: [loss*n, loss_c*n, loss_o*n, loss_co*n, correct_o, n]
    (each loss scaled by the real-graph count n, mirroring
    ``loss.item() * num_graphs`` of the reference).  A batch without a real
    graph (no node in a dense batch, no ``graph_mask`` entry in a sparse
    one) is skipped on the host (no device work, the step count does not
    move), like the JAX ``_gate_state``.  The intervention generator is
    re-seeded from (seed, step) each step, and the GAT layers' dropout seeds
    derive from (seed, step, layer).  Gradients stay in ``.grad`` until the
    next step.  ``step.on_device(batch, sums)`` takes a batch already on the
    model's device that holds a real graph, and reads nothing back to the
    host: the benchmark's timed loop runs it on batches staged once."""
    model, optimizer = state.model, state.optimizer
    params = list(model.parameters())
    device = params[0].device
    generator = torch.Generator(device=device)

    def step(batch: PackedDenseBatch | GraphBatch,
             sums: torch.Tensor | None) -> torch.Tensor | None:
        if not has_real_graph(batch):
            return sums
        return on_device(batch.to(device), sums)

    def on_device(batch: PackedDenseBatch | GraphBatch,
                  sums: torch.Tensor | None) -> torch.Tensor:
        generator.manual_seed(step_seed(seed, state.step))
        g = _as_graph(batch, model.dtype)
        c_logs, o_logs, co_logs = model(g, eval_random=with_random, train=True,
                                        generator=generator,
                                        dropout_seeds=dropout_seeds(model, seed, state.step))
        total, (c_l, o_l, co_l) = causal_losses(c_logs, o_logs, co_logs, g.y,
                                                g.graph_mask, c_w, o_w, co_w)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        _fill_unused_grads(params)
        set_lr(optimizer, schedule(state.step))
        optimizer.step()
        state.step += 1
        n = g.graph_mask.sum().float()
        m = torch.stack([total * n, c_l * n, o_l * n, co_l * n,
                         correct_count(o_logs, g.y, g.graph_mask).float(), n]).detach()
        return m if sums is None else sums + m

    step.on_device = on_device
    return step


def make_baseline_train_step(state: TrainState, schedule, seed: int):
    """Returns fn(host_batch, sums) -> sums for a baseline model.

    ``sums`` is None or an f32 device tensor [loss*n, correct, n] summed
    over the epoch (the NLL over real graphs times their count n, as
    ``_baseline_step_fn``'s aux).  A batch without a real graph is skipped
    on the host (no device work, the step count does not move), like the
    JAX ``_gate_state``.  The GAT baseline's attention-dropout seeds derive
    from (seed, step, layer) and its pre-classifier dropout generator from
    (seed, step)."""
    model, optimizer = state.model, state.optimizer
    params = list(model.parameters())
    device = params[0].device
    generator = torch.Generator(device=device)

    def step(batch: PackedDenseBatch | GraphBatch,
             sums: torch.Tensor | None) -> torch.Tensor | None:
        if not has_real_graph(batch):
            return sums
        generator.manual_seed(step_seed(seed, state.step, _HEAD_DROPOUT_STREAM))
        g = _as_graph(batch.to(device), model.dtype)
        out = model(g, train=True, dropout_seeds=dropout_seeds(model, seed, state.step),
                    generator=generator)
        mask = g.graph_mask.to(out.dtype)
        loss = nll_loss(out, g.y, mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _fill_unused_grads(params)
        set_lr(optimizer, schedule(state.step))
        optimizer.step()
        state.step += 1
        n = g.graph_mask.sum().float()
        m = torch.stack([loss * n, correct_count(out, g.y, g.graph_mask).float(), n]).detach()
        return m if sums is None else sums + m

    return step


def make_baseline_eval_step(model):
    """Returns fn(batch) -> dict of the correct count and n (tensors)."""

    @torch.no_grad()
    def step(batch: PackedDenseBatch | GraphBatch):
        g = _as_graph(batch, model.dtype)
        out = model(g, train=False)
        return {"correct": correct_count(out, g.y, g.graph_mask), "n": g.graph_mask.sum()}

    return step


def make_causal_eval_step(model, eval_random: bool):
    """Returns fn(batch, generator) -> dict of correct counts and n (tensors).

    eval_random defaults to False: the intervention is the identity at eval,
    and the co-branch is the deterministic xc + xo."""

    @torch.no_grad()
    def step(batch: PackedDenseBatch | GraphBatch, generator: torch.Generator | None = None):
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
