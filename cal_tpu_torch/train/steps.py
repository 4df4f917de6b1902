"""Train and eval steps — counterpart of cal_tpu/train/steps.py (``init_state``,
``_causal_step_fn``/``make_causal_train_step``, ``make_causal_eval_step``,
``_baseline_step_fn``/``make_baseline_train_step``, ``make_baseline_eval_step``).

A step is forward with ``train=True``, the three losses, backward (the
dual masked conv's and, for CausalGAT, the flash-GAT backward kernels on
the dense layout; the sparse convs', the pool's and, for CausalGAT, the
sparse GAT backward kernels on the sparse one), Adam, and the BatchNorm
running stats, which the forward moves in place.  Both steps take a dense
batch (``PackedDenseBatch``) or a sparse one (``GraphBatch``) and run
eagerly.  The device-side epoch (``make_causal_train_epoch``,
``make_causal_eval_epoch`` and the baselines' counterparts, cal_tpu's
scanned epochs) takes either layout's batches stacked on a step axis
(``StackedBatches``): on CUDA it replays one CUDA graph of the step
(``train/graphs.py``), on the CPU it runs the same steps eagerly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cal_tpu_torch.graph import DenseGraphBatch, GraphBatch, PackedDenseBatch, to_dense
from cal_tpu_torch.models.factory import get_model
from cal_tpu_torch.train.graphs import GraphedCall
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
    """The device graph of one step: a dense batch's adjacency is built
    directly in the model's compute dtype; a sparse batch is a new
    GraphBatch over the same leaves (the model casts its features), so what
    the kernels derive from the graph (``GraphBatch.derived``: the plain
    conv's degree) is computed once in the step, and in a captured step at
    each replay, from the leaves the step reads."""
    if isinstance(batch, GraphBatch):
        return dataclasses.replace(batch)
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


def _make_train_step(state: TrainState, schedule, seed: int, body, generator_seed):
    """The per-step wrapper around ``body(batch, generator, seeds) -> m`` (the
    device work of one step, the optimizer's included): before each step
    the host seeds the step's generator from ``generator_seed(step)`` and
    sets the rate from ``schedule(step)``; the GAT layers' dropout seeds
    derive from (seed, step, layer) and reach the layers as a row of
    ``_seed_table`` on the device, as a captured step's do."""
    model, optimizer = state.model, state.optimizer
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)

    def prologue() -> None:
        """The host side of the next step: its generator seed and rate."""
        generator.manual_seed(generator_seed(state.step))
        set_lr(optimizer, schedule(state.step))

    def on_device(batch: PackedDenseBatch | GraphBatch,
                  sums: torch.Tensor | None) -> torch.Tensor:
        prologue()
        table = _seed_table(model, seed, state.step, 1, device)
        m = body(batch, generator, None if table is None else table[0])
        state.step += 1
        return m if sums is None else sums + m

    def step(batch: PackedDenseBatch | GraphBatch,
             sums: torch.Tensor | None) -> torch.Tensor | None:
        if not has_real_graph(batch):
            return sums
        return on_device(batch.to(device), sums)

    step.on_device = on_device
    step.body, step.prologue, step.generator = body, prologue, generator
    step.state, step.seed = state, seed
    return step


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
    host.  ``step.body(batch, generator, seeds)`` is the step's device work
    alone (forward, losses, backward, Adam, the BatchNorm stats; no host
    read), which ``make_causal_train_epoch`` captures."""
    model, optimizer = state.model, state.optimizer
    params = list(model.parameters())

    def body(batch, generator, seeds) -> torch.Tensor:
        g = _as_graph(batch, model.dtype)
        c_logs, o_logs, co_logs = model(g, eval_random=with_random, train=True,
                                        generator=generator, dropout_seeds=seeds)
        total, (c_l, o_l, co_l) = causal_losses(c_logs, o_logs, co_logs, g.y,
                                                g.graph_mask, c_w, o_w, co_w)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        _fill_unused_grads(params)
        optimizer.step()
        n = g.graph_mask.sum().float()
        return torch.stack([total * n, c_l * n, o_l * n, co_l * n,
                            correct_count(o_logs, g.y, g.graph_mask).float(), n]).detach()

    return _make_train_step(state, schedule, seed, body, lambda step: step_seed(seed, step))


def make_baseline_train_step(state: TrainState, schedule, seed: int):
    """Returns fn(host_batch, sums) -> sums for a baseline model.

    ``sums`` is None or an f32 device tensor [loss*n, correct, n] summed
    over the epoch (the NLL over real graphs times their count n, as
    ``_baseline_step_fn``'s aux).  A batch without a real graph is skipped
    on the host (no device work, the step count does not move), like the
    JAX ``_gate_state``.  The GAT baseline's attention-dropout seeds derive
    from (seed, step, layer) and its pre-classifier dropout generator from
    (seed, step).  ``.on_device`` and ``.body`` as
    ``make_causal_train_step``'s."""
    model, optimizer = state.model, state.optimizer
    params = list(model.parameters())

    def body(batch, generator, seeds) -> torch.Tensor:
        g = _as_graph(batch, model.dtype)
        out = model(g, train=True, dropout_seeds=seeds, generator=generator)
        mask = g.graph_mask.to(out.dtype)
        loss = nll_loss(out, g.y, mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _fill_unused_grads(params)
        optimizer.step()
        n = g.graph_mask.sum().float()
        return torch.stack([loss * n, correct_count(out, g.y, g.graph_mask).float(), n]).detach()

    return _make_train_step(state, schedule, seed, body,
                            lambda step: step_seed(seed, step, _HEAD_DROPOUT_STREAM))


@dataclasses.dataclass(frozen=True)
class StackedBatches:
    """An epoch of batches of one layout stacked on a leading step axis (the
    JAX package's ``stack_batches_host`` tree): ``batch`` a PackedDenseBatch
    (one ``eg_budget``) or a GraphBatch (both CSRs' padded leaves and heavy
    counts included) whose every leaf is a NumPy or torch array [S, ...];
    ``real`` [S] bool on the host, whether step s holds a real graph (the
    gate of ``has_real_graph``)."""

    batch: PackedDenseBatch | GraphBatch
    real: np.ndarray

    @property
    def steps(self) -> int:
        return len(self.real)

    def at(self, s: int) -> PackedDenseBatch | GraphBatch:
        return self.batch.with_leaves([t[s] for t in self.batch.leaves()])

    def leaves(self) -> tuple:
        return self.batch.leaves()

    def with_leaves(self, leaves) -> "StackedBatches":
        return StackedBatches(self.batch.with_leaves(leaves), self.real)


def stack_batches_host(batches) -> StackedBatches:
    """Host batches of one layout and shape (NumPy leaves) stacked on a new
    leading axis: one array per leaf, shipped by ``ship`` as one copy each."""
    if not batches:
        raise ValueError("stack_batches_host takes one or more batches")
    kind = type(batches[0])
    if any(type(b) is not kind for b in batches):
        raise ValueError("the batches of one epoch share one layout")
    if kind is PackedDenseBatch:
        eg = {b.eg_budget for b in batches}
        if len(eg) != 1:
            raise ValueError(f"batches of one epoch carry different eg_budgets {sorted(eg)}")
    leaves = zip(*(b.leaves() for b in batches))
    return StackedBatches(batches[0].with_leaves(np.stack([np.asarray(a) for a in leaf])
                                                 for leaf in leaves),
                          np.array([has_real_graph(b) for b in batches]))


def ship(stacked: StackedBatches, device: torch.device) -> StackedBatches:
    """The stack's leaves on ``device``: one host-to-device copy per leaf,
    from pinned memory on CUDA (on the current stream, waited for before
    the pinned buffers are dropped); torch views of the arrays on the CPU."""
    leaves = [torch.from_numpy(np.ascontiguousarray(a)) for a in stacked.leaves()]
    if device.type != "cuda":
        return stacked.with_leaves([t.to(device) for t in leaves])
    out = [t.pin_memory().to(device, non_blocking=True) for t in leaves]
    torch.cuda.current_stream(device).synchronize()
    return stacked.with_leaves(out)


def _seed_table(model, seed: int, first_step: int, steps: int, device) -> torch.Tensor | None:
    """The GAT layers' dropout seeds of ``steps`` steps from ``first_step``
    as int64 [steps, layers] on ``device`` (each the seed's 64 bits), or
    None for backbones without dropout."""
    rows = [dropout_seeds(model, seed, first_step + k) for k in range(steps)]
    if not rows or rows[0] is None:
        return None
    table = torch.from_numpy(np.array(rows, np.uint64).view(np.int64))
    if device.type != "cuda":
        return table
    # from pinned memory without a wait: the host allocator keeps the block
    # until the copy has run
    return table.pin_memory().to(device, non_blocking=True)


class _CapturedEpoch:
    """A train epoch over a device stack, each step one replay of a CUDA
    graph of ``step.body`` (``graphs.GraphedCall``): the step's batch is
    copied into static input buffers, its dropout seeds into a static seed
    table row, its rate into Adam's device scalar and its generator seed
    into the registered generator; the graph adds the step's metrics into a
    static sums buffer."""

    def __init__(self, step, metrics: int):
        self.step = step
        model = step.state.model
        self.device = next(model.parameters()).device
        self.sums = torch.zeros(metrics, device=self.device)
        self.static = None
        self.seeds = None
        self.call = GraphedCall(self._run, self.device, [step.generator])

    def _run(self):
        return self.sums.add_(self.step.body(self.static, self.step.generator, self.seeds))

    def _stage(self, batch: PackedDenseBatch | GraphBatch) -> None:
        if self.static is None:
            self.static = batch.with_leaves([t.clone() for t in batch.leaves()])
            return
        s = self.static
        if type(batch) is not type(s) or (isinstance(s, PackedDenseBatch)
                                          and batch.eg_budget != s.eg_budget):
            raise ValueError("a captured step's batches share one layout and eg_budget")
        for dst, src in zip(s.leaves(), batch.leaves(), strict=True):
            if dst.shape != src.shape:
                raise ValueError(f"a captured step's batches share one shape: {tuple(src.shape)}"
                                 f" into {tuple(dst.shape)}")
            dst.copy_(src)

    def __call__(self, stacked: StackedBatches) -> torch.Tensor | None:
        state = self.step.state
        real = [s for s in range(stacked.steps) if stacked.real[s]]
        table = _seed_table(state.model, self.step.seed, state.step, len(real), self.device)
        if table is not None and self.seeds is None:
            self.seeds = torch.zeros(table.shape[1], dtype=torch.int64, device=self.device)
        self.sums.zero_()
        for k, s in enumerate(real):
            self._stage(stacked.at(s))
            if table is not None:
                self.seeds.copy_(table[k])
            self.step.prologue()
            self.call()
            state.step += 1
        return self.sums.clone() if real else None


def _eager_epoch(step):
    """The same epoch eagerly (the CPU): the stack's real steps in order,
    each ``step.on_device``; the same seeds as the captured epoch."""

    def epoch(stacked: StackedBatches) -> torch.Tensor | None:
        sums = None
        for s in range(stacked.steps):
            if stacked.real[s]:
                sums = step.on_device(stacked.at(s), sums)
        return sums

    return epoch


def _train_epoch(step, metrics: int):
    device = next(step.state.model.parameters()).device
    return _CapturedEpoch(step, metrics) if device.type == "cuda" else _eager_epoch(step)


def make_causal_train_epoch(state: TrainState, schedule, c_w: float, o_w: float,
                            co_w: float, with_random: bool, seed: int):
    """Device-side epoch (cal_tpu's ``make_causal_train_epoch``): returns
    fn(stacked) -> the epoch's sums (as ``make_causal_train_step``'s), or
    None when no step held a real graph, for a ``StackedBatches`` on the
    model's device.  On CUDA the first step runs eagerly on a side stream,
    the second is captured as one CUDA graph, and every later step of the
    run replays it; on the CPU every step runs eagerly.  Same order, same
    seeds and the same step count as the per-step loop."""
    return _train_epoch(make_causal_train_step(state, schedule, c_w, o_w, co_w,
                                               with_random, seed), 6)


def make_baseline_train_epoch(state: TrainState, schedule, seed: int):
    """``make_causal_train_epoch`` for a baseline model: fn(stacked) ->
    [loss*n, correct, n] sums or None."""
    return _train_epoch(make_baseline_train_step(state, schedule, seed), 3)


def _eval_sweep(model, eval_step, names):
    """fn(stacked, generator=None) -> the eval counts ``names`` summed over
    the stack's steps (a device tensor), or None for an empty stack.  On
    CUDA, each stack's sweep is one CUDA graph after its first call; a
    stack's generator is registered with its graph, so the caller seeds
    the same generator before each call."""
    device = next(model.parameters()).device
    graphs: dict = {}

    def sweep(stacked: StackedBatches, generator=None) -> torch.Tensor | None:
        tot = None
        for s in range(stacked.steps):
            m = eval_step(stacked.at(s), generator)
            v = torch.stack([m[k] for k in names])
            tot = v if tot is None else tot + v
        return tot

    def call(stacked: StackedBatches, generator=None) -> torch.Tensor | None:
        if device.type != "cuda" or stacked.steps == 0:
            return sweep(stacked, generator)
        entry = graphs.get(id(stacked))
        if entry is None:
            gens = [generator] if generator is not None else []
            entry = graphs[id(stacked)] = (
                stacked, generator, GraphedCall(lambda: sweep(stacked, generator), device, gens))
        if entry[1] is not generator:
            raise ValueError("a captured eval sweep is called with the generator it was made with")
        return entry[2]()

    return call


def make_causal_eval_epoch(model, eval_random: bool):
    """Device-side eval sweep (cal_tpu's ``make_causal_eval_epoch``): fn(
    stacked, generator) -> [correct_co, correct_c, correct_o, n] summed over
    a ``StackedBatches`` of real batches (the eval loaders' batches, staged
    once a run), captured on CUDA after the first call."""
    return _eval_sweep(model, make_causal_eval_step(model, eval_random),
                       ("correct_co", "correct_c", "correct_o", "n"))


def make_baseline_eval_epoch(model):
    """``make_causal_eval_epoch`` for a baseline: fn(stacked) -> [correct,
    n]."""
    step = make_baseline_eval_step(model)
    return _eval_sweep(model, lambda b, _gen: step(b), ("correct", "n"))


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
