"""Causal training and serving — counterpart of cal_tpu/train/causal.py
(``train_causal_syn``, ``evaluate_causal``, ``train_causal_real`` and
``_finish_real_protocol``).

Both serve the causal models alike (the model comes from ``get_model``), on
the dense layout and on the sparse one (``--layout sparse``), whose batches
are budget-packed when ``--pack_batches`` asks for it or, in "auto", when
the graphs' sizes call for it (``_want_pack``); a packed epoch ends with
empty batches, which the steps skip on the host, and the cosine schedule
counts the real steps (``schedule_steps``).
``train_causal_syn``: train/val/test loaders, Adam with the per-epoch
cosine schedule, and the test accuracies taken at the epoch of best val
accuracy (o-branch), with the reference's per-epoch and ``syd:`` lines.
``--scan_epochs true`` (the default) runs the device-side epoch on both
layouts and every model, as cal_tpu's scanned epoch: ``_EpochPrefetcher``
packs (the native packer), stacks and ships each epoch's batches (one
pinned host-to-device copy per leaf) while the card runs the epoch before,
and on CUDA every step replays one CUDA graph
(``steps.make_causal_train_epoch``), the eval sweeps over the val and test
stacks too (``_eval_scan``), and ``evaluate_causal``'s serving sweep goes
through the eval epoch; on the CPU the same steps run eagerly, in the same
order with the same seeds as the per-step loop of ``--scan_epochs
false``.
``train_causal_real``: the reference's k-fold 'test_max' protocol on a real
dataset (a fresh model per fold, the epoch chosen afterwards from the
fold-mean test accuracies, mean and std over folds, the ``sydall`` line).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from cal_tpu_torch.data.kfold import k_fold
from cal_tpu_torch.data.loader import (
    Loader,
    batch_nodes,
    compute_budgets,
    pack_ratio,
    want_pack,
)
from cal_tpu_torch.graph import HostGraph
from cal_tpu_torch.models.factory import CAUSAL, get_model
from cal_tpu_torch.train.optim import cosine_lr
from cal_tpu_torch.train.steps import (
    StackedBatches,
    has_real_graph,
    init_state,
    make_causal_eval_epoch,
    make_causal_eval_step,
    make_causal_train_epoch,
    make_causal_train_step,
    ship,
    stack_batches_host,
    step_seed,
)
from cal_tpu_torch.utils.checkpoint import Checkpointer
from cal_tpu_torch.utils.config import Config
from cal_tpu_torch.utils.logging import MetricsLogger


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: CUDA unless the CPU was asked for;
    a CUDA request on a machine without CUDA raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def _eval(eval_step, batches, generator) -> tuple[float, float, float, int]:
    """(acc_co, acc_c, acc_o, real graphs) over device batches; one read of
    the device sums at the end."""
    tot = None
    for b in batches:
        m = eval_step(b, generator)
        v = torch.stack([m["correct_co"], m["correct_c"], m["correct_o"], m["n"]])
        tot = v if tot is None else tot + v
    return _rates(*(tot.tolist() if tot is not None else [0] * 4))


class _Failure:
    """A producer thread's exception, passed down the queues."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _EpochPrefetcher:
    """Epoch preparation overlapped with the card (cal_tpu's
    ``_EpochPrefetcher``): a host thread packs each epoch's batches
    (``loader.host_batches``, the native packer) and stacks them
    (``stack_batches_host``), a device thread ships each stack (``ship``:
    one pinned copy per leaf on a stream of its own), with queues of one
    between them, so epoch N+1 is packed and copied while the card runs
    epoch N.  The host thread is the only reader of the loader, so the
    shuffle stream is drawn in order.

    Three repairs on cal_tpu's: ``next`` re-raises a producer's exception
    (it waits ``timeout`` seconds at most for an epoch); the producers stop
    after ``epochs`` epochs, so no epoch beyond the run is packed or
    shipped; ``close`` stops both threads and joins them."""

    def __init__(self, loader: Loader, device: torch.device, epochs: int,
                 timeout: float = 3600.0):
        self.loader, self.device, self.epochs, self.timeout = loader, device, epochs, timeout
        self._hq: queue.Queue = queue.Queue(maxsize=1)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self.threads = [threading.Thread(target=fn, daemon=True, name=f"epoch-prefetch-{name}")
                        for fn, name in ((self._produce_host, "host"),
                                         (self._produce_device, "device"))]
        for t in self.threads:
            t.start()

    def _put(self, q: queue.Queue, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _get(self, q: queue.Queue):
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                pass
        return None

    def _produce_host(self) -> None:
        try:
            for _ in range(self.epochs):
                batches = list(self.loader.host_batches())
                if not self._put(self._hq, stack_batches_host(batches) if batches else None):
                    return
        except BaseException as exc:   # handed to next(), which raises it
            self._put(self._hq, _Failure(exc))

    def _produce_device(self) -> None:
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        try:
            for _ in range(self.epochs):
                item = self._get(self._hq)
                if item is None and self._stop.is_set():
                    return
                if isinstance(item, StackedBatches):
                    if stream is None:
                        item = ship(item, self.device)
                    else:
                        with torch.cuda.stream(stream):
                            item = ship(item, self.device)
                if not self._put(self._q, item) or isinstance(item, _Failure):
                    return
        except BaseException as exc:
            self._put(self._q, _Failure(exc))

    def next(self) -> StackedBatches | None:
        """The next epoch's device stack (None for an epoch without batches);
        raises a producer's exception, or TimeoutError."""
        try:
            item = self._q.get(timeout=self.timeout)
        except queue.Empty:
            raise TimeoutError(f"no epoch from the prefetcher in {self.timeout} s") from None
        if isinstance(item, _Failure):
            raise RuntimeError("the epoch prefetcher failed") from item.exc
        if item is not None and self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            for t in item.leaves():   # the allocator waits for this stream's use
                t.record_stream(cur)
        return item

    def close(self, timeout: float = 120.0) -> None:
        """Stop both threads, drop the queued stacks and join the threads."""
        self._stop.set()
        for q in (self._hq, self._q):
            try:
                q.get_nowait()
            except queue.Empty:
                pass
        for t in self.threads:
            t.join(timeout)


def _epoch_prefetcher(loader: Loader, device: torch.device, epochs: int) -> _EpochPrefetcher:
    """A prefetcher of ``epochs`` epochs of ``loader``, attached to it; a
    prefetcher the loader held is closed first."""
    _close_prefetcher(loader)
    pf = loader._epoch_prefetcher = _EpochPrefetcher(loader, device, epochs)
    return pf


def _close_prefetcher(loader: Loader) -> None:
    pf = getattr(loader, "_epoch_prefetcher", None)
    if pf is not None:
        pf.close()
        loader._epoch_prefetcher = None


def _run_epoch(train_step, loader: Loader) -> torch.Tensor | None:
    """The per-step loop over the next epoch of ``loader``: its sums, or
    None for an epoch without a real step."""
    sums = None
    for batch in loader.host_batches():
        sums = train_step(batch, sums)
    return sums


def _run_epoch_scan(epoch_fn, prefetcher: _EpochPrefetcher) -> torch.Tensor | None:
    """The next prefetched epoch through the device-side epoch ``epoch_fn``:
    its sums, or None for an epoch without a real step."""
    stacked = prefetcher.next()
    return None if stacked is None else epoch_fn(stacked)


def _eval_scan(eval_epoch, stacked: StackedBatches | None, generator=None) -> list | None:
    """One eval sweep over a staged stack: the summed counts read back to
    the host in one read, or None for an empty split."""
    if stacked is None:
        return None
    tot = eval_epoch(stacked) if generator is None else eval_epoch(stacked, generator)
    return None if tot is None else tot.tolist()


def _stack_loader(loader: Loader, device: torch.device) -> StackedBatches | None:
    """The loader's batches that hold a real graph, stacked and shipped to
    ``device`` once (eval loaders don't shuffle), or None."""
    batches = [b for b in loader.host_batches() if has_real_graph(b)]
    return ship(stack_batches_host(batches), device) if batches else None


def _rates(co, c, o, n) -> tuple[float, float, float, int]:
    """(acc_co, acc_c, acc_o, n) of summed eval counts."""
    d = max(n, 1)
    return co / d, c / d, o / d, n


def _step_evaluator(eval_step):
    """fn(device batches, generator) -> (acc_co, acc_c, acc_o, n), batch by
    batch."""
    return lambda batches, generator: _eval(eval_step, batches, generator)


def _scan_evaluator(eval_epoch):
    """fn(staged stack or None, generator) -> (acc_co, acc_c, acc_o, n),
    one sweep (``make_causal_eval_epoch``)."""
    return lambda stacked, generator: _rates(
        *(_eval_scan(eval_epoch, stacked, generator) or [0] * 4))


def _want_pack(cfg: Config, graphs) -> bool:
    """``want_pack`` for ``cfg``; "auto" prints its decision to pack as
    cal_tpu's ``_want_pack`` does."""
    pack = want_pack(cfg.layout, cfg.pack_batches, graphs, cfg.batch_size)
    if pack and cfg.pack_batches == "auto":
        worst, mean_batch = batch_nodes(graphs, cfg.batch_size)
        print(f"pack_batches auto: worst-case batch {worst:.0f} nodes is "
              f"{worst / mean_batch:.1f}x the mean batch — enabling "
              f"budget-packed batching")
    return pack


def _budgets(cfg: Config, graphs) -> dict:
    """Budgets over ``graphs`` (one node budget N for every loader), packed
    when ``_want_pack`` says so; the sparse layout prints the decision and
    the budgets."""
    pack = _want_pack(cfg, graphs)
    budgets = compute_budgets(graphs, cfg.batch_size, cfg.layout, pack=pack)
    if cfg.layout == "sparse":
        print(f"pack_batches {cfg.pack_batches}: worst-case batch "
              f"{pack_ratio(graphs, cfg.batch_size):.2f}x the mean batch, "
              f"{'packed' if pack else 'fixed'} sparse budgets "
              f"V={budgets['node_budget']}, E={budgets['edge_budget']}")
    return budgets


def _device_batches(loader: Loader, device) -> list:
    """The loader's batches on ``device``, without those that hold no real
    graph (a packed epoch's padding): they add nothing to the eval sums."""
    return [b.to(device) for b in loader.host_batches() if has_real_graph(b)]


def make_loaders(train_set, val_set, test_set, cfg: Config):
    """Loaders of the three splits with budgets over all of them (one node
    budget N for every loader, packed when ``_want_pack`` says so) and seeds
    [seed, 0, 0], as the JAX trainer."""
    sets = (train_set, val_set, test_set)
    budgets = _budgets(cfg, [g for s in sets for g in s])
    train, val, test = (Loader(s, cfg.batch_size, shuffle=(i == 0), budgets=budgets,
                               seed=(cfg.seed, 0, 0)[i], layout=cfg.layout)
                        for i, s in enumerate(sets))
    # The JAX trainer initializes its state from next(iter(train_loader)),
    # which draws one shuffle before epoch 1: draw and drop it, so epoch e
    # sees the same permutation for the same seed.
    train._chunks()
    return train, val, test


def train_causal_syn(train_set: Sequence[HostGraph], val_set: Sequence[HostGraph],
                     test_set: Sequence[HostGraph], cfg: Config,
                     verbose: bool = True) -> dict:
    """Train on ``train_set``, select by val o-accuracy, report the test
    accuracies of the selected epoch.  ``--save_model`` checkpoints the model
    and optimizer at each new best epoch; ``--resume`` continues after the
    newest checkpoint.  Returns the selection and a per-epoch history."""
    if cfg.mesh_dp * cfg.mesh_edge > 1:
        raise NotImplementedError(
            "multi-GPU training not ported yet (ROADMAP queue 1 item 10)")
    device = resolve_device(cfg.device)
    train_loader, val_loader, test_loader = make_loaders(train_set, val_set, test_set, cfg)
    state = init_state(cfg, train_set[0].x.shape[1], cfg.num_classes, device)
    schedule = cosine_lr(cfg.lr, cfg.min_lr, cfg.epochs, train_loader.schedule_steps)
    scan = cfg.scan_epochs
    args = (state, schedule, cfg.c, cfg.o, cfg.co, cfg.with_random, cfg.seed)
    # eval loaders don't shuffle: pack and copy them to the device once
    if scan:
        train_epoch = make_causal_train_epoch(*args)
        evaluate = _scan_evaluator(make_causal_eval_epoch(state.model, cfg.eval_random))
        val_data, test_data = (_stack_loader(ld, device) for ld in (val_loader, test_loader))
        # a generator each: each sweep's graph registers its own
        val_gen, test_gen = (torch.Generator(device=device) for _ in range(2))
    else:
        train_step = make_causal_train_step(*args)
        evaluate = _step_evaluator(make_causal_eval_step(state.model, cfg.eval_random))
        val_data, test_data = (_device_batches(ld, device) for ld in (val_loader, test_loader))
        val_gen = test_gen = torch.Generator(device=device)

    metrics = MetricsLogger(cfg.metrics_path, cfg.tb_dir)
    ckpt = Checkpointer(cfg.save_dir) if cfg.save_model else None
    best_val, upd_co, upd_c, upd_o, upd_ep = 0.0, 0.0, 0.0, 0.0, 0
    val_acc_o = 0.0
    start_epoch = 1
    if ckpt is not None and cfg.resume and ckpt.latest_step() is not None:
        meta = ckpt.restore(state.model, optimizer=state.optimizer)
        best_val = meta.get("val_acc_o", 0.0)
        upd_co = meta.get("test_acc_co", 0.0)
        upd_c = meta.get("test_acc_c", 0.0)
        upd_o = meta.get("test_acc_o", 0.0)
        upd_ep = int(meta.get("epoch", ckpt.latest_step()))
        state.step = int(meta.get("train_step", 0))
        start_epoch = upd_ep + 1
        print(f"resumed from checkpoint at epoch {start_epoch - 1} "
              f"(best val {best_val * 100:.2f})")

    history = []
    pf = _epoch_prefetcher(train_loader, device, cfg.epochs - start_epoch + 1) if scan else None
    for epoch in range(start_epoch, cfg.epochs + 1):
        t0 = time.perf_counter()
        sums = (_run_epoch_scan(train_epoch, pf) if scan
                else _run_epoch(train_step, train_loader))
        loss, loss_c, loss_o, loss_co, correct_o, n = (
            sums.tolist() if sums is not None else [0.0] * 6)
        train_s = time.perf_counter() - t0
        n = max(n, 1.0)
        loss, loss_c, loss_o, loss_co, train_acc = (
            loss / n, loss_c / n, loss_o / n, loss_co / n, correct_o / n)
        # val and test get independent intervention streams (--eval_random)
        _, _, val_acc_o, _ = evaluate(val_data, val_gen.manual_seed(
            step_seed(cfg.seed, epoch, 1)))
        test_co, test_c, test_o, _ = evaluate(test_data, test_gen.manual_seed(
            step_seed(cfg.seed, epoch, 2)))
        if val_acc_o > best_val:
            best_val = val_acc_o
            upd_co, upd_c, upd_o, upd_ep = test_co, test_c, test_o, epoch
            if ckpt is not None:
                ckpt.save(epoch, state.model, {
                    "val_acc_o": val_acc_o, "test_acc_co": test_co,
                    "test_acc_c": test_c, "test_acc_o": test_o,
                    "epoch": epoch, "train_step": state.step,
                }, optimizer=state.optimizer)
        seconds = time.perf_counter() - t0
        rec = dict(epoch=epoch, loss=loss, loss_c=loss_c, loss_o=loss_o, loss_co=loss_co,
                   train_acc=train_acc, val_acc_o=val_acc_o, test_acc_co=test_co,
                   test_acc_c=test_c, test_acc_o=test_o)
        metrics.log("epoch", model=cfg.model, bias=cfg.bias, **rec)
        history.append({**rec, "seconds": seconds, "train_seconds": train_s})
        if verbose:
            print(
                "BIAS:[{:.2f}] | Model:[{}] Epoch:[{}/{}] Loss:[{:.4f}={:.4f}+{:.4f}+{:.4f}] "
                "Train:[{:.2f}] val:[{:.2f}] Test:[{:.2f}] | Update Test:[co:{:.2f},c:{:.2f},o:{:.2f}] "
                "at Epoch:[{}] | {:.1f}s".format(
                    cfg.bias, cfg.model, epoch, cfg.epochs, loss, loss_c,
                    loss_o, loss_co, train_acc * 100, val_acc_o * 100,
                    test_o * 100, upd_co * 100, upd_c * 100, upd_o * 100,
                    upd_ep, seconds,
                ), flush=True)
    if scan:
        _close_prefetcher(train_loader)
    print(
        "syd: BIAS:[{:.2f}] | Val acc:[{:.2f}] Test acc:[co:{:.2f},c:{:.2f},o:{:.2f}] at epoch:[{}]".format(
            cfg.bias, val_acc_o * 100, upd_co * 100, upd_c * 100, upd_o * 100, upd_ep),
        flush=True)
    metrics.log("final", model=cfg.model, bias=cfg.bias, best_val=best_val,
                test_acc_co=upd_co, test_acc_c=upd_c, test_acc_o=upd_o, epoch=upd_ep)
    metrics.close()
    return {"best_val_acc": best_val, "test_acc_co": upd_co, "test_acc_c": upd_c,
            "test_acc_o": upd_o, "epoch": upd_ep, "history": history,
            "train_graphs": len(train_set), "steps_per_epoch": len(train_loader)}


def evaluate_causal(test_set: Sequence[HostGraph], cfg: Config,
                    num_classes: int | None = None) -> dict:
    """Restore the newest checkpoint from ``cfg.save_dir`` and run the
    three-branch eval sweep over ``test_set`` in ``cfg.layout`` (budgets
    over the test set, packed when ``_want_pack`` says so, as cal_tpu's):
    under ``--scan_epochs true`` through the eval epoch over the test set's
    stack (``make_causal_eval_epoch`` over ``_stack_loader``, cal_tpu's
    ``_eval_scan``), else batch by batch.  Returns the accuracies, the
    checkpoint step, the graph count and the sweep's wall seconds (packing
    and the copies to the device included)."""
    device = resolve_device(cfg.device)
    loader = Loader(test_set, cfg.batch_size, shuffle=False, layout=cfg.layout,
                    budgets=_budgets(cfg, test_set))
    model = get_model(cfg, test_set[0].x.shape[1], num_classes or cfg.num_classes)
    ckpt = Checkpointer(cfg.save_dir)
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(
            f"--inference: no checkpoint found under {cfg.save_dir} "
            "(train with --save_model first)")
    meta = ckpt.restore(model, step)
    model.to(device).eval()
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if cfg.scan_epochs:
        evaluate = _scan_evaluator(make_causal_eval_epoch(model, cfg.eval_random))
        co, c, o, n = evaluate(_stack_loader(loader, device), generator)
    else:
        co, c, o, n = _eval(make_causal_eval_step(model, cfg.eval_random),
                            (b.to(device) for b in loader.host_batches() if has_real_graph(b)),
                            generator)
    seconds = time.perf_counter() - t0
    print(
        "inference: ckpt epoch:[{}] | Test acc:[co:{:.2f},c:{:.2f},o:{:.2f}] "
        "on {} graphs".format(meta.get("epoch", step), co * 100, c * 100,
                              o * 100, len(test_set)))
    return {"test_acc_co": co, "test_acc_c": c, "test_acc_o": o,
            "ckpt_step": step, "graphs": int(n), "seconds": seconds}


def train_causal_real(dataset: Sequence[HostGraph], num_classes: int, cfg: Config,
                      verbose: bool = True) -> dict:
    """The k-fold protocol on a real dataset (cal_tpu's ``train_causal_real``,
    the reference's train_causal.py:63-160): stratified folds ('test_max':
    val is test), budgets over the whole dataset, and per fold a train
    loader shuffled from ``seed + fold`` (one shuffle drawn and dropped, as
    cal_tpu's state init draws it), a fresh model whose weights, dropout and
    intervention streams come from ``seed + fold``, and Adam on the cosine
    schedule sized by fold 0's train loader (its ``schedule_steps``: a
    packed epoch's pad batches take no step).  Prints the per-epoch ``Causal
    |`` lines, one ``syd:`` line per fold and the ``sydall Final`` line;
    returns ``_finish_real_protocol``'s result with the per-epoch
    ``history``."""
    if cfg.folds < 2:
        # test_max makes val the test fold; one fold leaves no train split
        raise ValueError(
            f"--folds must be >= 2 under the k-fold test_max protocol "
            f"(got {cfg.folds}): with one fold the train split is empty")
    if cfg.fold_parallel:
        raise NotImplementedError(
            "--fold_parallel true is not ported (ROADMAP queue 1 item 8d); the folds run "
            "one after another")
    if cfg.mesh_dp * cfg.mesh_edge > 1:
        raise NotImplementedError(
            "multi-GPU training not ported yet (ROADMAP queue 1 item 10)")
    if cfg.model not in CAUSAL:
        raise ValueError(f"the real-data protocol trains the causal models, not {cfg.model!r}")
    device = resolve_device(cfg.device)
    graphs = list(dataset)
    labels = np.array([g.y for g in graphs])
    folds = cfg.folds
    accs = {k: np.zeros((folds, cfg.epochs)) for k in ("co", "c", "o", "train")}
    random_guess = 1.0 / num_classes
    budgets = _budgets(cfg, graphs)
    scan = cfg.scan_epochs
    schedule = None
    history = []
    for fold, (train_idx, test_idx, _) in enumerate(zip(*k_fold(labels, folds,
                                                               cfg.epoch_select))):
        fold_seed = cfg.seed + fold
        train_loader = Loader([graphs[i] for i in train_idx], cfg.batch_size, shuffle=True,
                              budgets=budgets, seed=fold_seed, layout=cfg.layout)
        test_loader = Loader([graphs[i] for i in test_idx], cfg.batch_size, shuffle=False,
                             budgets=budgets, layout=cfg.layout)
        train_loader._chunks()
        if schedule is None:
            schedule = cosine_lr(cfg.lr, cfg.min_lr, cfg.epochs, train_loader.schedule_steps)
        state = init_state(cfg.replace(seed=fold_seed), graphs[0].x.shape[1], num_classes,
                           device)
        eval_gen = torch.Generator(device=device)
        args = (state, schedule, cfg.c, cfg.o, cfg.co, cfg.with_random, fold_seed)
        if scan:
            train_epoch = make_causal_train_epoch(*args)
            evaluate = _scan_evaluator(make_causal_eval_epoch(state.model, cfg.eval_random))
            test_data = _stack_loader(test_loader, device)
            pf = _epoch_prefetcher(train_loader, device, cfg.epochs)
        else:
            train_step = make_causal_train_step(*args)
            evaluate = _step_evaluator(make_causal_eval_step(state.model, cfg.eval_random))
            test_data = _device_batches(test_loader, device)
        best_test, best_ep, best_c, best_o = 0.0, 0, 0.0, 0.0
        for epoch in range(1, cfg.epochs + 1):
            t0 = time.perf_counter()
            sums = (_run_epoch_scan(train_epoch, pf) if scan
                    else _run_epoch(train_step, train_loader))
            loss, loss_c, loss_o, loss_co, correct_o, n = (
                sums.tolist() if sums is not None else [0.0] * 6)
            train_s = time.perf_counter() - t0
            n = max(n, 1.0)
            loss, loss_c, loss_o, loss_co, train_acc = (
                loss / n, loss_c / n, loss_o / n, loss_co / n, correct_o / n)
            t_co, t_c, t_o, _ = evaluate(test_data, eval_gen.manual_seed(
                step_seed(fold_seed, epoch, 2)))
            for k, v in (("co", t_co), ("c", t_c), ("o", t_o), ("train", train_acc)):
                accs[k][fold, epoch - 1] = v
            if t_co > best_test:
                best_test, best_ep, best_c, best_o = t_co, epoch, t_c, t_o
            history.append(dict(fold=fold, epoch=epoch, loss=loss, loss_c=loss_c, loss_o=loss_o,
                                loss_co=loss_co, train_acc=train_acc, test_acc_co=t_co,
                                test_acc_c=t_c, test_acc_o=t_o, train_seconds=train_s,
                                seconds=time.perf_counter() - t0))
            if verbose:
                print(
                    "Causal | dataset:[{}] fold:[{}] | Epoch:[{}/{}] Loss:[{:.4f}={:.4f}+{:.4f}+{:.4f}] "
                    "Train:[{:.4f}] Test:[{:.2f}] Test_o:[{:.2f}] Test_c:[{:.2f}] (RG:{:.2f}) | "
                    "Best Test:[{:.2f}] at Epoch:[{}]".format(
                        cfg.dataset, fold, epoch, cfg.epochs, loss, loss_c, loss_o, loss_co,
                        train_acc * 100, t_co * 100, t_o * 100, t_c * 100,
                        random_guess * 100, best_test * 100, best_ep), flush=True)
        if scan:
            _close_prefetcher(train_loader)
        print(
            "syd: Causal fold:[{}] | Dataset:[{}] Model:[{}] | Best Test:[{:.2f}] at epoch [{}] | "
            "Test_o:[{:.2f}] Test_c:[{:.2f}] (RG:{:.2f})".format(
                fold, cfg.dataset, cfg.model, best_test * 100, best_ep, best_o * 100,
                best_c * 100, random_guess * 100), flush=True)
    result = _finish_real_protocol(cfg, folds, random_guess, accs["co"], accs["c"],
                                   accs["o"], accs["train"])
    return {**result, "history": history}


def _finish_real_protocol(cfg: Config, folds: int, random_guess: float, test_accs,
                          test_accs_c, test_accs_o, train_accs) -> dict:
    """The reference's post-hoc selection (train_causal.py:124-132): the
    co-branch epoch maximizes the fold-mean test accuracy, the o-branch takes
    its own; mean and std (ddof 1) over folds; the ``sydall Final`` line."""
    sel = int(test_accs.mean(axis=0).argmax())
    sel_o = int(test_accs_o.mean(axis=0).argmax())
    acc, acc_c, acc_o = test_accs[:, sel], test_accs_c[:, sel], test_accs_o[:, sel_o]
    std = lambda a: float(a.std(ddof=1)) if folds > 1 else 0.0
    result = {
        "test_acc_mean": float(acc.mean()), "test_acc_std": std(acc),
        "test_acc_c_mean": float(acc_c.mean()), "test_acc_c_std": std(acc_c),
        "test_acc_o_mean": float(acc_o.mean()), "test_acc_o_std": std(acc_o),
        "train_acc_mean": float(train_accs[:, -1].mean()),
        "selected_epoch": sel + 1,
    }
    print("=" * 150)
    print(
        "sydall Final: Causal | Dataset:[{}] Model:[{}] seed:[{}]| Test Acc: {:.2f}±{:.2f} | "
        "OTest: {:.2f}±{:.2f}, CTest: {:.2f}±{:.2f} (RG:{:.2f}) | [Settings] co:{},c:{},o:{},harf:{},dim:{},fc:{}".format(
            cfg.dataset, cfg.model, cfg.seed,
            result["test_acc_mean"] * 100, result["test_acc_std"] * 100,
            result["test_acc_o_mean"] * 100, result["test_acc_o_std"] * 100,
            result["test_acc_c_mean"] * 100, result["test_acc_c_std"] * 100,
            random_guess * 100, cfg.co, cfg.c, cfg.o, cfg.harf_hidden, cfg.hidden,
            cfg.fc_num), flush=True)
    print("=" * 150)
    return result
