"""Baseline (non-causal) synthetic training — counterpart of
cal_tpu/train/baseline.py ``train_baseline_syn``.

GCN, GIN and GAT baselines on the dense or the sparse layout: budgets over
all three splits with fixed sparse budgets (cal_tpu's baseline trainer never
packs, so neither does this one, whatever ``--pack_batches`` says), Adam
with the per-epoch cosine schedule over the train loader's length, NLL over
real graphs, selection on val accuracy, and the reference's per-epoch and
``syd:`` lines.  ``--scan_epochs true`` (the default) runs the device-side
epoch on both layouts as ``train_causal_syn`` does (one CUDA graph of the
step on the card).  No checkpoints: cal_tpu's baseline trainer writes none,
and
``main_syn`` trains a baseline even when ``--inference`` is given, as
cal_tpu's does.
"""
from __future__ import annotations

import time
from typing import Sequence

import torch

from cal_tpu_torch.data.loader import Loader, compute_budgets
from cal_tpu_torch.graph import HostGraph
from cal_tpu_torch.train.causal import (
    _close_prefetcher,
    _epoch_prefetcher,
    _eval_scan,
    _run_epoch,
    _run_epoch_scan,
    _stack_loader,
    resolve_device,
)
from cal_tpu_torch.train.optim import cosine_lr
from cal_tpu_torch.train.steps import (
    init_state,
    make_baseline_eval_epoch,
    make_baseline_eval_step,
    make_baseline_train_epoch,
    make_baseline_train_step,
)
from cal_tpu_torch.utils.config import Config


def _accuracy(eval_step, batches) -> float:
    """Correct / real graphs over device batches; one read at the end."""
    tot = None
    for b in batches:
        m = eval_step(b)
        v = torch.stack([m["correct"], m["n"]])
        tot = v if tot is None else tot + v
    return _ratio(tot.tolist() if tot is not None else None)


def _ratio(counts) -> float:
    """Correct / real graphs of summed [correct, n] counts (None: 0)."""
    if counts is None:
        return 0.0
    correct, n = counts
    return correct / max(n, 1)


def train_baseline_syn(train_set: Sequence[HostGraph], val_set: Sequence[HostGraph],
                       test_set: Sequence[HostGraph], cfg: Config,
                       verbose: bool = True) -> dict:
    """Train the baseline named by ``cfg.model`` on ``train_set``, select by
    val accuracy, report the test accuracy of the selected epoch.  Returns
    the selection and a per-epoch history."""
    if cfg.mesh_dp * cfg.mesh_edge > 1:
        raise NotImplementedError(
            "multi-GPU training not ported yet (ROADMAP queue 1 item 10)")
    device = resolve_device(cfg.device)
    graphs = list(train_set) + list(val_set) + list(test_set)
    budgets = compute_budgets(graphs, cfg.batch_size, cfg.layout)
    train_loader = Loader(train_set, cfg.batch_size, shuffle=True, budgets=budgets,
                          seed=cfg.seed, layout=cfg.layout)
    val_loader, test_loader = (Loader(s, cfg.batch_size, budgets=budgets, layout=cfg.layout)
                               for s in (val_set, test_set))
    # cal_tpu initializes its state from next(iter(train_loader)), which
    # draws one shuffle before epoch 1: draw and drop it
    train_loader._chunks()
    state = init_state(cfg, train_set[0].x.shape[1], cfg.num_classes, device)
    schedule = cosine_lr(cfg.lr, cfg.min_lr, cfg.epochs, len(train_loader))
    scan = cfg.scan_epochs
    # eval loaders don't shuffle: pack and copy them to the device once
    if scan:
        train_epoch = make_baseline_train_epoch(state, schedule, cfg.seed)
        eval_epoch = make_baseline_eval_epoch(state.model)
        accuracy = lambda stacked: _ratio(_eval_scan(eval_epoch, stacked))
        val_data, test_data = (_stack_loader(ld, device) for ld in (val_loader, test_loader))
        pf = _epoch_prefetcher(train_loader, device, cfg.epochs)
    else:
        train_step = make_baseline_train_step(state, schedule, cfg.seed)
        eval_step = make_baseline_eval_step(state.model)
        accuracy = lambda batches: _accuracy(eval_step, batches)
        val_data, test_data = ([b.to(device) for b in ld.host_batches()]
                               for ld in (val_loader, test_loader))

    best_val, upd_test, upd_ep = 0.0, 0.0, 0
    history = []
    for epoch in range(1, cfg.epochs + 1):
        t0 = time.perf_counter()
        sums = (_run_epoch_scan(train_epoch, pf) if scan
                else _run_epoch(train_step, train_loader))
        loss, correct, n = sums.tolist() if sums is not None else [0.0] * 3
        train_s = time.perf_counter() - t0
        n = max(n, 1.0)
        loss, train_acc = loss / n, correct / n
        val_acc, test_acc = accuracy(val_data), accuracy(test_data)
        if val_acc > best_val:
            best_val, upd_test, upd_ep = val_acc, test_acc, epoch
        history.append(dict(epoch=epoch, loss=loss, train_acc=train_acc, val_acc=val_acc,
                            test_acc=test_acc, seconds=time.perf_counter() - t0,
                            train_seconds=train_s))
        if verbose:
            print(
                "BIAS:[{:.2f}] | Model:[{}] Epoch:[{}/{}] Loss:[{:.4f}] Train:[{:.2f}] "
                "val:[{:.2f}] Test:[{:.2f}] | Best Val:[{:.2f}] Update Test:[{:.2f}] at Epoch:[{}]".format(
                    cfg.bias, cfg.model, epoch, cfg.epochs, loss, train_acc * 100,
                    val_acc * 100, test_acc * 100, best_val * 100, upd_test * 100, upd_ep),
                flush=True)
    if scan:
        _close_prefetcher(train_loader)
    print(
        "syd: BIAS:[{:.2f}] | Best Val acc:[{:.2f}] Test acc:[{:.2f}] at epoch:[{}]".format(
            cfg.bias, best_val * 100, upd_test * 100, upd_ep), flush=True)
    return {"best_val_acc": best_val, "test_acc": upd_test, "epoch": upd_ep,
            "history": history, "train_graphs": len(train_set),
            "steps_per_epoch": len(train_loader)}
