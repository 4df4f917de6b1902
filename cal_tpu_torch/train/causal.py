"""Causal training and serving — counterpart of cal_tpu/train/causal.py
(``train_causal_syn`` and ``evaluate_causal``).

Both serve CausalGCN and CausalGAT alike (the model comes from
``get_model``), on the dense layout and on the sparse one (``--layout
sparse``) with fixed budgets; budget-packed sparse batching is not ported
and raises.
``train_causal_syn``: train/val/test loaders, Adam with the per-epoch
cosine schedule, and the test accuracies taken at the epoch of best val
accuracy (o-branch), with the reference's per-epoch and ``syd:`` lines.
There is no device-side epoch here: ``--scan_epochs`` is accepted and runs
the per-step loop, whose numerics the JAX package's scan reproduces
(cal_tpu/train/steps.py make_causal_train_epoch).
"""
from __future__ import annotations

import time
from typing import Sequence

import torch

from cal_tpu_torch.data.loader import Loader, compute_budgets, pack_ratio, want_pack
from cal_tpu_torch.graph import HostGraph
from cal_tpu_torch.models.factory import get_model
from cal_tpu_torch.train.optim import cosine_lr
from cal_tpu_torch.train.steps import (
    init_state,
    make_causal_eval_step,
    make_causal_train_step,
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
    if tot is None:
        return 0.0, 0.0, 0.0, 0
    co, c, o, n = tot.tolist()
    d = max(n, 1)
    return co / d, c / d, o / d, n


def _refuse_packing(cfg: Config, graphs) -> None:
    """cal_tpu switches the sparse layout to budget-packed batches when
    ``want_pack`` says so (train/causal.py ``_want_pack``); the port has no
    packed batching yet and raises rather than train or serve unpacked."""
    if want_pack(cfg.layout, cfg.pack_batches, graphs, cfg.batch_size):
        raise NotImplementedError(
            "budget-packed sparse batching is not ported yet (ROADMAP queue 1 item 9); "
            "pass --pack_batches false")


def make_loaders(train_set, val_set, test_set, cfg: Config):
    """Loaders of the three splits with budgets over all of them (one node
    budget N for every loader) and seeds [seed, 0, 0], as the JAX trainer.
    The sparse layout refuses budget packing when it is asked for or, in
    "auto", when the splits would need it, and prints the decision and the
    budgets."""
    sets = (train_set, val_set, test_set)
    graphs = [g for s in sets for g in s]
    budgets = compute_budgets(graphs, cfg.batch_size, cfg.layout)
    if cfg.layout == "sparse":
        _refuse_packing(cfg, graphs)
        print(f"pack_batches {cfg.pack_batches}: worst-case batch "
              f"{pack_ratio(graphs, cfg.batch_size):.2f}x the mean batch, fixed sparse "
              f"budgets V={budgets['node_budget']}, E={budgets['edge_budget']}")
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
    schedule = cosine_lr(cfg.lr, cfg.min_lr, cfg.epochs, len(train_loader))
    train_step = make_causal_train_step(state, schedule, cfg.c, cfg.o, cfg.co,
                                        cfg.with_random, cfg.seed)
    eval_step = make_causal_eval_step(state.model, cfg.eval_random)
    # eval loaders don't shuffle: pack and copy them to the device once
    val_batches = [b.to(device) for b in val_loader.host_batches()]
    test_batches = [b.to(device) for b in test_loader.host_batches()]
    eval_gen = torch.Generator(device=device)

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
    for epoch in range(start_epoch, cfg.epochs + 1):
        t0 = time.perf_counter()
        sums = None
        for batch in train_loader.host_batches():
            sums = train_step(batch, sums)
        loss, loss_c, loss_o, loss_co, correct_o, n = (
            sums.tolist() if sums is not None else [0.0] * 6)
        train_s = time.perf_counter() - t0
        n = max(n, 1.0)
        loss, loss_c, loss_o, loss_co, train_acc = (
            loss / n, loss_c / n, loss_o / n, loss_co / n, correct_o / n)
        # val and test get independent intervention streams (--eval_random)
        eval_gen.manual_seed(step_seed(cfg.seed, epoch, 1))
        _, _, val_acc_o, _ = _eval(eval_step, val_batches, eval_gen)
        eval_gen.manual_seed(step_seed(cfg.seed, epoch, 2))
        test_co, test_c, test_o, _ = _eval(eval_step, test_batches, eval_gen)
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
    over the test set, as cal_tpu's).  Returns the accuracies, the
    checkpoint step, the graph count and the sweep's wall seconds."""
    device = resolve_device(cfg.device)
    _refuse_packing(cfg, test_set)
    loader = Loader(test_set, cfg.batch_size, shuffle=False, layout=cfg.layout)
    model = get_model(cfg, test_set[0].x.shape[1], num_classes or cfg.num_classes)
    ckpt = Checkpointer(cfg.save_dir)
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(
            f"--inference: no checkpoint found under {cfg.save_dir} "
            "(train with --save_model first)")
    meta = ckpt.restore(model, step)
    model.to(device).eval()
    eval_step = make_causal_eval_step(model, cfg.eval_random)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    co, c, o, n = _eval(eval_step, (b.to(device) for b in loader.host_batches()), generator)
    seconds = time.perf_counter() - t0
    print(
        "inference: ckpt epoch:[{}] | Test acc:[co:{:.2f},c:{:.2f},o:{:.2f}] "
        "on {} graphs".format(meta.get("epoch", step), co * 100, c * 100,
                              o * 100, len(test_set)))
    return {"test_acc_co": co, "test_acc_c": c, "test_acc_o": o,
            "ckpt_step": step, "graphs": int(n), "seconds": seconds}
