"""Serving mode of the causal models — counterpart of
cal_tpu/train/causal.py::evaluate_causal (``--inference``)."""
from __future__ import annotations

import time
from typing import Sequence

import torch

from cal_tpu_torch.data.loader import Loader
from cal_tpu_torch.graph import HostGraph
from cal_tpu_torch.models.factory import get_model
from cal_tpu_torch.train.steps import make_causal_eval_step
from cal_tpu_torch.utils.checkpoint import Checkpointer
from cal_tpu_torch.utils.config import Config


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


def evaluate_causal(test_set: Sequence[HostGraph], cfg: Config,
                    num_classes: int | None = None) -> dict:
    """Restore the newest checkpoint from ``cfg.save_dir`` and run the
    three-branch eval sweep over ``test_set``.  Returns the accuracies, the
    checkpoint step, the graph count and the sweep's wall seconds."""
    device = resolve_device(cfg.device)
    loader = Loader(test_set, cfg.batch_size, shuffle=False)
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
    tot = {"correct_co": 0, "correct_c": 0, "correct_o": 0, "n": 0}
    counts = [eval_step(batch.to(device), generator)
              for batch in loader.host_batches()]
    for m in counts:
        for k in tot:
            tot[k] += int(m[k])
    seconds = time.perf_counter() - t0
    n = max(tot["n"], 1)
    co, c, o = (tot["correct_co"] / n, tot["correct_c"] / n, tot["correct_o"] / n)
    print(
        "inference: ckpt epoch:[{}] | Test acc:[co:{:.2f},c:{:.2f},o:{:.2f}] "
        "on {} graphs".format(meta.get("epoch", step), co * 100, c * 100,
                              o * 100, len(test_set)))
    return {"test_acc_co": co, "test_acc_c": c, "test_acc_o": o,
            "ckpt_step": step, "graphs": tot["n"], "seconds": seconds}
