"""Optimizer — counterpart of cal_tpu/train/optim.py: Adam plus the
reference's per-epoch cosine annealing.

torch Adam's ``weight_decay`` adds L2 to the gradient before the moments,
which is what ``add_decayed_weights`` before ``scale_by_adam`` does in the
JAX package.  The learning rate is set from the closed form of
CosineAnnealingLR stepped once per epoch, evaluated at the optimizer step
count as the JAX schedule is (not from CosineAnnealingLR's recursive update,
which drifts from the closed form in float).

On CUDA, Adam is capturable (``capturable=True``: its step count lives on
the card and its update reads no host value) and its learning rate is a
device scalar that ``set_lr`` fills in place before each step, so one CUDA
graph of the step (``train/graphs.py``) replays every step of the run with
that step's rate.  The eager steps on CUDA take the same optimizer, so a
captured step and an eager one compute the same numbers.  On the CPU the
rate stays a Python float.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def cosine_lr(lr: float, min_lr: float, epochs: int,
              steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate at optimizer step ``count`` (0-based):
    ``min_lr + (lr - min_lr) (1 + cos(pi e / E)) / 2`` with
    ``e = min(count // steps_per_epoch, E)``."""

    def schedule(count: int) -> float:
        epoch = min(count // steps_per_epoch, epochs)
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam(betas=(0.9, 0.999), eps=1e-8); the trainer sets its ``lr`` from
    ``cosine_lr`` before every step.  Capturable, with the rate a device
    scalar, when the parameters are on CUDA."""
    params = list(params)
    if params and params[0].device.type == "cuda":
        return torch.optim.Adam(params, lr=torch.zeros((), device=params[0].device),
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
                                capturable=True, foreach=True)
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The rate of the next step: a capturable group's device scalar is
    filled in place (no host sync; a captured step reads it), made anew on
    the parameters' device where a restored state left a float or a host
    tensor there; any other group takes the float."""
    for group in optimizer.param_groups:
        cur = group["lr"]
        if not group.get("capturable"):
            group["lr"] = lr
        elif isinstance(cur, torch.Tensor) and cur.device == group["params"][0].device:
            cur.fill_(lr)
        else:
            group["lr"] = torch.full((), lr, device=group["params"][0].device)
