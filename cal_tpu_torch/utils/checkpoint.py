"""Checkpoints of the port, and weights carried across from the JAX package.

Layout: ``<dir>/ckpt_<step>.pt`` written by ``torch.save`` holding
``{"params": {name: tensor}, "batch_stats": {name: tensor}, "meta": dict}``;
names are the model's ``state_dict`` keys, which follow the flax tree paths
(``params_from_jax``).  Only the last ``max_to_keep`` steps are kept.
"""
from __future__ import annotations

import os
import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def params_from_jax(params: Mapping, batch_stats: Mapping) -> dict:
    """flax ``params`` and ``batch_stats`` trees (NumPy leaves) -> the port's
    state dict.  Layouts carry over unchanged: kernels stay [in, out]."""
    flat = {**_flatten(params), **_flatten(batch_stats)}
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in flat.items()}


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: nn.Module, metadata: dict | None = None):
        os.makedirs(self.directory, exist_ok=True)
        payload = {
            "params": {k: v.detach().cpu() for k, v in model.named_parameters()},
            "batch_stats": {k: v.detach().cpu() for k, v in model.named_buffers()},
            "meta": dict(metadata or {}),
        }
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def restore(self, model: nn.Module, step: int | None = None) -> dict:
        """Load ``step`` (default: latest) into ``model``; returns its meta."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        model.load_state_dict({**payload["params"], **payload["batch_stats"]})
        return payload["meta"]
