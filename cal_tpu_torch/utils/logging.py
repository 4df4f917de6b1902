"""Structured metrics logging — counterpart of cal_tpu/utils/logging.py:
jsonl next to the reference's greppable ``syd:`` print lines."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:
    """Append-only jsonl metrics sink + optional TensorBoard mirror.

    ``path`` falsy -> jsonl off; ``tb_dir`` falsy (or tensorboard not
    importable) -> TensorBoard off.  Scalar numeric fields of every event
    are mirrored to TB as ``{event}/{field}`` against a per-event step
    counter (or an explicit ``step=`` field)."""

    def __init__(self, path: Optional[str] = None,
                 tb_dir: Optional[str] = None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._tb = None
        self._tb_steps: dict[str, int] = {}
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tb_dir)
            except ImportError:  # tensorboard is optional
                self._tb = None

    def log(self, event: str, **fields: Any) -> None:
        if self._f is not None:
            rec = {"ts": round(time.time(), 3), "event": event}
            rec.update(fields)
            self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            step = fields.get("step", fields.get("epoch"))
            if step is None:
                step = self._tb_steps.get(event, 0)
                self._tb_steps[event] = step + 1
            for k, v in fields.items():
                if k in ("step", "epoch"):
                    continue
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                self._tb.add_scalar(f"{event}/{k}", v, int(step))

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
