"""Model factory — counterpart of cal_tpu/models/factory.py."""
from __future__ import annotations

import torch

from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.utils.config import Config

_CAUSAL = {"CausalGCN": "gcn", "CausalGIN": "gin", "CausalGAT": "gat"}


def get_model(cfg: Config, num_features: int, num_classes: int) -> CausalGNN:
    """Build the model named by ``cfg.model`` (CausalGCN in this slice)."""
    if cfg.model not in _CAUSAL:
        raise NotImplementedError(
            f"model {cfg.model!r} not ported yet (ROADMAP queue 1 item 7)")
    if cfg.layout != "dense":
        raise NotImplementedError(
            "sparse layout not ported yet (ROADMAP queue 1 item 9)")
    if not cfg.use_pallas:
        raise NotImplementedError(
            "--use_pallas false (the unfused XLA-style path) is not ported")
    return CausalGNN(
        num_features=num_features, hidden=cfg.hidden, num_classes=num_classes,
        num_layers=cfg.layers, backbone=_CAUSAL[cfg.model],
        cat_or_add=cfg.cat_or_add, with_random=cfg.with_random,
        without_node_attention=cfg.without_node_attention,
        without_edge_attention=cfg.without_edge_attention,
        dtype=torch.bfloat16 if cfg.dtype in ("bfloat16", "bf16") else torch.float32,
        seed=cfg.seed)
