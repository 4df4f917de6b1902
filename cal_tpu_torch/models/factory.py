"""Model factory — counterpart of cal_tpu/models/factory.py."""
from __future__ import annotations

import torch

from cal_tpu_torch.models.baselines import BaselineGNN
from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.utils.config import Config

BASELINES = {"GCN": "gcn", "GIN": "gin", "GAT": "gat"}
CAUSAL = {"CausalGCN": "gcn", "CausalGIN": "gin", "CausalGAT": "gat"}


def get_model(cfg: Config, num_features: int, num_classes: int) -> CausalGNN | BaselineGNN:
    """Build the model named by ``cfg.model``: a causal model or a baseline
    (the GAT baseline with dropout 0.2, the others 0).  The parameters do
    not depend on the layout."""
    if cfg.model not in CAUSAL and cfg.model not in BASELINES:
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.layout not in ("dense", "sparse"):
        raise NotImplementedError(
            f"layout {cfg.layout!r} not ported yet (ROADMAP queue 1 item 10)")
    if not cfg.use_pallas:
        raise NotImplementedError(
            "--use_pallas false (the unfused XLA-style path) is not ported")
    dtype = torch.bfloat16 if cfg.dtype in ("bfloat16", "bf16") else torch.float32
    if cfg.model in BASELINES:
        bb = BASELINES[cfg.model]
        return BaselineGNN(
            num_features=num_features, hidden=cfg.hidden, num_classes=num_classes,
            num_layers=cfg.layers, backbone=bb, dropout=0.2 if bb == "gat" else 0.0,
            dtype=dtype, seed=cfg.seed)
    return CausalGNN(
        num_features=num_features, hidden=cfg.hidden, num_classes=num_classes,
        num_layers=cfg.layers, backbone=CAUSAL[cfg.model],
        cat_or_add=cfg.cat_or_add, with_random=cfg.with_random,
        without_node_attention=cfg.without_node_attention,
        without_edge_attention=cfg.without_edge_attention,
        dtype=dtype, seed=cfg.seed)
