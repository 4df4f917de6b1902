"""Configuration — counterpart of cal_tpu/utils/config.py.

Same flag names and defaults as the JAX package (which mirrors the
reference's argparse flags), plus ``--device``: the port runs on ``cuda``
unless ``--device cpu`` is given.  Flags of paths this slice does not port
are parsed and rejected where they would take effect.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Config:
    # toy/synthetic dataset
    data_num: int = 2000
    node_num: int = 15
    max_degree: int = 10
    feature_dim: int = -1          # -1 -> degree one-hot of size max_degree
    noise: float = 0.1
    num_classes: int = 4
    shape_num: int = 1
    bias: float = 0.5

    # training
    epochs: int = 100
    batch_size: int = 128
    lr: float = 0.001
    min_lr: float = 1e-6
    weight_decay: float = 0.0
    seed: int = 666

    # causal GNN
    layers: int = 3
    c: float = 0.5
    o: float = 1.0
    co: float = 0.5
    harf_hidden: float = 0.5
    cat_or_add: str = "add"
    hidden: int = 128

    # behavior flags
    with_random: bool = True
    eval_random: bool = False
    without_node_attention: bool = False
    without_edge_attention: bool = False

    # real-data protocol
    folds: int = 10
    fc_num: str = "222"
    data_root: str = "data"
    dataset: str = "NCI1"
    epoch_select: str = "test_max"
    model: str = "GCN"

    # reference flags kept for CLI parity
    step_size: float = 0.001
    pretrain: int = 30
    penalty_weight: float = 0.1
    train_type: str = "base"
    the: int = 0
    normalize: bool = False
    save_model: bool = False
    inference: bool = False
    k: int = 3
    num_layers: int = 3
    save_dir: str = "debug"
    lr_decay_factor: float = 0.5
    lr_decay_step_size: int = 500
    global_pool: str = "sum"

    # framework knobs of the JAX package
    resume: bool = False
    metrics_path: str = ""
    tb_dir: str = ""
    profile_dir: str = ""
    layout: str = "dense"
    dtype: str = "float32"         # compute dtype of the conv stack
    node_budget: int = 0
    edge_budget: int = 0
    mesh_dp: int = 1
    mesh_edge: int = 1
    use_pallas: bool = True        # the fused kernels (the port's CUDA kernels)
    pack_batches: str = "auto"
    scan_epochs: bool = True
    fold_parallel: bool = False
    log_every: int = 1

    # port only
    device: str = "cuda"           # "cuda" or "cpu" (the CPU runs the plain twins)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def parse_args(argv: list[str] | None = None) -> Config:
    """argparse front-end with the reference's flag names."""
    import argparse

    str2bool = lambda x: str(x).lower() == "true"
    p = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        t = f.type if isinstance(f.type, type) else type(f.default)
        if t is bool:
            p.add_argument(f"--{f.name}", type=str2bool, default=f.default)
        else:
            p.add_argument(f"--{f.name}", type=t, default=f.default)
    cfg = Config(**vars(p.parse_args(argv)))
    print_config(cfg)
    return cfg


def print_config(cfg: Config, width: int = 80) -> None:
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        pad = max(1, width - len(f.name) - len(str(val)))
        print(f.name + "." * pad + str(val))
    print()
