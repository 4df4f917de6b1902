"""Synthetic-dataset entry point of the port — counterpart of main_syn.py.

    python -m cal_tpu_torch.main_syn --model {CausalGCN,CausalGIN,CausalGAT}
        [--layout sparse [--pack_batches true]] [--dtype bfloat16]
        [--save_model true --save_dir <d>]
        [--resume true] [--device cpu]
    python -m cal_tpu_torch.main_syn --model {CausalGCN,CausalGIN,CausalGAT}
        [--layout sparse] --inference true --save_dir <d>
        [--dtype bfloat16] [--device cpu]
    python -m cal_tpu_torch.main_syn --model {GCN,GIN,GAT}
        [--layout sparse] [--dtype bfloat16] [--device cpu]

Causal models: training runs ``train_causal_syn``; ``--save_model``
checkpoints the best val-o epoch, ``--resume`` continues after it, and
``--inference`` restores the newest checkpoint under --save_dir and runs the
three-branch eval sweep on the test split.  Baselines run
``train_baseline_syn`` (no checkpoints), even when ``--inference`` is given,
as the reference's entry point does.  ``--layout sparse`` trains and serves
every model on padded edge-list batches (the CSR kernels and their backward
kernels); the parameters do not depend on the layout, so a checkpoint of
either layout serves on both.  The causal models' sparse batches are
budget-packed with ``--pack_batches true``, or in "auto" where the graphs'
sizes call for it; the baselines never pack.  The port runs on CUDA unless
``--device cpu`` is given (the CPU runs the kernels' plain twins).
"""
from __future__ import annotations

import time

from cal_tpu_torch.data.synthetic import (
    dataset_bias_split,
    generate_synthetic_dataset,
    print_dataset_info,
)
from cal_tpu_torch.models.factory import BASELINES, CAUSAL
from cal_tpu_torch.train.baseline import train_baseline_syn
from cal_tpu_torch.train.causal import evaluate_causal, resolve_device, train_causal_syn
from cal_tpu_torch.utils.config import parse_args


def main(argv: list[str] | None = None) -> dict:
    cfg = parse_args(argv)
    resolve_device(cfg.device)
    if cfg.model not in BASELINES and cfg.model not in CAUSAL:
        raise ValueError(f"unknown model {cfg.model!r}")
    t0 = time.perf_counter()
    dataset = generate_synthetic_dataset(
        data_num=cfg.data_num, node_num=cfg.node_num, max_degree=cfg.max_degree,
        noise=cfg.noise, shape_num=cfg.shape_num, seed=cfg.seed,
        feature_dim=cfg.feature_dim)
    train_set, val_set, test_set, the = dataset_bias_split(
        dataset, bias=cfg.bias, split=(7, 1, 2), total=cfg.data_num * 4,
        num_classes=cfg.num_classes, seed=cfg.seed)
    print(f"train/val/test = {len(train_set)}/{len(val_set)}/{len(test_set)}")
    print_dataset_info(train_set, val_set, test_set, the)
    if cfg.model in CAUSAL and cfg.inference:
        return evaluate_causal(test_set, cfg)
    t1 = time.perf_counter()
    train = train_baseline_syn if cfg.model in BASELINES else train_causal_syn
    res = train(train_set, val_set, test_set, cfg)
    print(f"wall: dataset {t1 - t0:.1f}s, training {time.perf_counter() - t1:.1f}s")
    return res


if __name__ == "__main__":
    main()
