"""Synthetic-dataset entry point of the port — counterpart of main_syn.py.

    python -m cal_tpu_torch.main_syn --model CausalGCN --inference --save_dir <d>
        [--dtype bfloat16] [--device cpu]

Serving (``--inference``) restores the newest checkpoint under --save_dir
and runs the three-branch eval sweep on the test split.  Training is not
ported yet (ROADMAP queue 1 items 4-5).
"""
from __future__ import annotations

from cal_tpu_torch.data.synthetic import (
    dataset_bias_split,
    generate_synthetic_dataset,
    print_dataset_info,
)
from cal_tpu_torch.train.causal import evaluate_causal, resolve_device
from cal_tpu_torch.utils.config import parse_args


def main(argv: list[str] | None = None) -> dict:
    cfg = parse_args(argv)
    resolve_device(cfg.device)
    if not cfg.inference:
        raise NotImplementedError(
            "training is not yet ported (ROADMAP queue 1 items 4-5); "
            "run with --inference")
    dataset = generate_synthetic_dataset(
        data_num=cfg.data_num, node_num=cfg.node_num, max_degree=cfg.max_degree,
        noise=cfg.noise, shape_num=cfg.shape_num, seed=cfg.seed,
        feature_dim=cfg.feature_dim)
    train_set, val_set, test_set, the = dataset_bias_split(
        dataset, bias=cfg.bias, split=(7, 1, 2), total=cfg.data_num * 4,
        num_classes=cfg.num_classes, seed=cfg.seed)
    print(f"train/val/test = {len(train_set)}/{len(val_set)}/{len(test_set)}")
    print_dataset_info(train_set, val_set, test_set, the)
    return evaluate_causal(test_set, cfg)


if __name__ == "__main__":
    main()
