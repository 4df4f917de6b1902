"""Real-data entry point of the port — counterpart of main_real.py (its TU
branch).

    python -m benchmarks.gen_reddit_synthetic --root data
    python -m cal_tpu_torch.main_real --model CausalGAT --dataset SYNREDDIT
        [--dtype bfloat16] [--folds 10] [--epochs 100] [--layout sparse]
        [--device cpu]

Reads ``{data_root}/{dataset}/raw/{dataset}_*.txt`` (TU text format; the
port downloads nothing, so REDDIT-, NCI1- and DD-scale data come from the
generators under ``benchmarks/``), expands the features by the dataset's
``feat_str`` rule and runs the reference's stratified k-fold 'test_max'
protocol for a causal model (``train_causal_real``).  On the dense layout a
dataset of large graphs (N >= 384) runs its GAT convs on the
edge-formulated kernel; on the sparse layout a heavy-tailed dataset
(SYNREDDIT) gets budget-packed batches ("auto").  OGB datasets (``ogbg-*``) are not ported and raise.
The port runs on CUDA unless ``--device cpu`` is given (the CPU runs the
kernels' plain twins).
"""
from __future__ import annotations

import time

from cal_tpu_torch.data.datasets import create_n_filter_triples, get_dataset
from cal_tpu_torch.train.causal import resolve_device, train_causal_real
from cal_tpu_torch.utils.config import parse_args


def main(argv: list[str] | None = None) -> dict:
    cfg = parse_args(argv)
    resolve_device(cfg.device)
    if cfg.dataset.replace("_", "-").startswith("ogbg-"):
        raise NotImplementedError(
            "OGB datasets (the ogbg-* branch of main_real.py, predict_causal, roc_auc_score) "
            "are not ported (ROADMAP queue 1 item 8b)")
    result = None
    for name, feat_str, _net in create_n_filter_triples([cfg.dataset]):
        t0 = time.perf_counter()
        dataset = get_dataset(name, feat_str=feat_str, root=cfg.data_root)
        print(f"{dataset}: {dataset.num_features} features, {dataset.num_classes} classes")
        t1 = time.perf_counter()
        result = train_causal_real(dataset, dataset.num_classes, cfg)
        print(f"wall: dataset {t1 - t0:.1f}s, training {time.perf_counter() - t1:.1f}s")
    return result


if __name__ == "__main__":
    main()
