"""Stratified k-fold splits of the real-data protocol.

Counterpart of cal_tpu/data/kfold.py (the reference's sklearn
``StratifiedKFold(shuffle=True, random_state=12345)``, where the
'test_max' protocol makes the val split the test split): the same
algorithm and random stream, so both packages give the same folds index for
index.
"""
from __future__ import annotations

import numpy as np


def stratified_k_fold(labels: np.ndarray, folds: int, seed: int = 12345):
    """Test indices of each fold, as sklearn's StratifiedKFold(shuffle=True):
    each class's fold assignments are balanced and then shuffled."""
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels)
    n = len(labels)
    # classes are encoded by FIRST OCCURRENCE order (not sorted value): the
    # order decides the random stream's use and so the folds
    _, first_idx, y_inv = np.unique(labels, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(first_idx)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::folds], minlength=n_classes)
                             for i in range(folds)])
    test_folds = np.empty(n, dtype=int)
    for k in range(n_classes):
        folds_for_class = np.arange(folds).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return [np.where(test_folds == i)[0] for i in range(folds)]


def k_fold(labels: np.ndarray, folds: int, epoch_select: str, seed: int = 12345):
    """(train_indices, test_indices, val_indices), one array per fold: val is
    the test fold under 'test_max', else the previous fold's test split."""
    test_indices = stratified_k_fold(labels, folds, seed)
    if epoch_select == "test_max":
        val_indices = [test_indices[i] for i in range(folds)]
    else:
        val_indices = [test_indices[i - 1] for i in range(folds)]
    train_indices = []
    n = len(labels)
    for i in range(folds):
        mask = np.ones(n, dtype=bool)
        mask[test_indices[i]] = False
        mask[val_indices[i]] = False
        train_indices.append(np.where(mask)[0])
    return train_indices, test_indices, val_indices
