"""L0 — train/test splitting for held-out evaluation (numpy only).

A copy of ``tuplewise_tpu.data.splits``: the same seed gives the same
arrays in both packages. ``load_adult_splits`` takes the canonical UCI
split when ``adult.data`` and ``adult.test`` are both on disk, else a
seeded stratified split of whatever ``loaders.load_adult`` resolves (a
real file or the surrogate). Standardization is fit on the TRAIN side
only and applied to both (:func:`standardize_pair`).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from tuplewise_tpu_torch.data.loaders import (
    _data_dir, load_adult, parse_adult_csv,
)
from tuplewise_tpu_torch.data.synthetic import make_gaussians


def stratified_split(
    X: np.ndarray,
    y: np.ndarray,
    test_fraction: float = 0.25,
    seed: int = 0,
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Seeded class-stratified split into ((X_tr, y_tr), (X_te, y_te)).

    Each label class contributes ``round(test_fraction * count)`` rows
    (at least 1, at most count - 1 so neither side loses a class) to the
    test side; within-class assignment is a seeded permutation.
    """
    X, y = np.asarray(X), np.asarray(y)
    if not 0.0 < test_fraction < 1.0:
        raise ValueError(f"test_fraction must be in (0, 1), got {test_fraction}")
    rng = np.random.default_rng(seed)
    test_mask = np.zeros(len(y), dtype=bool)
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        if len(idx) < 2:
            raise ValueError(
                f"class {cls!r} has {len(idx)} row(s); need >= 2 to split"
            )
        k = int(np.clip(round(test_fraction * len(idx)), 1, len(idx) - 1))
        test_mask[rng.permutation(idx)[:k]] = True
    tr, te = ~test_mask, test_mask
    return (X[tr], y[tr]), (X[te], y[te])


def standardize_pair(
    X_train: np.ndarray, X_test: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Standardize both blocks with the TRAIN mean/std (no test leakage)."""
    mu = X_train.mean(axis=0)
    sd = X_train.std(axis=0) + 1e-12
    return (X_train - mu) / sd, (X_test - mu) / sd


def load_adult_splits(
    n: int = 32561,
    seed: int = 0,
    test_fraction: float = 0.25,
):
    """UCI Adult as a held-out-evaluation task.

    Returns ``(X_tr, y_tr, X_te, y_te, meta)``. Resolution order:

    1. canonical ``adult.data`` + ``adult.test`` both in
       ``TUPLEWISE_DATA_DIR`` → the official UCI split, column-aligned
       by the canonical vocabulary (``meta["split"] = "adult.test"``);
       train subsampled to ``n`` if larger (test kept whole — it is the
       evaluation yardstick);
    2. whatever :func:`load_adult` resolves (single real file, npz, or
       the deterministic surrogate) → seeded stratified split
       (``meta["split"] = "stratified"``).

    Features are standardized with train statistics in both paths.
    """
    d = _data_dir()
    tr_path = os.path.join(d, "adult.data")
    te_path = os.path.join(d, "adult.test")
    if os.path.exists(tr_path) and os.path.exists(te_path):
        X_tr, y_tr = parse_adult_csv(tr_path)
        X_te, y_te = parse_adult_csv(te_path)
        if len(X_tr) > n:
            keep = np.random.default_rng(seed).choice(
                len(X_tr), n, replace=False
            )
            X_tr, y_tr = X_tr[keep], y_tr[keep]
        X_tr, X_te = standardize_pair(X_tr, X_te)
        meta = {
            "synthetic": False,
            "source": tr_path,
            "split": "adult.test",
            "test_source": te_path,
        }
        return X_tr, y_tr, X_te, y_te, meta

    X, y, meta = load_adult(n=n, seed=seed, standardize=False)
    (X_tr, y_tr), (X_te, y_te) = stratified_split(
        X, y, test_fraction=test_fraction, seed=seed + 7919
    )
    X_tr, X_te = standardize_pair(X_tr, X_te)
    meta = dict(meta, split="stratified", test_fraction=test_fraction)
    return X_tr, y_tr, X_te, y_te, meta


def make_gaussian_splits(
    n_train_per_class: int,
    n_test_per_class: int,
    dim: int = 5,
    separation: float = 1.0,
    seed: int = 0,
):
    """Disjoint train/test Gaussian draws (fresh population samples).

    Returns ``(Xp_tr, Xn_tr, Xp_te, Xn_te)``. One draw of
    ``n_train + n_test`` rows per class, split by position — so the
    test rows are i.i.d. fresh samples, the honest analogue of
    evaluating on the population.
    """
    X, Y = make_gaussians(
        n_train_per_class + n_test_per_class,
        n_train_per_class + n_test_per_class,
        dim=dim, separation=separation, seed=seed,
    )
    return (
        X[:n_train_per_class], Y[:n_train_per_class],
        X[n_train_per_class:], Y[n_train_per_class:],
    )
