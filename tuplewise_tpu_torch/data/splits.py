"""L0 — train/test splitting for held-out evaluation (numpy only).

A copy of the generic part of ``tuplewise_tpu.data.splits``: the same
seed gives the same arrays in both packages. Standardization is fit on
the TRAIN side only and applied to both (:func:`standardize_pair`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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
