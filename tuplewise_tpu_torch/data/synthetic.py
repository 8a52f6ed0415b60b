"""L0 — synthetic data generation (numpy only).

Two-class Gaussians with controllable separation, the calibration dataset
of BASELINE config 1. A copy of ``tuplewise_tpu.data.synthetic``: the same
seed gives the same arrays in both packages.
"""

from __future__ import annotations

import math

import numpy as np


def make_gaussians(
    n_pos: int,
    n_neg: int,
    dim: int = 1,
    separation: float = 1.0,
    seed: int = 0,
):
    """Two-class isotropic Gaussians separated along the first axis.

    Positives ~ N(separation * e_1, I), negatives ~ N(0, I).

    Returns:
      (X, Y): float64 arrays of shape [n_pos, dim] and [n_neg, dim].
    """
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_pos, dim))
    X[:, 0] += separation
    Y = rng.standard_normal((n_neg, dim))
    return X, Y


def true_gaussian_auc(separation: float) -> float:
    """Exact AUC of the score s(x) = x_1 under :func:`make_gaussians`:
    s(X) - s(Y) ~ N(separation, 2), so AUC = Phi(separation / sqrt(2))."""
    return 0.5 * (1.0 + math.erf(separation / 2.0))
