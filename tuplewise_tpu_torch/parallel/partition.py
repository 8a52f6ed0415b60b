"""L2 — the host partitioner and the host tuple-design sampler (numpy only).

A copy of ``tuplewise_tpu.parallel.partition``: the same functions on the
same ``np.random.Generator`` give the same arrays bit for bit. Schemes:

* ``"swor"`` — sampling WITHOUT replacement: one global permutation cut
  into N equal blocks (remainder dropped so shapes stay static).
* ``"swr"``  — sampling WITH replacement: each worker draws its block
  i.i.d. uniformly from the full index range.
* **proportional** (stratified) two-sample partitioning: each worker gets
  an equal share of *each class*, which keeps the local-average
  estimator well-defined and unbiased for two-sample statistics.

The incomplete-U designs (``draw_pair_design``, ``draw_triplet_design``)
are the distribution oracle of the device sampler
(``ops.device_design``), and ``partition_two_sample`` drives the numpy
oracle trainer (``models.pairwise_sgd.train_pairwise_numpy``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def partition_indices(
    n: int,
    n_workers: int,
    rng: np.random.Generator,
    scheme: str = "swor",
) -> np.ndarray:
    """Partition ``range(n)`` into ``n_workers`` equal blocks.

    Returns an int array of shape [n_workers, n // n_workers]; with
    ``"swor"`` the blocks are disjoint (remainder indices dropped),
    with ``"swr"`` each entry is an i.i.d. uniform draw.
    """
    per = n // n_workers
    if per == 0:
        raise ValueError(f"n={n} too small for {n_workers} workers")
    if scheme == "swor":
        perm = rng.permutation(n)[: per * n_workers]
        return perm.reshape(n_workers, per)
    if scheme == "swr":
        return rng.integers(0, n, size=(n_workers, per))
    raise ValueError(f"unknown partition scheme {scheme!r}")


def partition_two_sample(
    n_pos: int,
    n_neg: int,
    n_workers: int,
    rng: np.random.Generator,
    scheme: str = "swor",
) -> Tuple[np.ndarray, np.ndarray]:
    """Proportional (class-stratified) two-sample partition.

    Each worker receives ``n_pos // N`` positives and ``n_neg // N``
    negatives — the stratification required for unbiased local-average
    estimation of two-sample U-statistics [SURVEY §1.2 item 2].

    Returns (pos_idx [N, n_pos//N], neg_idx [N, n_neg//N]).
    """
    return (
        partition_indices(n_pos, n_workers, rng, scheme),
        partition_indices(n_neg, n_workers, rng, scheme),
    )


# ---------------------------------------------------------------------------
# Incomplete-U pair sampling designs [SURVEY §1.1 incomplete; PAPERS.md:6]
# ---------------------------------------------------------------------------

def _distinct_uniform(
    rng: np.random.Generator, grid: int, size: int
) -> np.ndarray:
    """``size`` distinct uniform draws from range(grid) without ever
    materializing the grid: exact permutation-based choice for small
    grids, draw-and-dedup (uniform over distinct subsets) for huge ones."""
    if size > grid:
        raise ValueError(f"cannot draw {size} distinct tuples from a "
                         f"grid of {grid}")
    if grid <= max(4 * size, 1 << 20):
        return rng.choice(grid, size=size, replace=False)
    out = np.unique(rng.integers(0, grid, size=size + size // 8 + 16))
    while len(out) < size:
        extra = rng.integers(0, grid, size=size // 4 + 16)
        out = np.unique(np.concatenate([out, extra]))
    rng.shuffle(out)
    return out[:size]


def design_pad_len(n_pairs: int, design: str) -> int:
    """Fixed buffer length for a design's index/weight arrays — the
    SINGLE definition shared by every consumer that pads realized
    draws to a static shape (ops.device_design and its consumers).
    swr/swor realize exactly n_pairs; bernoulli's Binomial size gets
    8-sigma headroom (truncation ~1e-15/draw), so every draw of a
    (budget, design) has one shape."""
    if design == "bernoulli":
        import math

        return n_pairs + 8 * int(math.ceil(math.sqrt(n_pairs))) + 8
    return n_pairs


def draw_pair_design(
    rng: np.random.Generator,
    n1: int,
    n2: int,
    n_pairs: int,
    design: str = "swr",
    *,
    one_sample: bool = False,
):
    """(i, j) index arrays sampling the n1 x n2 tuple grid.

    Designs (incomplete U-statistics, Clemencon/Colin/Bellet):
      "swr"       — n_pairs i.i.d. uniform draws with replacement;
      "swor"      — n_pairs DISTINCT tuples;
      "bernoulli" — every tuple kept independently with probability
                    n_pairs/grid, simulated exactly: realized sample
                    size ~ Binomial(grid, p), then a uniform distinct
                    sample of that size (floored at 1 so the estimator
                    stays defined).

    one_sample: the grid is the OFF-DIAGONAL of an (n1 x n1) grid,
    encoded with n2 = n1 - 1 columns; returned j is shifted past i so
    callers index the original array directly.
    """
    grid = n1 * n2
    if design == "swr":
        i = rng.integers(0, n1, size=n_pairs)
        j = rng.integers(0, n2, size=n_pairs)
    elif design in ("swor", "bernoulli"):
        if design == "bernoulli":
            p = n_pairs / grid
            if p > 1.0:
                raise ValueError(
                    f"bernoulli rate n_pairs/grid = {p:.3f} exceeds 1")
            size = max(1, int(rng.binomial(grid, p)))
        else:
            size = n_pairs
        lin = _distinct_uniform(rng, grid, size)
        i, j = lin // n2, lin % n2
    else:
        raise ValueError(
            f"unknown sampling design {design!r}; "
            "choose 'swr', 'swor', or 'bernoulli'"
        )
    if one_sample:
        j = np.where(j >= i, j + 1, j)
    return np.asarray(i), np.asarray(j)


def draw_triplet_design(
    rng: np.random.Generator,
    n1: int,
    n2: int,
    n_tuples: int,
    design: str = "swr",
):
    """(i, j, k) index arrays sampling the degree-3 tuple grid
    {(i, j, k) : i, j in range(n1), i != j, k in range(n2)} — anchor /
    positive from the first sample, negative from the second
    [SURVEY §1.1 degree-3].

    Same designs as :func:`draw_pair_design`; swor/bernoulli linearize
    the grid as ((i * (n1-1) + j') * n2 + k) with j' the off-diagonal
    column (j shifted past i), reusing the dedup sampler, so distinctness
    is exact over ordered (i, j, k) triples. The swr branch draws
    i, then shifted j, then k — the exact call sequence the NumPy
    backend always used, so seeds reproduce historical results.
    """
    if n1 < 2:
        raise ValueError(f"need n1 >= 2 anchors/positives, got {n1}")
    grid = n1 * (n1 - 1) * n2
    if design == "swr":
        i = rng.integers(0, n1, size=n_tuples)
        j = rng.integers(0, n1 - 1, size=n_tuples)
        j = np.where(j >= i, j + 1, j)
        k = rng.integers(0, n2, size=n_tuples)
        return np.asarray(i), np.asarray(j), np.asarray(k)
    if design not in ("swor", "bernoulli"):
        raise ValueError(
            f"unknown sampling design {design!r}; "
            "choose 'swr', 'swor', or 'bernoulli'"
        )
    if design == "bernoulli":
        p = n_tuples / grid
        if p > 1.0:
            raise ValueError(
                f"bernoulli rate n_tuples/grid = {p:.3f} exceeds 1")
        size = max(1, int(rng.binomial(grid, p)))
    else:
        size = n_tuples
    lin = _distinct_uniform(rng, grid, size)
    k = lin % n2
    rest = lin // n2
    i, jp = rest // (n1 - 1), rest % (n1 - 1)
    j = np.where(jp >= i, jp + 1, jp)
    return np.asarray(i), np.asarray(j), np.asarray(k)


# ---------------------------------------------------------------------------
# Packing for the device mesh: static [N, cap] blocks + validity masks
# ---------------------------------------------------------------------------

def pack_all(values: np.ndarray, n_workers: int):
    """Deterministically pack EVERY row into [N, cap, ...] + mask + ids.

    Keeps all n rows — cap = ceil(n / N), tail zero-padded with a
    zero mask — which is what complete (all-pairs) statistics need.
    Returns (packed, mask, ids) with ids = original row index (padding
    gets id -1, excluded by masks anyway).
    """
    n = len(values)
    cap = -(-n // n_workers)
    pad = n_workers * cap - n
    packed = np.concatenate(
        [values, np.zeros((pad,) + values.shape[1:], values.dtype)]
    ).reshape((n_workers, cap) + values.shape[1:])
    mask = np.concatenate(
        [np.ones(n), np.zeros(pad)]
    ).reshape(n_workers, cap)
    ids = np.concatenate(
        [np.arange(n), np.full(pad, -1)]
    ).astype(np.int32).reshape(n_workers, cap)
    return packed, mask, ids
