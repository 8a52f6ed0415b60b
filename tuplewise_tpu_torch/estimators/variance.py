"""Closed-form U-statistic variance via the Hoeffding decomposition.

A copy of ``tuplewise_tpu.estimators.variance``: the statistical oracle
of the Monte-Carlo harness. The formulas are numpy; the plug-in moments
evaluate the port's kernel bodies on float64 CPU tensors.

Population zeta components (two-sample, degree (1,1)):
    zeta_10 = Var( E[h(X,Y) | X] ),  zeta_01 = Var( E[h(X,Y) | Y] ),
    zeta_11 = Var( h(X,Y) )
    Var(U_n) = [ zeta_11 + (n2-1) zeta_10 + (n1-1) zeta_01 ] / (n1 n2)

Incomplete U with B tuples drawn with replacement:
    Var(U~_B) = Var(U_n) + (1/B) (zeta_11 - Var(U_n))
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tuplewise_tpu_torch.ops.kernels import Kernel, get_kernel

_BLOCK = 4096


def _matrix(kernel: Kernel, a, b) -> np.ndarray:
    return kernel.pair_matrix(
        torch.as_tensor(np.asarray(a, np.float64)),
        torch.as_tensor(np.asarray(b, np.float64)),
    ).numpy()


def _pair_moments(kernel: Kernel, A, B) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Blockwise row means, col means, overall mean, mean of h^2."""
    n1, n2 = len(A), len(B)
    row_sum = np.zeros(n1)
    col_sum = np.zeros(n2)
    sq_sum = 0.0
    for i0 in range(0, n1, _BLOCK):
        a = A[i0 : i0 + _BLOCK]
        for j0 in range(0, n2, _BLOCK):
            m = _matrix(kernel, a, B[j0 : j0 + _BLOCK])
            row_sum[i0 : i0 + len(a)] += m.sum(axis=1)
            col_sum[j0 : j0 + m.shape[1]] += m.sum(axis=0)
            sq_sum += float(np.sum(m * m))
    row_mean = row_sum / n2
    col_mean = col_sum / n1
    mean = float(row_sum.sum() / (n1 * n2))
    return row_mean, col_mean, mean, sq_sum / (n1 * n2)


def two_sample_zetas(kernel, A, B) -> Tuple[float, float, float]:
    """Plug-in estimates of (zeta_10, zeta_01, zeta_11)."""
    kernel = get_kernel(kernel)
    row_mean, col_mean, mean, h2_mean = _pair_moments(kernel, A, B)
    z10 = float(np.var(row_mean))
    z01 = float(np.var(col_mean))
    z11 = h2_mean - mean**2
    return z10, z01, max(z11, 0.0)


def two_sample_variance_from_zetas(zetas, n1: int, n2: int) -> float:
    z10, z01, z11 = zetas
    return (z11 + (n2 - 1) * z10 + (n1 - 1) * z01) / (n1 * n2)


def two_sample_variance(kernel, A, B) -> float:
    """Var(U_n) for the complete two-sample U-statistic."""
    return two_sample_variance_from_zetas(
        two_sample_zetas(kernel, A, B), len(A), len(B)
    )


def one_sample_zetas(kernel, A) -> Tuple[float, float]:
    """(zeta_1, zeta_2) for a symmetric one-sample degree-2 kernel."""
    kernel = get_kernel(kernel)
    n = len(A)
    row_sum = np.zeros(n)
    sq_sum = 0.0
    diag = np.zeros(n)
    diag_sq = 0.0
    for i0 in range(0, n, _BLOCK):
        a = A[i0 : i0 + _BLOCK]
        for j0 in range(0, n, _BLOCK):
            m = _matrix(kernel, a, A[j0 : j0 + _BLOCK])
            if i0 == j0:
                d = np.diagonal(m).copy()
                diag[i0 : i0 + len(d)] = d
                diag_sq += float(np.sum(d * d))
            row_sum[i0 : i0 + len(a)] += m.sum(axis=1)
            sq_sum += float(np.sum(m * m))
    # exclude the diagonal (i != j)
    row_mean = (row_sum - diag) / (n - 1)
    total = row_sum.sum() - diag.sum()
    mean = total / (n * (n - 1))
    h2_mean = (sq_sum - diag_sq) / (n * (n - 1))
    z1 = float(np.var(row_mean))
    z2 = max(h2_mean - mean**2, 0.0)
    return z1, z2


def one_sample_variance_from_zetas(zetas, n: int) -> float:
    z1, z2 = zetas
    return (2.0 / (n * (n - 1))) * (2.0 * (n - 2) * z1 + z2)


def one_sample_variance(kernel, A) -> float:
    """Var(U_n) = (2/(n(n-1))) [ 2(n-2) zeta_1 + zeta_2 ]."""
    return one_sample_variance_from_zetas(one_sample_zetas(kernel, A), len(A))


def _zetas_and_sizes(kernel, A, B):
    """One pair-grid sweep; everything below derives from it."""
    kernel = get_kernel(kernel)
    if kernel.two_sample:
        return kernel, two_sample_zetas(kernel, A, B), (len(A), len(B))
    return kernel, one_sample_zetas(kernel, A), (len(A),)


def _complete_var(kernel, zetas, sizes) -> float:
    if kernel.two_sample:
        return two_sample_variance_from_zetas(zetas, *sizes)
    return one_sample_variance_from_zetas(zetas, sizes[0])


def _local_var(kernel, zetas, sizes, n_workers: int) -> float:
    """Var(U^loc_N) under proportional SWOR partitioning, fresh-draw
    approximation (accurate up to O(1/n) partition-coupling terms):
    each worker holds n/N points, workers treated independent, so
    Var = Var(U_{n/N}) / N."""
    per = tuple(s // n_workers for s in sizes)
    if min(per) < 2:
        raise ValueError(
            f"n_workers={n_workers} leaves per-worker sample sizes {per}; "
            "need at least 2 points per worker and class for a local "
            "U-statistic"
        )
    return _complete_var(kernel, zetas, per) / n_workers


def local_variance_from_zetas(zetas, n1, n2, *, n_workers: int) -> float:
    """Zeta-level Var(U^loc_N) for two-sample statistics."""
    per = (n1 // n_workers, n2 // n_workers)
    if min(per) < 2:
        raise ValueError(
            f"n_workers={n_workers} leaves per-worker sizes {per}; need "
            "at least 2 rows per worker and class"
        )
    return two_sample_variance_from_zetas(zetas, *per) / n_workers


def repartitioned_variance_from_zetas(
    zetas, n1, n2, *, n_workers: int, n_rounds: int
) -> float:
    """Zeta-level Var(U_{N,T}): complete floor + deficit / T."""
    vc = two_sample_variance_from_zetas(zetas, n1, n2)
    v_loc = local_variance_from_zetas(zetas, n1, n2, n_workers=n_workers)
    return vc + max(v_loc - vc, 0.0) / n_rounds


def incomplete_variance_from_zetas(
    zetas, n1, n2, *, n_pairs: int, design: str = "swr"
) -> float:
    """Zeta-level Var(U~_B) by sampling design.

    swr (with replacement): Var(U_n) + (zeta_11 - Var(U_n)) / B — the
    conditional-on-data sampling noise is s^2/B with E[s^2] =
    zeta_11 - Var(U_n) (total kernel variance minus the part the
    complete U already carries).

    swor (B DISTINCT tuples): simple random sampling without
    replacement from the G = n1*n2 grid multiplies the conditional
    term by the finite-population factor; with S^2 the (G-1)-ddof grid
    variance, Var(mean) = (S^2/B)(1 - B/G) and E[S^2] =
    (G/(G-1)) E[s^2], giving
        Var = Var(U_n) + (zeta_11 - Var(U_n)) * (G - B) / (B (G - 1)).
    At B = G this hits the complete floor exactly — the variance
    reduction the distinct designs exist for.

    bernoulli: realized size K ~ Binomial(G, B/G) then a uniform
    distinct K-set (parallel.partition.draw_pair_design); E over K of
    the swor form is the swor value up to O(1/B) relative corrections
    (CV^2 of K), far below the audit's z resolution.
    """
    vc = two_sample_variance_from_zetas(zetas, n1, n2)
    if design == "swr":
        return vc + (zetas[-1] - vc) / n_pairs
    if design in ("swor", "bernoulli"):
        grid = n1 * n2
        fpc = (grid - n_pairs) / (n_pairs * (grid - 1.0))
        return vc + (zetas[-1] - vc) * fpc
    raise ValueError(f"unknown sampling design {design!r}")


def conditional_incomplete_variance(
    grid_var: float, grid: int, *, n_pairs: int, design: str = "swr"
) -> float:
    """EXACT Var(U~_B | data) from the grid variance of the kernel
    values on a FIXED dataset (for the AUC indicator kernel,
    grid_var = U(1-U) with U the complete statistic — no plug-in).

    This is where the design choice lives:
      swr        s^2 / B                     (s^2 = ddof-0 grid var)
      swor       (S^2/B)(1 - B/G),  S^2 = s^2 G/(G-1) — at B = G/2 the
                 conditional variance HALVES vs swr; at B = G it is 0
      bernoulli  E_K[swor(K)] over K ~ Binomial(G, B/G) — equals the
                 swor value up to O(1/B) relative corrections
    Unconditionally the difference is sigma_h^2/G, invisible against
    Var(U_n) ~ zeta_1/n.
    """
    if design == "swr":
        return grid_var / n_pairs
    if design in ("swor", "bernoulli"):
        big_s2 = grid_var * grid / (grid - 1.0)
        return (big_s2 / n_pairs) * (1.0 - n_pairs / grid)
    raise ValueError(f"unknown sampling design {design!r}")


def incomplete_variance(kernel, A, B=None, *, n_pairs: int) -> float:
    """Var of the incomplete U-statistic with B tuples drawn with
    replacement: Var(U_n) + (zeta_11 - Var(U_n)) / B."""
    kernel, zetas, sizes = _zetas_and_sizes(kernel, A, B)
    var_u = _complete_var(kernel, zetas, sizes)
    z_full = zetas[-1]  # zeta_11 (two-sample) / zeta_2 (one-sample)
    return var_u + (z_full - var_u) / n_pairs


def local_average_variance(kernel, A, B=None, *, n_workers: int) -> float:
    """Var(U^loc_N) — see :func:`_local_var`."""
    kernel, zetas, sizes = _zetas_and_sizes(kernel, A, B)
    return _local_var(kernel, zetas, sizes, n_workers)


def repartitioned_variance(
    kernel, A, B=None, *, n_workers: int, n_rounds: int
) -> float:
    """Var(U_{N,T}) for T SWOR repartition rounds.

    Decompose Var(U^loc_N) = Var(U_n) + extra, where `extra` is the
    variance added by ignoring cross-worker tuples. Fresh reshuffles
    redraw the partition but NOT the data, so the U_n component is common
    across rounds while `extra` averages down:
        Var(U_{N,T}) ~= Var(U_n) + extra / T
    — the trade-off curve in the paper's title.
    """
    kernel, zetas, sizes = _zetas_and_sizes(kernel, A, B)
    var_complete = _complete_var(kernel, zetas, sizes)
    var_loc = _local_var(kernel, zetas, sizes, n_workers)
    extra = max(var_loc - var_complete, 0.0)
    return var_complete + extra / n_rounds
