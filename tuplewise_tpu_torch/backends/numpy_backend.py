"""The NumPy oracle backend: serial, blockwise, float64 on the host.

The counterpart of ``tuplewise_tpu.backends.numpy_backend``, with the same
semantics and the same host random streams (``parallel.partition``), so
the two oracles return the same floats. It never materializes the full
pair grid, runs on no device and ignores ``device``.

The kernel bodies: the built-in kernels (recognised by the identity of
their body functions, never by name) run numpy bodies here, the same
operations as the JAX package's ``xp=numpy`` bodies. A user-registered
kernel's torch body runs on float64 CPU tensors made from the numpy
blocks.

One-sample U-statistics range over pairs of distinct data points. Under
with-replacement ("swr") partitioning a worker block can hold the same
original point twice, so exclusion is done on original indices (``ids``),
not on block positions.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tuplewise_tpu_torch.backends.base import register_backend
from tuplewise_tpu_torch.ops import kernels as K
from tuplewise_tpu_torch.parallel.faults import survivors
from tuplewise_tpu_torch.parallel.partition import (
    draw_pair_design,
    draw_triplet_design,
    partition_indices,
    partition_two_sample,
)

_BLOCK = 4096


# numpy bodies of the built-in kernels
def _auc_g(d):
    return np.where(d > 0, 1.0, 0.0) + 0.5 * np.where(d == 0, 1.0, 0.0)


def _hinge_g(d):
    return np.maximum(0.0, 1.0 - d)


def _logistic_g(d):
    return np.logaddexp(0.0, -d)


def _sqdist_matrix(a, b):
    a2 = np.sum(a * a, axis=-1)
    b2 = np.sum(b * b, axis=-1)
    d2 = a2[:, None] + b2[None, :] - 2.0 * (a @ b.T)
    return np.maximum(d2, 0.0)


def _scatter_h(a, b):
    return 0.5 * _sqdist_matrix(a, b)


def _sqdist_vec(a, b):
    diff = a - b
    return np.sum(diff * diff, axis=-1)


def _scatter_h_elem(a, b):
    return 0.5 * _sqdist_vec(a, b)


def _triplet_fn(kind: str, margin: float) -> Callable:
    if kind == "indicator":
        return lambda a, p, n: np.where(
            _sqdist_vec(a, n) > _sqdist_vec(a, p) + margin, 1.0, 0.0)
    return lambda a, p, n: np.maximum(
        0.0, margin + _sqdist_vec(a, p) - _sqdist_vec(a, n))


_DIFF_BODIES = {K._auc_g: _auc_g, K._hinge_g: _hinge_g,
                K._logistic_g: _logistic_g}
_PAIR_BODIES = {K._scatter_h: (_scatter_h, _scatter_h_elem)}


def _on_tensors(fn: Callable) -> Callable:
    """A torch body as a numpy function: float64 CPU tensors in, numpy
    out."""
    def run(*arrays):
        return fn(*(torch.tensor(np.asarray(x, dtype=np.float64))
                    for x in arrays)).numpy()
    return run


class HostKernel:
    """The numpy-facing bodies of one port ``Kernel``."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.name, self.kind = kernel.name, kernel.kind
        self.two_sample = kernel.two_sample
        self.diff = self.pair = self.elem = self.triplet = None
        if kernel.kind == "diff":
            self.diff = _DIFF_BODIES.get(kernel.diff_fn) or _on_tensors(
                kernel.diff_fn)
        elif kernel.kind == "pair":
            self.pair, self.elem = _PAIR_BODIES.get(kernel.pair_fn) or (
                _on_tensors(kernel.pair_fn),
                None if kernel.pair_elem_fn is None
                else _on_tensors(kernel.pair_elem_fn))
        else:
            spec = K.builtin_triplet_spec(kernel)
            self.triplet = (_triplet_fn(*spec) if spec is not None
                            else _on_tensors(kernel.triplet_fn))

    def pair_matrix(self, a, b):
        if self.kind == "diff":
            return self.diff(a[:, None] - b[None, :])
        return self.pair(a, b)

    def pair_elementwise(self, a, b):
        if self.kind == "diff":
            return self.diff(a - b)
        assert self.elem is not None, self.name
        return self.elem(a, b)

    def triplet_values(self, a, p, n):
        return self.triplet(a, p, n)


@register_backend("numpy")
class NumpyBackend:
    """Serial oracle. All estimator methods return python floats."""

    name = "numpy"

    def __init__(self, kernel, block_size: int = _BLOCK, device=None):
        self.kernel = K.get_kernel(kernel)
        self.host = HostKernel(self.kernel)
        self.block = int(block_size)

    def to_device(self, x) -> np.ndarray:
        """A float64 host copy (tensors leave their device)."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype=np.float64)

    # ------------------------------------------------------------------ #
    # primitives                                                          #
    # ------------------------------------------------------------------ #
    def _pair_stats(
        self,
        A: np.ndarray,
        B: np.ndarray,
        ids_a: Optional[np.ndarray] = None,
        ids_b: Optional[np.ndarray] = None,
    ) -> Tuple[float, int]:
        """(sum, count) of h over the A x B grid, tiled, skipping cells
        whose original indices coincide (if ids given)."""
        k, blk = self.host, self.block
        total, count = 0.0, 0
        for i0 in range(0, len(A), blk):
            a = A[i0 : i0 + blk]
            ia = None if ids_a is None else ids_a[i0 : i0 + blk]
            for j0 in range(0, len(B), blk):
                m = np.asarray(k.pair_matrix(a, B[j0 : j0 + blk]))
                if ia is not None:
                    jb = ids_b[j0 : j0 + m.shape[1]]
                    valid = ia[:, None] != jb[None, :]
                    total += float(np.sum(m * valid))
                    count += int(np.sum(valid))
                else:
                    total += float(np.sum(m))
                    count += m.size
        return total, count

    def _triplet_stats(
        self,
        X: np.ndarray,
        Y: np.ndarray,
        ids_x: Optional[np.ndarray] = None,
    ) -> Tuple[float, int]:
        """(sum, count) of h(x_i, x_j, y_k) over i != j (by original id),
        all k. O(n1^2 n2): complete degree 3 runs at small n only."""
        k = self.host
        n1, n2 = len(X), len(Y)
        if ids_x is None:
            ids_x = np.arange(n1)
        total, count = 0.0, 0
        for i in range(n1):
            a = X[i : i + 1]
            vals = np.asarray(
                k.triplet_values(a[:, None, :], X[:, None, :], Y[None, :, :])
            )  # [n1, n2]
            valid = ids_x != ids_x[i]  # excludes j == i and duplicate draws
            total += float(np.sum(vals[valid]))
            count += int(np.sum(valid)) * n2
        return total, count

    # ------------------------------------------------------------------ #
    # estimator schemes                                                   #
    # ------------------------------------------------------------------ #
    def complete(self, A: np.ndarray, B: np.ndarray = None) -> float:
        """Complete U-statistic U_n: all tuples."""
        k = self.kernel
        if k.kind == "triplet":
            s, c = self._triplet_stats(A, B)
            return s / c
        if k.two_sample:
            s, c = self._pair_stats(A, B)
            return s / c
        ids = np.arange(len(A))
        s, c = self._pair_stats(A, A, ids, ids)  # excludes the diagonal
        return s / c

    def local_average(
        self,
        A: np.ndarray,
        B: np.ndarray = None,
        *,
        n_workers: int,
        seed: int = 0,
        scheme: str = "swor",
        dropped_workers: tuple = (),
    ) -> float:
        """U^loc_N: mean of per-worker complete U over a proportional
        partition; ``dropped_workers`` are left out and the mean
        renormalizes over the survivors."""
        rng = np.random.default_rng(seed)
        return self._local_average_once(
            A, B, n_workers, rng, scheme, dropped_workers
        )

    def _local_average_once(
        self, A, B, n_workers, rng, scheme, dropped_workers=()
    ) -> float:
        k = self.kernel
        alive = survivors(n_workers, dropped_workers)
        vals = []
        # the partition is always drawn over ALL n_workers (a failed
        # worker's data is lost, not redistributed), then dropped entries
        # are skipped: the random stream is the same with and without
        # failures
        if k.kind == "triplet":
            pi, ni = partition_two_sample(len(A), len(B), n_workers, rng, scheme)
            for w in alive:
                s, c = self._triplet_stats(A[pi[w]], B[ni[w]], ids_x=pi[w])
                vals.append(s / c)
        elif k.two_sample:
            pi, ni = partition_two_sample(len(A), len(B), n_workers, rng, scheme)
            for w in alive:
                s, c = self._pair_stats(A[pi[w]], B[ni[w]])
                vals.append(s / c)
        else:
            idx = partition_indices(len(A), n_workers, rng, scheme)
            for w in alive:
                s, c = self._pair_stats(A[idx[w]], A[idx[w]], idx[w], idx[w])
                vals.append(s / c)
        return float(np.mean(vals))

    def repartitioned(
        self,
        A: np.ndarray,
        B: np.ndarray = None,
        *,
        n_workers: int,
        n_rounds: int,
        seed: int = 0,
        scheme: str = "swor",
        dropped_workers: tuple = (),
    ) -> float:
        """U_{N,T}: the mean of T local-average rounds, one reshuffle a
        round; ``dropped_workers`` are left out of every round."""
        rng = np.random.default_rng(seed)
        ests = [
            self._local_average_once(
                A, B, n_workers, rng, scheme, dropped_workers
            )
            for _ in range(n_rounds)
        ]
        return float(np.mean(ests))

    def incomplete(
        self,
        A: np.ndarray,
        B: np.ndarray = None,
        *,
        n_pairs: int,
        seed: int = 0,
        design: str = "swr",
    ) -> float:
        """Incomplete U-statistic over B tuples drawn from the grid:
        ``"swr"`` (with replacement), ``"swor"`` (B distinct tuples) or
        ``"bernoulli"`` (each tuple kept with probability B/|grid|; the
        mean is over the realized count)."""
        k = self.kernel
        rng = np.random.default_rng(seed)
        if k.kind == "triplet":
            i, j, kk = draw_triplet_design(
                rng, len(A), len(B), n_pairs, design
            )
            vals = self.host.triplet_values(A[i], A[j], B[kk])
            return float(np.mean(vals))
        one_sample = not k.two_sample
        n1 = len(A)
        n2 = n1 - 1 if one_sample else len(B)
        i, j = draw_pair_design(rng, n1, n2, n_pairs, design,
                                one_sample=one_sample)
        if one_sample:
            return float(np.mean(self.host.pair_elementwise(A[i], A[j])))
        return float(np.mean(self.host.pair_elementwise(A[i], B[j])))
