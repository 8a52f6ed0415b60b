"""The host C++ backend: the NumPy oracle with a compiled pair loop.

The counterpart of ``tuplewise_tpu.backends.cpp_backend``. It subclasses
``NumpyBackend`` and swaps only the innermost reduction for the compiled
``native/pair_sum.cpp`` engine (-O3, OpenMP over rows, a deterministic
sequential Kahan fold over the rows' partials). This is host code, not a
device kernel: the fast host check of large-n parity runs.

The built-in diff kernels (auc, hinge, logistic), scatter and the two
built-in triplet kernels run in C++ (recognised by the identity of their
bodies); any other kernel runs the inherited numpy path. Without a
working ``g++`` the constructor raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from tuplewise_tpu_torch.backends.base import register_backend
from tuplewise_tpu_torch.backends.numpy_backend import NumpyBackend
from tuplewise_tpu_torch.ops import kernels as K
from tuplewise_tpu_torch.ops.kernels import Kernel, builtin_triplet_spec

# the C++ engine's kernel ids, by the identity of the built-in bodies
_DIFF_FNS = {K._auc_g: 0, K._hinge_g: 1, K._logistic_g: 2}


def _native_triplet_spec(kernel: Kernel):
    """(native id, margin) for the C++ triplet engine, or None for the
    inherited NumPy path. ``ops.kernels.builtin_triplet_spec`` matches
    the body function's identity, never the name, so a custom kernel
    registered under a built-in name never reaches the C++ formula."""
    spec = builtin_triplet_spec(kernel)
    if spec is None:
        return None
    kind, margin = spec
    return {"indicator": 0, "hinge": 1}[kind], margin


def _i64p(x: Optional[np.ndarray]):
    if x is None:
        return None
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _dp(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


@register_backend("cpp")
class CppBackend(NumpyBackend):
    """NumPy-oracle semantics with the pair loop in compiled C++."""

    name = "cpp"

    def __init__(self, kernel: Kernel, block_size: int = 4096, device=None):
        super().__init__(kernel, block_size)
        from tuplewise_tpu_torch.native import load_pair_lib

        self._lib = load_pair_lib()
        if self._lib is None:
            raise RuntimeError(
                "native pair library unavailable (no working g++?); "
                "use backend='numpy' instead"
            )
        # resolved once here so a kernel the native engine can't serve
        # surfaces (as a NumPy fallback) at construction, not mid-estimate
        self._triplet_spec = _native_triplet_spec(self.kernel)

    # The ONLY override: the innermost (sum, count) pair reduction.
    def _pair_stats(
        self,
        A: np.ndarray,
        B: np.ndarray,
        ids_a: Optional[np.ndarray] = None,
        ids_b: Optional[np.ndarray] = None,
    ) -> Tuple[float, int]:
        k = self.kernel
        use_ids = ids_a is not None
        ia = None if not use_ids else np.ascontiguousarray(ids_a, np.int64)
        ib = None if not use_ids else np.ascontiguousarray(ids_b, np.int64)
        out_sum = ctypes.c_double()
        out_count = ctypes.c_int64()

        if k.kind == "diff" and k.diff_fn in _DIFF_FNS:
            a = np.ascontiguousarray(A, np.float64)
            b = np.ascontiguousarray(B, np.float64)
            self._lib.pair_stats_diff(
                _DIFF_FNS[k.diff_fn], _dp(a), len(a), _dp(b), len(b),
                _i64p(ia), _i64p(ib), int(use_ids),
                ctypes.byref(out_sum), ctypes.byref(out_count),
            )
            return out_sum.value, int(out_count.value)

        if k.kind == "pair" and k.pair_fn is K._scatter_h:
            a = np.ascontiguousarray(np.atleast_2d(A), np.float64)
            b = np.ascontiguousarray(np.atleast_2d(B), np.float64)
            self._lib.pair_stats_scatter(
                _dp(a), a.shape[0], _dp(b), b.shape[0], a.shape[1],
                _i64p(ia), _i64p(ib), int(use_ids),
                ctypes.byref(out_sum), ctypes.byref(out_count),
            )
            return out_sum.value, int(out_count.value)

        # unknown/custom kernels: inherited pure-NumPy blockwise path
        return super()._pair_stats(A, B, ids_a, ids_b)

    def _triplet_stats(
        self,
        X: np.ndarray,
        Y: np.ndarray,
        ids_x: Optional[np.ndarray] = None,
    ) -> Tuple[float, int]:
        if self._triplet_spec is None:  # custom triplet kernels: NumPy path
            return super()._triplet_stats(X, Y, ids_x)
        kid, margin = self._triplet_spec
        x = np.ascontiguousarray(np.atleast_2d(X), np.float64)
        y = np.ascontiguousarray(np.atleast_2d(Y), np.float64)
        ids = np.ascontiguousarray(
            np.arange(len(x)) if ids_x is None else ids_x, np.int64
        )
        out_sum = ctypes.c_double()
        out_count = ctypes.c_int64()
        self._lib.triplet_stats_native(
            kid, ctypes.c_double(margin),
            _dp(x), x.shape[0], _dp(y), y.shape[0], x.shape[1],
            _i64p(ids), ctypes.byref(out_sum), ctypes.byref(out_count),
        )
        return out_sum.value, int(out_count.value)
