"""Complete-U pair sums for score-difference kernels: the CUDA kernels of
``csrc/pair_sum.cu`` and their plain PyTorch versions.

The counterpart of ``tuplewise_tpu.ops.pallas_pairs`` (``pallas_pair_sum``,
``pallas_masked_pair_sum``, ``pallas_pair_sum_any``), with the same value
contracts:

* ``pair_sum(a, b)``: sum of g(a_i - b_j) over the full grid; the count
  is n1 * n2, which the caller forms as a Python int.
* ``masked_pair_sum(a, b, ma, mb)``: sum of g(a_i - b_j) * ma_i * mb_j;
  the caller recovers the count as sum(ma) * sum(mb).
* ``pair_sum_any``: the any-size unmasked sum. The CUDA kernel masks the
  ragged edge itself, so this is ``pair_sum``.

Inputs are [n] vectors or [W, n] batches of W independent problems
(workers of a local round, Monte-Carlo reps); the result is a float64
tensor of shape [] or [W].

Dispatch. A tensor on the CPU takes the plain version. A CUDA tensor
launches the kernel, or raises: nothing falls back from a kernel that
fails to build or launch. The auc and hinge bodies run the
sort-and-count kernels of ``csrc/rank_count.cu`` (``ops.rank_count``):
unmasked, for the auc an exact int64 ``2 * wins + ties`` a problem,
halved in float64, for the hinge the float64 sum c (1 - a_i) + (the
suffix sum of the sorted b where fl(a_i - b) < 1) over a_i and tiles of
b; masked, the same searches over tiles of b sorted with their weights,
each a_i adding ma_i times the suffix sums of the weights past its
searches (auc) or ma_i ((1 - a_i) W + S) with W and S the suffix sums of
mb and mb * b (hinge). The logistic body, masked or not, runs
``csrc/pair_sum.cu``, which
factors e^{-|d|} into per-score exponentials where a block's scores span
at most ``LOGISTIC_SPAN`` and takes log1p as a polynomial
(``LOG1P_COEFFS``; :func:`logistic_branch_blocks` counts the blocks of
each branch). ``impl="plain"`` is the one
explicit route to the plain version on the card (the counterpart of the
JAX ``impl="xla"``).
A diff kernel without a CUDA body (a user-registered kernel) runs the
plain tiled version on every device.

``LAUNCHES`` counts kernel launches per ``"<wrapper>[<kernel name>]"``:
a wrapper adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from tuplewise_tpu_torch.ops import rank_count
from tuplewise_tpu_torch.ops.kernels import AUC_BODY, HINGE_BODY, Kernel

LAUNCHES: collections.Counter = collections.Counter()

_SOURCE = "pair_sum.cu"
_MAX_GRID_YZ = 65535
# the logistic kernel's compile-time constants (csrc/pair_sum.cu, checked
# against the built library in load_library): the widest score range of a
# block that takes the factored exponential, and the coefficients of
# log1p(x) = s * P(s^2), s = x / (2 + x), P(z) = sum_i c_i z^i
LOGISTIC_SPAN = 80.0
LOG1P_COEFFS = (2.0, 0.6666631698608398, 0.4002491533756256,
                0.27960577607154846, 0.2817831039428711)
# element budget of one plain tile [W, rows, cols]: bounds the plain
# version's temporaries (float32) to 4 * budget bytes each
_PLAIN_TILE_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _check_kernel(kernel: Kernel) -> None:
    if kernel.kind != "diff":
        raise ValueError(
            f"pair sums handle diff kernels only, got {kernel.name!r} "
            f"(kind={kernel.kind})"
        )


# --------------------------------------------------------------------- #
# plain versions                                                         #
# --------------------------------------------------------------------- #

def plain_tile(a, n2: int):
    """(rows, cols) of one plain tile [W, rows, cols] over a [W, n1] x
    [W, n2] grid, within the device's element budget."""
    W, n1 = a.shape
    budget = _PLAIN_TILE_ELEMS["cuda" if a.is_cuda else "cpu"]
    cols = max(1, min(n2, budget // max(W, 1)))
    return max(1, min(n1, budget // (max(W, 1) * cols))), cols


def _plain(a, b, ma, mb, kernel: Kernel) -> torch.Tensor:
    """Tiled sum over [W, n1] x [W, n2]; float32 values, float64 sums."""
    squeeze = a.dim() == 1
    if squeeze:
        a, b = a[None], b[None]
        ma = None if ma is None else ma[None]
        mb = None if mb is None else mb[None]
    W, n1 = a.shape
    n2 = b.shape[1]
    rows, cols = plain_tile(a, n2)
    total = torch.zeros(W, dtype=torch.float64, device=a.device)
    for j0 in range(0, n2, cols):
        bj = b[:, None, j0:j0 + cols]
        for i0 in range(0, n1, rows):
            vals = kernel.diff(a[:, i0:i0 + rows, None] - bj)
            if mb is not None:
                vals = vals * mb[:, None, j0:j0 + cols]
            if ma is not None:
                vals = vals * ma[:, i0:i0 + rows, None]
            total += vals.sum(dim=(1, 2), dtype=torch.float64)
    return total[0] if squeeze else total


def pair_sum_plain(a, b, kernel: Kernel) -> torch.Tensor:
    """Plain PyTorch ``pair_sum`` (same shapes and value contract)."""
    _check_kernel(kernel)
    return _plain(a, b, None, None, kernel)


def masked_pair_sum_plain(a, b, ma, mb, kernel: Kernel) -> torch.Tensor:
    """Plain PyTorch ``masked_pair_sum`` (same shapes and value contract)."""
    _check_kernel(kernel)
    return _plain(a, b, ma, mb, kernel)


# --------------------------------------------------------------------- #
# CUDA launch                                                            #
# --------------------------------------------------------------------- #

def load_library():
    """Build (at first use) and load the pair-sum library."""
    from tuplewise_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_tw_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tw_pair_sum.argtypes = [p, p, p, p, p, ll, ll, i, i, i, p, p]
        lib.tw_pair_sum.restype = i
        lib.tw_pair_tile_a.restype = i
        lib.tw_pair_tile_b.restype = i
        lib.tw_pair_logistic_span.restype = ctypes.c_float
        lib.tw_pair_log1p_coef.argtypes = [i]
        lib.tw_pair_log1p_coef.restype = ctypes.c_float
        # compile-time tile sizes, read once
        lib.tile_a, lib.tile_b = lib.tw_pair_tile_a(), lib.tw_pair_tile_b()
        built = (lib.tw_pair_logistic_span(),
                 tuple(lib.tw_pair_log1p_coef(j)
                       for j in range(len(LOG1P_COEFFS))))
        want = (LOGISTIC_SPAN,
                tuple(ctypes.c_float(c).value for c in LOG1P_COEFFS))
        if built != want:
            raise RuntimeError(f"{_SOURCE} was built with logistic "
                               f"constants {built}, the launcher expects "
                               f"{want}")
        lib._tw_typed = True
    return lib


def check_tensors(a, b, *more) -> None:
    """What every CUDA pair kernel takes: a [W, n1] and b [W, n2] (and
    any more tensors), contiguous float32 on one device."""
    for t in (a, b, *more):
        if t.device != a.device:
            raise ValueError(f"tensors on {a.device} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA pair kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA pair kernel takes contiguous tensors")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(
            f"expected a [W, n1] and b [W, n2], got {tuple(a.shape)} and "
            f"{tuple(b.shape)}"
        )


def use_kernel(a, kernel: Kernel, impl: Optional[str]) -> bool:
    """True where a wrapper launches its CUDA kernel: a CUDA tensor, a
    kernel with a CUDA body, and no ``impl="plain"``."""
    if impl not in (None, "kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    return a.is_cuda and impl != "plain" and kernel.cuda_body is not None


def _launch(name, a, b, ma, mb, kernel: Kernel,
            branches: Optional[torch.Tensor] = None) -> torch.Tensor:
    masked = ma is not None
    squeeze = a.dim() == 1
    if squeeze:
        a, b = a[None], b[None]
        ma = None if ma is None else ma[None]
        mb = None if mb is None else mb[None]
    check_tensors(a, b, *((ma, mb) if masked else ()))
    if masked and (ma.shape != a.shape or mb.shape != b.shape):
        raise ValueError("masks must have the shapes of their scores")
    W, n1 = a.shape
    n2 = b.shape[1]
    if n1 == 0 or n2 == 0 or W == 0:
        out = torch.zeros(W, dtype=torch.float64, device=a.device)
        return out[0] if squeeze else out
    if kernel.cuda_body in (AUC_BODY, HINGE_BODY):
        # sort-and-count: an exact int64 2 * wins + ties a problem (auc),
        # sort-and-search with float64 suffix sums (hinge); masked, the
        # suffix sums of the sorted weights
        if masked:
            out = rank_count.masked_pair_sums(
                a, b, ma, mb, hinge=kernel.cuda_body == HINGE_BODY)
        elif kernel.cuda_body == AUC_BODY:
            out = rank_count.auc_twice_counts(a, b).to(torch.float64) * 0.5
        else:
            out = rank_count.hinge_pair_sums(a, b)
        LAUNCHES[f"{name}[{kernel.name}]"] += 1
        return out[0] if squeeze else out
    lib = load_library()
    gx, gy = -(-n1 // lib.tile_a), -(-n2 // lib.tile_b)
    if gy > _MAX_GRID_YZ or W > _MAX_GRID_YZ:
        raise ValueError(
            f"n2={n2} needs {gy} column tiles and W={W} problems; the CUDA "
            f"grid takes at most {_MAX_GRID_YZ} of each"
        )
    partials = torch.empty((W, gy, gx), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_pair_sum(
            a.data_ptr(), b.data_ptr(),
            ma.data_ptr() if masked else None,
            mb.data_ptr() if masked else None,
            partials.data_ptr(), n1, n2, W, kernel.cuda_body, int(masked),
            None if branches is None else branches.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} CUDA launch failed: cudaError {err} "
            f"(W={W}, n1={n1}, n2={n2}, kernel={kernel.name})"
        )
    LAUNCHES[f"{name}[{kernel.name}]"] += 1
    out = partials.to(torch.float64).sum(dim=(1, 2))
    return out[0] if squeeze else out


def _dispatch(name, a, b, ma, mb, kernel: Kernel, impl: Optional[str]):
    _check_kernel(kernel)
    if use_kernel(a, kernel, impl):
        return _launch(name, a, b, ma, mb, kernel)
    return _plain(a, b, ma, mb, kernel)


def pair_sum(a, b, kernel: Kernel, impl: Optional[str] = None):
    """Sum of g(a_i - b_j) over the full grid, for [n] or [W, n] inputs
    (float64 result of shape [] or [W]); count = n1 * n2.

    CUDA tensors launch the CUDA kernel (or raise): the sort-and-count
    kernels of ``csrc/rank_count.cu`` for the auc and hinge bodies,
    ``csrc/pair_sum.cu`` for the logistic; CPU
    tensors take ``pair_sum_plain``; ``impl="plain"`` forces the plain
    version. A kernel without a CUDA body runs the plain tiled version."""
    return _dispatch("pair_sum", a, b, None, None, kernel, impl)


def masked_pair_sum(a, b, ma, mb, kernel: Kernel,
                    impl: Optional[str] = None):
    """Weighted sum of g(a_i - b_j) * ma_i * mb_j for [n] or [W, n]
    inputs and finite weights of either sign; the caller's count is
    sum(ma) * sum(mb). Dispatch as in :func:`pair_sum`."""
    return _dispatch("masked_pair_sum", a, b, ma, mb, kernel, impl)


def logistic_branch_blocks(a, b, ma=None, mb=None):
    """(blocks that took the factored exponential, blocks that took the
    per-pair expf) in one launch of the logistic pair sum (masked when ma
    and mb are given) on CUDA tensors, with its result: ``(factored,
    per_pair, sum)``. The launch counts in ``LAUNCHES`` like any other."""
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    if not a.is_cuda:
        raise ValueError("the logistic kernel's branches exist on the card "
                         "only")
    kernel = get_kernel("logistic")
    counts = torch.zeros(2, dtype=torch.int64, device=a.device)
    name = "pair_sum" if ma is None else "masked_pair_sum"
    out = _launch(name, a, b, ma, mb, kernel, branches=counts)
    factored, per_pair = counts.tolist()
    return factored, per_pair, out


def pair_sum_any(a, b, kernel: Kernel, impl: Optional[str] = None):
    """Any-size unmasked sum (the ``pallas_pair_sum_any`` contract): the
    CUDA kernel takes any size, so this is :func:`pair_sum`."""
    return pair_sum(a, b, kernel, impl)
