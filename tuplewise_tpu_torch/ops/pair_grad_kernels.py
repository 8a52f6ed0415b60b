"""Pairwise-loss gradient sums for score-difference kernels: the CUDA
kernels (the hinge body's sort-and-search route in ``csrc/rank_count.cu``,
the logistic body's pair sweep in ``csrc/pair_grad.cu``) and their plain
PyTorch versions.

The counterpart of ``tuplewise_tpu.ops.pallas_pairs``'s gradient kernels
(``pallas_pair_loss_grad``, ``pallas_pair_grad_sums``), with the same
value contracts, d_ij = a_i - b_j:

* ``pair_loss_grad(a, b)`` -> (loss, row, col): loss = sum_ij g(d_ij),
  row_i = sum_j g'(d_ij), col_j = sum_i g'(d_ij), in one pass;
* ``pair_grad_sums(a, b)`` -> (row, col), no loss.

Inputs are [n] vectors or [W, n] batches of W independent problems (the
workers of a training step, or seeds x workers); row and col come back
in the inputs' shapes as float32, the loss as float64 of shape [] or
[W]. Both routes give the same row and col for the loss+grad and the
grad-only call, so whether a step records its loss never changes the
step's gradient.

Dispatch, as in ``ops.pair_kernels``: a tensor on the CPU takes the
plain version, a CUDA tensor launches the kernel or raises (nothing falls
back): the hinge body's g' is -1 or 0, so its row and col are counts,
which ``rank_count.hinge_grad`` takes by sorting tiles of each side and
searching them with the body's float32 predicate, and its loss a float64
suffix sum; the logistic body sweeps every pair in ``pair_grad.cu``,
with the factored exponential and polynomial log1p of ``pair_kernels``'s
logistic sum (``LOGISTIC_SPAN``, ``LOG1P_COEFFS``) and one reciprocal
for g' (g' = -(d >= 0 ? u : 1) / (1 + u), u = e^{-|d|}). And ``impl="plain"`` is the one explicit route to the plain
version on the card. A diff kernel with a ``diff_grad_fn`` but no CUDA
body (a user-registered kernel) runs the plain version on every device;
a kernel without ``diff_grad_fn`` (auc) raises ``ValueError``. Launches
count in ``pair_kernels.LAUNCHES`` under ``"pair_loss_grad[<kernel>]"``
and ``"pair_grad_sums[<kernel>]"``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tuplewise_tpu_torch.ops import rank_count
from tuplewise_tpu_torch.ops.kernels import HINGE_BODY, Kernel
from tuplewise_tpu_torch.ops.pair_kernels import (
    LAUNCHES, LOG1P_COEFFS, LOGISTIC_SPAN, _MAX_GRID_YZ, check_tensors,
    plain_tile, use_kernel,
)

_SOURCE = "pair_grad.cu"
# blocks the grid should hold to fill the card: the wrapper cuts the
# column tiles into segments until (row tiles x segments x W) reaches it
# (132 SMs x 16 blocks: enough waves that the last one costs little)
_TARGET_BLOCKS = 132 * 16


def _check_kernel(kernel: Kernel) -> None:
    if kernel.kind != "diff" or kernel.diff_grad_fn is None:
        raise ValueError(
            f"gradient pair sums need a diff kernel with diff_grad_fn, got "
            f"{kernel.name!r} (kind={kernel.kind})"
        )


# --------------------------------------------------------------------- #
# plain versions                                                         #
# --------------------------------------------------------------------- #

def _plain(a, b, kernel: Kernel, with_loss: bool):
    """Tiled sweep over [W, n1] x [W, n2]: float64 sums of float32
    values, row and col returned as float32."""
    squeeze = a.dim() == 1
    if squeeze:
        a, b = a[None], b[None]
    W, n1 = a.shape
    n2 = b.shape[1]
    rows, cols = plain_tile(a, n2)
    row = torch.zeros(W, n1, dtype=torch.float64, device=a.device)
    col = torch.zeros(W, n2, dtype=torch.float64, device=a.device)
    loss = torch.zeros(W, dtype=torch.float64, device=a.device)
    for j0 in range(0, n2, cols):
        bj = b[:, None, j0:j0 + cols]
        for i0 in range(0, n1, rows):
            d = a[:, i0:i0 + rows, None] - bj
            t = kernel.diff_grad_fn(d)
            row[:, i0:i0 + rows] += t.sum(dim=2, dtype=torch.float64)
            col[:, j0:j0 + cols] += t.sum(dim=1, dtype=torch.float64)
            if with_loss:
                loss += kernel.diff(d).sum(dim=(1, 2), dtype=torch.float64)
    row, col = row.to(torch.float32), col.to(torch.float32)
    if squeeze:
        row, col, loss = row[0], col[0], loss[0]
    return (loss, row, col) if with_loss else (row, col)


def pair_loss_grad_plain(a, b, kernel: Kernel):
    """Plain PyTorch ``pair_loss_grad`` (same shapes and value contract)."""
    _check_kernel(kernel)
    return _plain(a, b, kernel, with_loss=True)


def pair_grad_sums_plain(a, b, kernel: Kernel):
    """Plain PyTorch ``pair_grad_sums`` (same shapes and value contract)."""
    _check_kernel(kernel)
    return _plain(a, b, kernel, with_loss=False)


# --------------------------------------------------------------------- #
# CUDA launch                                                            #
# --------------------------------------------------------------------- #

def load_library():
    """Build (at first use) and load the gradient pair library."""
    from tuplewise_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_tw_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tw_pair_grad.argtypes = [p, p, p, p, p, p, p, p, ll, ll,
                                     i, i, i, i, i, p]
        lib.tw_pair_grad.restype = i
        lib.tw_grad_tile_a.restype = i
        lib.tw_grad_tile_b.restype = i
        lib.tw_grad_logistic_span.restype = ctypes.c_float
        lib.tw_grad_log1p_coef.argtypes = [i]
        lib.tw_grad_log1p_coef.restype = ctypes.c_float
        lib.tile_a, lib.tile_b = lib.tw_grad_tile_a(), lib.tw_grad_tile_b()
        built = (lib.tw_grad_logistic_span(),
                 tuple(lib.tw_grad_log1p_coef(j)
                       for j in range(len(LOG1P_COEFFS))))
        want = (LOGISTIC_SPAN,
                tuple(ctypes.c_float(c).value for c in LOG1P_COEFFS))
        if built != want:
            raise RuntimeError(f"{_SOURCE} was built with logistic "
                               f"constants {built}, the launcher expects "
                               f"{want}")
        lib._tw_typed = True
    return lib


def grid_shape(n1: int, n2: int, W: int, tile_a: int, tile_b: int):
    """(gx row tiles, gs column segments, column tiles per segment) of
    the launch: segments are added until the grid reaches
    ``_TARGET_BLOCKS``, and none is empty."""
    gx, gy = -(-n1 // tile_a), -(-n2 // tile_b)
    gs = min(gy, max(1, -(-_TARGET_BLOCKS // (gx * W))))
    per_seg = -(-gy // gs)
    return gx, -(-gy // per_seg), per_seg


def scratch_bytes(n1: int, n2: int, W: int = 1, with_loss: bool = True,
                  tile_a: int = 2048, tile_b: int = 1024) -> int:
    """Bytes of partials one launch allocates (defaults: the compiled
    tile sizes of ``csrc/pair_grad.cu``)."""
    gx, gs, _ = grid_shape(n1, n2, W, tile_a, tile_b)
    return W * (4 * (gs * n1 + gx * n2) + (8 * gs * gx if with_loss else 0))


def _launch(name, a, b, kernel: Kernel, with_loss: bool):
    squeeze = a.dim() == 1
    if squeeze:
        a, b = a[None], b[None]
    check_tensors(a, b)
    W, n1 = a.shape
    n2 = b.shape[1]
    if n1 and n2 and W and kernel.cuda_body == HINGE_BODY:
        loss, row, col = rank_count.hinge_grad(a, b, with_loss)
        LAUNCHES[f"{name}[{kernel.name}]"] += 1
    else:
        loss, row, col = _launch_sweep(name, a, b, kernel, with_loss)
    if squeeze:
        row, col = row[0], col[0]
        loss = None if loss is None else loss[0]
    return (loss, row, col) if with_loss else (row, col)


def _launch_sweep(name, a, b, kernel: Kernel, with_loss: bool):
    """The pair sweep of ``csrc/pair_grad.cu`` (the logistic body): (loss
    or None, row, col) for [W, n1] x [W, n2]."""
    W, n1 = a.shape
    n2 = b.shape[1]
    dev = a.device
    # an empty side sums nothing; otherwise the reduction writes every entry
    alloc = torch.empty if n1 and n2 and W else torch.zeros
    row = alloc(W, n1, dtype=torch.float32, device=dev)
    col = alloc(W, n2, dtype=torch.float32, device=dev)
    loss = alloc(W, dtype=torch.float64, device=dev) if with_loss else None
    if n1 and n2 and W:
        lib = load_library()
        gx, gs, per_seg = grid_shape(n1, n2, W, lib.tile_a, lib.tile_b)
        if W > _MAX_GRID_YZ or gs > _MAX_GRID_YZ or n1 >= 1 << 31 \
                or n2 >= 1 << 31:
            raise ValueError(
                f"W={W}, n1={n1}, n2={n2} exceed the CUDA grid: at most "
                f"{_MAX_GRID_YZ} problems and 2^31 - 1 scores a side"
            )
        rowpart = torch.empty(W, gs, n1, dtype=torch.float32, device=dev)
        colpart = torch.empty(W, gx, n2, dtype=torch.float32, device=dev)
        losspart = (torch.empty(W, gs, gx, dtype=torch.float64, device=dev)
                    if with_loss else None)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.tw_pair_grad(
                a.data_ptr(), b.data_ptr(), rowpart.data_ptr(),
                colpart.data_ptr(),
                losspart.data_ptr() if with_loss else None,
                row.data_ptr(), col.data_ptr(),
                loss.data_ptr() if with_loss else None,
                n1, n2, W, gs, per_seg, kernel.cuda_body, int(with_loss),
                stream,
            )
        if err != 0:
            raise RuntimeError(
                f"{name} CUDA launch failed: cudaError {err} "
                f"(W={W}, n1={n1}, n2={n2}, kernel={kernel.name})"
            )
        LAUNCHES[f"{name}[{kernel.name}]"] += 1
    return loss, row, col


def _dispatch(name, a, b, kernel: Kernel, impl: Optional[str],
              with_loss: bool):
    _check_kernel(kernel)
    if use_kernel(a, kernel, impl):
        return _launch(name, a, b, kernel, with_loss)
    return _plain(a, b, kernel, with_loss)


def pair_loss_grad(a, b, kernel: Kernel, impl: Optional[str] = None):
    """(loss_sum float64, row, col) over the full grid in one pass, for
    [n] or [W, n] float32 inputs; count = n1 * n2.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    ``pair_loss_grad_plain``; ``impl="plain"`` forces the plain version."""
    return _dispatch("pair_loss_grad", a, b, kernel, impl, with_loss=True)


def pair_grad_sums(a, b, kernel: Kernel, impl: Optional[str] = None):
    """(row, col) g' sums over the full grid, no loss; dispatch as in
    :func:`pair_loss_grad`. Row and col equal ``pair_loss_grad``'s."""
    return _dispatch("pair_grad_sums", a, b, kernel, impl, with_loss=False)
