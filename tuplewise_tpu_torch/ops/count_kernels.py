"""Rank counts of the serving layer: the CUDA kernels of
``csrc/signed_count.cu`` (kernel 6) and ``csrc/tenant_count.cu`` (kernel
7), and their plain PyTorch versions.

The counterpart of the flat half of ``tuplewise_tpu.ops.pallas_counts``
(``flat_signed_count_fn``), with its value contract: up to 8 sorted
float32 runs, each with a sign (+1 for a base or delta run, -1 for a
tombstone multiset) and a query set (0 or 1), and two query vectors;
the result is one int32 block [4, max(len(qa), len(qb))] with rows
(less_a, leq_a, less_b, leq_b)::

    out[2 a_r    ][i] += s_r * #{v in run_r : v <  q_{a_r}[i]}
    out[2 a_r + 1][i] += s_r * #{v in run_r : v <= q_{a_r}[i]}

and 0 in the columns past a query set's length. +inf padding of a run
counts 0 for finite queries. The queries are not padded to a bucket.

Dispatch. A CPU tensor takes :func:`signed_count_plain`; a CUDA tensor
launches the kernel, or raises: nothing falls back from a kernel that
fails to build or launch. The plain version counts by tiled comparison,
the TPU kernel's own arithmetic, so it does not depend on sortedness;
the kernel searches: each (query, run) cell takes its first cut from the
run's top (``SIGNED_TOP_LEVELS``: 2^8 - 1 splitters a block loads into
shared memory at once), then rounds in which ``SIGNED_LANES`` lanes load
one splitter each, for the lower and the upper bound side by side:
:func:`signed_rounds` gives its chain of dependent loads. Both give the
same integers, and so does the ``torch.searchsorted`` route of
``parallel.sharded_counts`` at every query that is not NaN (a NaN query
counts 0 here and the whole run there).

The fleet's tenant-axis count (:func:`tenant_count`, kernel 7) is the
counterpart of ``tenant_signed_count_local_fn``: per tenant row t, the
queries ``qn[t]`` against the sorted row ``neg_pack[t]`` and ``qp[t]``
against ``pos_pack[t]``, one int32 block [4, T, q] with rows (less_n,
leq_n, less_p, leq_p). The rows are +inf padded; the two packs may have
different row lengths. Its dispatch is the same. The kernel takes the
top ``TENANT_TOP_LEVELS`` halvings of a row's search from shared memory
and the rest ``TENANT_LEVELS`` a round of loads, the lower and upper
bounds in one descent: :func:`tenant_rounds` gives its chain of
dependent loads.

``LAUNCHES["signed_count[flat]"]`` and ``LAUNCHES["tenant_count"]`` (the
counter of ``ops.pair_kernels``) count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tuplewise_tpu_torch.ops.pair_kernels import LAUNCHES

_SOURCE = "signed_count.cu"
MAX_RUNS = 8
# kernel 6's search (csrc/signed_count.cu kTopLevels and kLanes, checked
# against the built library): a run's top holds 2^SIGNED_TOP_LEVELS - 1
# splitters; below it a round loads SIGNED_LANES splitters at once for each
# bound
SIGNED_TOP_LEVELS, SIGNED_LANES = 8, 16
# int32 counts stay exact while the runs hold fewer values than this
_COUNT_LIMIT = 1 << 31
# element budget of one plain comparison tile [run rows, queries]
_PLAIN_TILE_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}


def _check(runs, signs, sets, qa, qb) -> None:
    if not (len(runs) == len(signs) == len(sets)):
        raise ValueError("runs, signs and sets must have one entry per run")
    if len(runs) > MAX_RUNS:
        raise ValueError(f"at most {MAX_RUNS} runs a call, got {len(runs)}")
    for t in (qa, qb, *runs):
        if t.device != qa.device:
            raise ValueError(f"tensors on {qa.device} and {t.device}")
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError("runs and queries are 1-D float32 tensors, got "
                            f"{t.dtype} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("runs and queries must be contiguous")
    if any(s not in (1, -1) for s in signs):
        raise ValueError(f"signs must be +1 or -1, got {list(signs)}")
    if any(a not in (0, 1) for a in sets):
        raise ValueError(f"query sets must be 0 or 1, got {list(sets)}")
    if sum(r.numel() for r in runs) >= _COUNT_LIMIT:
        raise ValueError("the runs hold 2^31 values or more: int32 counts "
                         "would overflow")


def signed_count_plain(runs: Sequence[torch.Tensor], signs: Sequence[int],
                       sets: Sequence[int], qa: torch.Tensor,
                       qb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`signed_count`: tiled comparison counting on
    the runs' device (same shapes and integers)."""
    _check(runs, signs, sets, qa, qb)
    qs = (qa, qb)
    qcols = max(len(qa), len(qb))
    out = torch.zeros((4, qcols), dtype=torch.int64, device=qa.device)
    budget = _PLAIN_TILE_ELEMS["cuda" if qa.is_cuda else "cpu"]
    for run, s, a in zip(runs, signs, sets):
        q = qs[a]
        if len(q) == 0:
            continue
        rows = max(1, budget // len(q))
        for r0 in range(0, len(run), rows):
            col = run[r0:r0 + rows, None]
            out[2 * a, :len(q)] += s * (col < q[None]).sum(0)
            out[2 * a + 1, :len(q)] += s * (col <= q[None]).sum(0)
    return out.to(torch.int32)


def signed_rounds(length: int) -> int:
    """Dependent load rounds of kernel 6's search of a run of ``length``
    values: one for the block's top (its first cut then comes from shared
    memory), and one for each cut into SIGNED_LANES + 1 parts until the window of the bound is empty. The lower and upper
    bounds search side by side, so a tie adds none."""
    if length <= 0:
        return 0
    parts = SIGNED_LANES + 1
    # the candidates of the bound after the top's cut, at most
    left = -(-(int(length) + 1) // (1 << SIGNED_TOP_LEVELS))
    rounds = 1
    while left > 1:
        left = -(-left // parts)
        rounds += 1
    return rounds


def load_library():
    """Build (at first use) and load the signed-count library."""
    from tuplewise_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_tw_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tw_signed_count.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            i, p, i, p, i, p, i, p]
        lib.tw_signed_count.restype = i
        for name in ("max_runs", "top_levels", "lanes"):
            getattr(lib, f"tw_signed_count_{name}").restype = i
        built = (lib.tw_signed_count_max_runs(),
                 lib.tw_signed_count_top_levels(),
                 lib.tw_signed_count_lanes())
        want = (MAX_RUNS, SIGNED_TOP_LEVELS, SIGNED_LANES)
        if built != want:
            raise RuntimeError(f"{_SOURCE} was built with (runs, top levels,"
                               f" lanes) {built}, the launcher expects "
                               f"{want}")
        lib._tw_typed = True
    return lib


def _launch(runs, signs, sets, qa, qb) -> torch.Tensor:
    qcols = max(len(qa), len(qb))
    out = torch.empty((4, qcols), dtype=torch.int32, device=qa.device)
    if qcols == 0:
        return out
    lib = load_library()
    k = len(runs)
    ptrs = (ctypes.c_ulonglong * k)(*(r.data_ptr() for r in runs))
    lens = (ctypes.c_longlong * k)(*(r.numel() for r in runs))
    c_signs = (ctypes.c_int * k)(*signs)
    c_sets = (ctypes.c_int * k)(*sets)
    with torch.cuda.device(qa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_signed_count(ptrs, lens, c_signs, c_sets, k,
                                  qa.data_ptr(), len(qa), qb.data_ptr(),
                                  len(qb), out.data_ptr(), qcols, stream)
    if err != 0:
        raise RuntimeError(
            f"signed_count CUDA launch failed: cudaError {err} (k={k}, "
            f"la={len(qa)}, lb={len(qb)})")
    LAUNCHES["signed_count[flat]"] += 1
    return out


def signed_count(runs: Sequence[torch.Tensor], signs: Sequence[int],
                 sets: Sequence[int], qa: torch.Tensor,
                 qb: torch.Tensor) -> torch.Tensor:
    """The fused signed counts of the module docstring, as an int32
    tensor [4, max(len(qa), len(qb))] on the queries' device.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`signed_count_plain`."""
    _check(runs, signs, sets, qa, qb)
    if qa.is_cuda:
        return _launch(runs, signs, sets, qa, qb)
    return signed_count_plain(runs, signs, sets, qa, qb)


# --------------------------------------------------------------------- #
# tenant-axis counts of the fleet (kernel 7)                             #
# --------------------------------------------------------------------- #

_TENANT_SOURCE = "tenant_count.cu"
# kernel 7's search (csrc/tenant_count.cu kTopLevels and kLevels, checked
# against the built library): the halvings of a row's search that a block
# reads from shared memory after one round of loads, and the halvings a
# round below them
TENANT_TOP_LEVELS, TENANT_LEVELS = 5, 2
# one block row of the kernel's grid a tenant row
_MAX_TENANT_ROWS = 65535


def tenant_rounds(cap: int) -> int:
    """Dependent load rounds of kernel 7's lower bound in a row of cap
    values: one for the block's top ``TENANT_TOP_LEVELS`` halvings, the
    other ceil(log2 cap) halvings ``TENANT_LEVELS`` a round, and a last
    round; the upper bound adds none unless the query equals the value at
    the lower bound."""
    if cap <= 0:
        return 0
    below = max(0, (int(cap) - 1).bit_length() - TENANT_TOP_LEVELS)
    return 2 + -(-below // TENANT_LEVELS)


def _check_tenant(pos_pack, neg_pack, qn, qp) -> None:
    for t in (pos_pack, neg_pack, qn, qp):
        if t.device != qn.device:
            raise ValueError(f"tensors on {qn.device} and {t.device}")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError("packs and query blocks are 2-D float32 "
                            f"tensors, got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("packs and query blocks must be contiguous")
    rows = {pos_pack.shape[0], neg_pack.shape[0], qn.shape[0], qp.shape[0]}
    if len(rows) != 1:
        raise ValueError("packs and query blocks must have one row per "
                         f"tenant slot, got {sorted(rows)} rows")
    if qn.shape != qp.shape:
        raise ValueError(f"query blocks of shapes {tuple(qn.shape)} and "
                         f"{tuple(qp.shape)}")
    if max(pos_pack.shape[1], neg_pack.shape[1]) >= _COUNT_LIMIT:
        raise ValueError("a pack row holds 2^31 values or more: int32 "
                         "counts would overflow")


def tenant_count_plain(pos_pack: torch.Tensor, neg_pack: torch.Tensor,
                       qn: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`tenant_count`: tiled comparison counting (the
    TPU kernel's arithmetic) on the packs' device, same shapes and
    integers."""
    _check_tenant(pos_pack, neg_pack, qn, qp)
    T, qb = qn.shape
    out = torch.zeros((4, T, qb), dtype=torch.int64, device=qn.device)
    budget = _PLAIN_TILE_ELEMS["cuda" if qn.is_cuda else "cpu"]
    if qb == 0:
        return out.to(torch.int32)
    for row, pack, q in ((0, neg_pack, qn), (2, pos_pack, qp)):
        cap = pack.shape[1]
        ctile = max(1, min(cap, budget // qb))
        trows = max(1, budget // (qb * ctile))
        for t0 in range(0, T, trows):
            qq = q[t0:t0 + trows, :, None]
            for c0 in range(0, cap, ctile):
                vals = pack[t0:t0 + trows, None, c0:c0 + ctile]
                out[row, t0:t0 + trows] += (vals < qq).sum(2)
                out[row + 1, t0:t0 + trows] += (vals <= qq).sum(2)
    return out.to(torch.int32)


def load_tenant_library():
    """Build (at first use) and load the tenant-count library."""
    from tuplewise_tpu_torch.ops import _build

    lib = _build.load(_TENANT_SOURCE)
    if not getattr(lib, "_tw_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tw_tenant_count.argtypes = [p, ll, p, ll, p, p, i, i, p, p]
        lib.tw_tenant_count.restype = i
        lib.tw_tenant_levels.restype = i
        lib.tw_tenant_top_levels.restype = i
        built = (lib.tw_tenant_top_levels(), lib.tw_tenant_levels())
        if built != (TENANT_TOP_LEVELS, TENANT_LEVELS):
            raise RuntimeError(f"{_TENANT_SOURCE} was built with halvings "
                               f"{built}, the launcher expects "
                               f"{(TENANT_TOP_LEVELS, TENANT_LEVELS)}")
        lib._tw_typed = True
    return lib


def _launch_tenant(pos_pack, neg_pack, qn, qp) -> torch.Tensor:
    T, qb = qn.shape
    if T > _MAX_TENANT_ROWS:
        raise ValueError(f"T={T} tenant rows are beyond the CUDA grid of "
                         f"the tenant count (at most {_MAX_TENANT_ROWS})")
    out = torch.empty((4, T, qb), dtype=torch.int32, device=qn.device)
    if T * qb == 0:
        return out
    lib = load_tenant_library()
    with torch.cuda.device(qn.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_tenant_count(
            neg_pack.data_ptr(), neg_pack.shape[1], pos_pack.data_ptr(),
            pos_pack.shape[1], qn.data_ptr(), qp.data_ptr(), T, qb,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"tenant_count CUDA launch failed: cudaError {err} (T={T}, "
            f"qb={qb}, cap_n={neg_pack.shape[1]}, cap_p={pos_pack.shape[1]})")
    LAUNCHES["tenant_count"] += 1
    return out


def tenant_count(pos_pack: torch.Tensor, neg_pack: torch.Tensor,
                 qn: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """The fleet's tenant-axis counts of the module docstring, as an
    int32 tensor [4, T, q] on the queries' device: rows (less_n, leq_n,
    less_p, leq_p), row t of each counting slot t's queries against its
    own pack row.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`tenant_count_plain`."""
    _check_tenant(pos_pack, neg_pack, qn, qp)
    if qn.is_cuda:
        return _launch_tenant(pos_pack, neg_pack, qn, qp)
    return tenant_count_plain(pos_pack, neg_pack, qn, qp)
