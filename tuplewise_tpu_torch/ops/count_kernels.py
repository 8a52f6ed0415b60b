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

The worker axis (the mesh form of serving, the counterpart of
``sharded_signed_count_fn`` and ``tenant_signed_count_fn``) is the one
form each kernel has: :func:`signed_count_mesh` takes each run as an
``[S, cap_r]`` tensor, one contiguous slice a worker, and returns the
per-worker blocks ``[S, 4, qcols]``; :func:`tenant_count_mesh` takes
``[S, T, cap]`` packs and returns ``[S, 4, T, qb]``. One launch covers
every worker; the caller adds the blocks over workers
(``comm.all_reduce_sum``, the TPU kernels' psum). The flat
:func:`signed_count` and :func:`tenant_count` (and their plain versions)
are the worker axis at S = 1. ``MAX_RUNS`` stays a limit a worker. The
int32 blocks stay exact while the values a launch sees are fewer than
2^31 (the wrappers check it; the certified envelopes of
``tuplewise_tpu/analysis/exactness_bounds.toml``, 3 x 2^21 a flat count
and 6291456 a tenant row, lie far below), and the sum over workers,
taken in float64 and read back as int64, is exact too.

``LAUNCHES["signed_count[flat]"]``, ``LAUNCHES["signed_count[mesh]"]``,
``LAUNCHES["tenant_count"]`` and ``LAUNCHES["tenant_count[mesh]"]`` (the
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


def _check(runs, signs, sets, qa, qb) -> int:
    """Checks of kernel 6's arguments on the worker axis; returns the
    worker count S (1 with no runs)."""
    if not (len(runs) == len(signs) == len(sets)):
        raise ValueError("runs, signs and sets must have one entry per run")
    if len(runs) > MAX_RUNS:
        raise ValueError(f"at most {MAX_RUNS} runs a worker, got "
                         f"{len(runs)}")
    for t, dim in ((qa, 1), (qb, 1), *((r, 2) for r in runs)):
        if t.device != qa.device:
            raise ValueError(f"tensors on {qa.device} and {t.device}")
        if t.dtype != torch.float32 or t.dim() != dim:
            raise TypeError("runs are [S, cap] and queries 1-D float32 "
                            f"tensors, got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("runs and queries must be contiguous")
    S = runs[0].shape[0] if runs else 1
    if any(r.shape[0] != S for r in runs) or S < 1:
        raise ValueError("worker-axis runs are [S, cap] tensors of one S >= "
                         f"1, got shapes {[tuple(r.shape) for r in runs]}")
    if any(s not in (1, -1) for s in signs):
        raise ValueError(f"signs must be +1 or -1, got {list(signs)}")
    if any(a not in (0, 1) for a in sets):
        raise ValueError(f"query sets must be 0 or 1, got {list(sets)}")
    if sum(r.numel() for r in runs) >= _COUNT_LIMIT:
        raise ValueError("the runs of all workers hold 2^31 values or more: "
                         "int32 counts would overflow")
    return S


def _plain(runs, signs, sets, qa, qb, S: int) -> torch.Tensor:
    qs = (qa, qb)
    qcols = max(len(qa), len(qb))
    out = torch.zeros((S, 4, qcols), dtype=torch.int64, device=qa.device)
    budget = _PLAIN_TILE_ELEMS["cuda" if qa.is_cuda else "cpu"]
    for run, s, a in zip(runs, signs, sets):
        q = qs[a]
        if len(q) == 0:
            continue
        rows = max(1, budget // (S * len(q)))
        for r0 in range(0, run.shape[1], rows):
            col = run[:, r0:r0 + rows, None]
            out[:, 2 * a, :len(q)] += s * (col < q).sum(1)
            out[:, 2 * a + 1, :len(q)] += s * (col <= q).sum(1)
    return out.to(torch.int32)


def signed_count_mesh_plain(runs: Sequence[torch.Tensor],
                            signs: Sequence[int], sets: Sequence[int],
                            qa: torch.Tensor,
                            qb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`signed_count_mesh`: tiled comparison counting
    on the runs' device (same shapes and integers)."""
    return _plain(runs, signs, sets, qa, qb, _check(runs, signs, sets, qa,
                                                    qb))


def signed_count_plain(runs: Sequence[torch.Tensor], signs: Sequence[int],
                       sets: Sequence[int], qa: torch.Tensor,
                       qb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`signed_count`: :func:`signed_count_mesh_plain`
    at one worker."""
    return signed_count_mesh_plain([r[None] for r in runs], signs, sets, qa,
                                   qb)[0]


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
        lib.tw_signed_count_mesh.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            i, i, p, i, p, i, p, i, p]
        lib.tw_signed_count_mesh.restype = i
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


def _launch(runs, signs, sets, qa, qb, S: int,
            counter: str) -> torch.Tensor:
    qcols = max(len(qa), len(qb))
    out = torch.empty((S, 4, qcols), dtype=torch.int32, device=qa.device)
    if qcols == 0:
        return out
    lib = load_library()
    k = len(runs)
    ptrs = (ctypes.c_ulonglong * k)(*(r.data_ptr() for r in runs))
    lens = (ctypes.c_longlong * k)(*(r.shape[1] for r in runs))
    strides = (ctypes.c_longlong * k)(*(r.stride(0) for r in runs))
    c_signs = (ctypes.c_int * k)(*signs)
    c_sets = (ctypes.c_int * k)(*sets)
    with torch.cuda.device(qa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_signed_count_mesh(
            ptrs, lens, strides, c_signs, c_sets, k, S, qa.data_ptr(),
            len(qa), qb.data_ptr(), len(qb), out.data_ptr(), qcols, stream)
    if err != 0:
        raise RuntimeError(
            f"{counter} CUDA launch failed: cudaError {err} (k={k}, S={S}, "
            f"la={len(qa)}, lb={len(qb)})")
    LAUNCHES[counter] += 1
    return out


def signed_count_mesh(runs: Sequence[torch.Tensor], signs: Sequence[int],
                      sets: Sequence[int], qa: torch.Tensor,
                      qb: torch.Tensor, *,
                      counter: str = "signed_count[mesh]") -> torch.Tensor:
    """Kernel 6 over a worker axis: each run an ``[S, cap_r]`` tensor (row
    w worker w's slice), the queries the same for every worker. Returns
    the per-worker int32 blocks ``[S, 4, max(len(qa), len(qb))]`` on the
    queries' device; their sum over workers is :func:`signed_count` of
    the whole runs. One launch covers every worker, counted in
    ``LAUNCHES[counter]``.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`signed_count_mesh_plain`."""
    S = _check(runs, signs, sets, qa, qb)
    if qa.is_cuda:
        return _launch(runs, signs, sets, qa, qb, S, counter)
    return _plain(runs, signs, sets, qa, qb, S)


def signed_count(runs: Sequence[torch.Tensor], signs: Sequence[int],
                 sets: Sequence[int], qa: torch.Tensor,
                 qb: torch.Tensor) -> torch.Tensor:
    """The fused signed counts of the module docstring, as an int32
    tensor [4, max(len(qa), len(qb))] on the queries' device:
    :func:`signed_count_mesh` at one worker, counted in
    ``LAUNCHES["signed_count[flat]"]``.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`signed_count_plain`."""
    return signed_count_mesh([r[None] for r in runs], signs, sets, qa, qb,
                             counter="signed_count[flat]")[0]


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


def _check_tenant(pos_pack, neg_pack, qn, qp) -> int:
    """Checks of kernel 7's arguments on the worker axis; returns the
    worker count S."""
    for t, dim in ((pos_pack, 3), (neg_pack, 3), (qn, 2), (qp, 2)):
        if t.device != qn.device:
            raise ValueError(f"tensors on {qn.device} and {t.device}")
        if t.dtype != torch.float32 or t.dim() != dim:
            raise TypeError("packs are [S, T, cap] and query blocks [T, q] "
                            f"float32 tensors, got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("packs and query blocks must be contiguous")
    S = pos_pack.shape[0]
    if neg_pack.shape[0] != S or S < 1:
        raise ValueError(f"packs of {S} and {neg_pack.shape[0]} workers")
    rows = {pos_pack.shape[1], neg_pack.shape[1], qn.shape[0], qp.shape[0]}
    if len(rows) != 1:
        raise ValueError("packs and query blocks must have one row per "
                         f"tenant slot, got {sorted(rows)} rows")
    if qn.shape != qp.shape:
        raise ValueError(f"query blocks of shapes {tuple(qn.shape)} and "
                         f"{tuple(qp.shape)}")
    if S * max(pos_pack.shape[2], neg_pack.shape[2]) >= _COUNT_LIMIT:
        raise ValueError("a tenant's rows over all workers hold 2^31 values "
                         "or more: int32 counts would overflow")
    return S


def _tenant_plain(pos_pack, neg_pack, qn, qp, S: int) -> torch.Tensor:
    T, qb = qn.shape
    out = torch.zeros((4, S * T, qb), dtype=torch.int64, device=qn.device)
    budget = _PLAIN_TILE_ELEMS["cuda" if qn.is_cuda else "cpu"]
    for row, pack, q in ((0, neg_pack, qn), (2, pos_pack, qp)):
        if qb == 0:
            break
        cap = pack.shape[2]
        # worker w's slice of slot t is row w T + t, against query row t
        pack, q = pack.reshape(S * T, cap), q.repeat(S, 1)
        ctile = max(1, min(cap, budget // qb))
        trows = max(1, budget // (qb * ctile))
        for t0 in range(0, S * T, trows):
            qq = q[t0:t0 + trows, :, None]
            for c0 in range(0, cap, ctile):
                vals = pack[t0:t0 + trows, None, c0:c0 + ctile]
                out[row, t0:t0 + trows] += (vals < qq).sum(2)
                out[row + 1, t0:t0 + trows] += (vals <= qq).sum(2)
    return out.reshape(4, S, T, qb).transpose(0, 1).to(torch.int32)


def tenant_count_mesh_plain(pos_pack: torch.Tensor, neg_pack: torch.Tensor,
                            qn: torch.Tensor,
                            qp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`tenant_count_mesh`: tiled comparison counting
    (the TPU kernel's arithmetic) on the packs' device, same shapes and
    integers."""
    return _tenant_plain(pos_pack, neg_pack, qn, qp,
                         _check_tenant(pos_pack, neg_pack, qn, qp))


def tenant_count_plain(pos_pack: torch.Tensor, neg_pack: torch.Tensor,
                       qn: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`tenant_count`: :func:`tenant_count_mesh_plain`
    at one worker."""
    return tenant_count_mesh_plain(pos_pack[None], neg_pack[None], qn,
                                   qp)[0]


def load_tenant_library():
    """Build (at first use) and load the tenant-count library."""
    from tuplewise_tpu_torch.ops import _build

    lib = _build.load(_TENANT_SOURCE)
    if not getattr(lib, "_tw_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tw_tenant_count_mesh.argtypes = [p, ll, p, ll, p, p, i, i, i, p,
                                             p]
        lib.tw_tenant_count_mesh.restype = i
        lib.tw_tenant_levels.restype = i
        lib.tw_tenant_top_levels.restype = i
        built = (lib.tw_tenant_top_levels(), lib.tw_tenant_levels())
        if built != (TENANT_TOP_LEVELS, TENANT_LEVELS):
            raise RuntimeError(f"{_TENANT_SOURCE} was built with halvings "
                               f"{built}, the launcher expects "
                               f"{(TENANT_TOP_LEVELS, TENANT_LEVELS)}")
        lib._tw_typed = True
    return lib


def _launch_tenant(pos_pack, neg_pack, qn, qp, S: int,
                   counter: str) -> torch.Tensor:
    T, qb = qn.shape
    if T > _MAX_TENANT_ROWS:
        raise ValueError(f"T={T} tenant rows are beyond the CUDA grid of "
                         f"the tenant count (at most {_MAX_TENANT_ROWS})")
    out = torch.empty((S, 4, T, qb), dtype=torch.int32, device=qn.device)
    if T * qb == 0:
        return out
    lib = load_tenant_library()
    with torch.cuda.device(qn.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_tenant_count_mesh(
            neg_pack.data_ptr(), neg_pack.shape[2], pos_pack.data_ptr(),
            pos_pack.shape[2], qn.data_ptr(), qp.data_ptr(), T, qb, S,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"{counter} CUDA launch failed: cudaError {err} (S={S}, T={T}, "
            f"qb={qb}, cap_n={neg_pack.shape[2]}, cap_p={pos_pack.shape[2]})")
    LAUNCHES[counter] += 1
    return out


def tenant_count_mesh(pos_pack: torch.Tensor, neg_pack: torch.Tensor,
                      qn: torch.Tensor, qp: torch.Tensor, *,
                      counter: str = "tenant_count[mesh]") -> torch.Tensor:
    """Kernel 7 over a worker axis: ``[S, T, cap]`` packs (row [w, t]
    worker w's slice of slot t's run) against the ``[T, qb]`` query
    blocks every worker shares. Returns the per-worker int32 blocks ``[S,
    4, T, qb]``; their sum over workers is :func:`tenant_count` of the
    whole runs. One launch covers every worker, counted in
    ``LAUNCHES[counter]``.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`tenant_count_mesh_plain`."""
    S = _check_tenant(pos_pack, neg_pack, qn, qp)
    if qn.is_cuda:
        return _launch_tenant(pos_pack, neg_pack, qn, qp, S, counter)
    return _tenant_plain(pos_pack, neg_pack, qn, qp, S)


def tenant_count(pos_pack: torch.Tensor, neg_pack: torch.Tensor,
                 qn: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """The fleet's tenant-axis counts of the module docstring, as an
    int32 tensor [4, T, q] on the queries' device: rows (less_n, leq_n,
    less_p, leq_p), row t of each counting slot t's queries against its
    own pack row. :func:`tenant_count_mesh` at one worker, counted in
    ``LAUNCHES["tenant_count"]``.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`tenant_count_plain`."""
    return tenant_count_mesh(pos_pack[None], neg_pack[None], qn, qp,
                             counter="tenant_count")[0]
