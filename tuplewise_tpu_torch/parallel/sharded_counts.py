"""Signed rank counts of sorted runs: the serving index's count layer.

The single-device half of ``tuplewise_tpu.parallel.sharded_counts``. The
serving hot path needs, per micro-batch, for queries q the integer
counts ``less = #{v < q}`` and ``leq = #{v <= q}`` against a signed union
of sorted runs (base runs +1, a tombstone multiset -1). Counting is
additive over runs, so one call sums every run's signed counts:

* ``kernel=True``: one launch of the fused CUDA kernel
  (``ops.count_kernels.signed_count``, kernel 6) on a CUDA device, or
  its plain version on the CPU. No fallback: a kernel that fails to
  build or launch raises.
* ``kernel=None``: the ``torch.searchsorted`` route
  (:func:`signed_count_searchsorted`), two searches per run: the
  counterpart of the JAX package's XLA searchsorted path.

Both give the same integers. A run is either a host array, padded to its
bucket and copied to the device by the call, or a device tensor placed
once by :func:`place_run` and reused until its host copy changes.

The fleet's tenant axis: :func:`place_tenant_pack` keeps every tenant's
sorted base run of one class as a row of one shared +inf-padded
``[T_bucket, cap]`` tensor on the device, re-shipping only the rows of
the slots that changed; :func:`tenant_pack_counts` counts a whole
coalesced multi-tenant micro-batch against both packs in one call, with
``kernel=True`` one launch of kernel 7 (``ops.count_kernels.
tenant_count``) or, with ``kernel=None``, the batched
``torch.searchsorted`` route (:func:`tenant_count_searchsorted`).

The mesh form (runs sharded over devices, one all-reduce) is not ported
yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from tuplewise_tpu_torch.obs.ledger import device_section
from tuplewise_tpu_torch.ops.count_kernels import signed_count, tenant_count
from tuplewise_tpu_torch.utils.device import resolve_device

_MIN_BUCKET = 256


def next_bucket(n: int, min_bucket: int = _MIN_BUCKET) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded counts over a device mesh are not ported to "
            "tuplewise_tpu_torch yet; pass mesh=None")


def place_run(arr: np.ndarray, cap: int, device) -> torch.Tensor:
    """A sorted host run as a float32 tensor of length ``cap`` on
    ``device``, +inf past its values (finite queries never count the
    padding)."""
    out = np.full(cap, np.inf, dtype=np.float32)
    out[: len(arr)] = arr
    return torch.from_numpy(out).to(device)


def signed_count_searchsorted(runs: Sequence[torch.Tensor],
                              signs: Sequence[int], sets: Sequence[int],
                              qa: torch.Tensor,
                              qb: torch.Tensor) -> torch.Tensor:
    """The ``torch.searchsorted`` twin of the fused kernel: per run a
    left and a right search of its query set, summed with the run's sign
    into the same int32 block [4, max(len(qa), len(qb))]."""
    qs = (qa, qb)
    out = torch.zeros((4, max(len(qa), len(qb))), dtype=torch.int32,
                      device=qa.device)
    for run, s, a in zip(runs, signs, sets):
        q = qs[a]
        if len(q) == 0:
            continue
        for row, right in ((2 * a, False), (2 * a + 1, True)):
            c = torch.searchsorted(run, q, right=right, out_int32=True)
            out[row, :len(q)] += s * c
    return out


def signed_pair_counts(mesh, runs_a, runs_b, q_a: np.ndarray,
                       q_b: np.ndarray, dtype=np.float32, *, kernel=None,
                       metrics=None, device=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Signed counts of two query sets in one device call.

    ``runs_a`` / ``runs_b``: sequences of ``(run, cap, sign)`` counted
    against ``q_a`` / ``q_b``: ``run`` a sorted host array (padded here
    to ``cap``) or a placed device tensor of length ``cap``. ``device``:
    where host runs and the queries go (a placed run's own device wins);
    None is the card, and raises where there is none.
    Returns four int64 arrays ``(less_a, leq_a, less_b, leq_b)`` trimmed
    to the query lengths.

    ``kernel``: None takes the searchsorted route; True the fused kernel
    (its plain version on the CPU), counted in ``metrics`` as
    ``count_kernel_calls_total``. Only float32 runs are taken, the
    index's ``engine="torch"`` storage.
    """
    _check_mesh(mesh)
    if np.dtype(dtype) != np.float32:
        raise TypeError(f"device counts take float32 runs, got {dtype}")
    la, lb = len(q_a), len(q_b)
    if not runs_a and not runs_b:
        return (np.zeros(la, np.int64), np.zeros(la, np.int64),
                np.zeros(lb, np.int64), np.zeros(lb, np.int64))
    dev = None
    for run, _, _ in (*runs_a, *runs_b):
        if isinstance(run, torch.Tensor):
            dev = run.device
            break
    dev = resolve_device(device) if dev is None else dev
    tensors, caps, signs, sets = [], [], [], []
    for side, rs in ((0, runs_a), (1, runs_b)):
        for run, cap, sign in rs:
            if not isinstance(run, torch.Tensor):
                run = place_run(np.asarray(run, np.float32), cap, dev)
            tensors.append(run)
            caps.append(cap)
            signs.append(sign)
            sets.append(side)
    key = ("signed_pair", tuple(caps), tuple(signs), tuple(sets),
           kernel is not None)
    with device_section(key) as ds:
        # one host-to-device copy carries both query sets
        q = torch.from_numpy(np.concatenate(
            [np.asarray(q_a, np.float32), np.asarray(q_b, np.float32)]))
        q = q.to(dev)
        qa, qb = q[:la], q[la:]
        if kernel is not None:
            out = signed_count(tensors, signs, sets, qa, qb)
        else:
            out = signed_count_searchsorted(tensors, signs, sets, qa, qb)
        ds.dispatched()
        out = out.cpu().numpy().astype(np.int64)
    if kernel is not None and metrics is not None:
        metrics.counter("count_kernel_calls_total").inc()
    return (out[0, :la], out[1, :la], out[2, :lb], out[3, :lb])


# --------------------------------------------------------------------- #
# tenant axis (the fleet)                                                #
# --------------------------------------------------------------------- #

_MIN_TENANT_BUCKET = 8


def tenant_bucket(n: int, min_bucket: int = _MIN_TENANT_BUCKET) -> int:
    """Tenant-row bucket: the power of two >= n (and >= ``min_bucket``)
    that sizes the packs' T axis."""
    return next_bucket(max(n, 1), min_bucket=min_bucket)


def _count_bytes(metrics, shipped: int, saved: int) -> None:
    if metrics is None:
        return
    if shipped:
        metrics.counter("bytes_h2d").inc(shipped)
    if saved:
        metrics.counter("bytes_h2d_saved").inc(saved)


def _rows_block(runs, slots, cap: int) -> np.ndarray:
    """[len(slots), cap] float32 rows, slot ``slots[i]``'s run in row i,
    +inf past its values (slots past ``len(runs)`` are empty rows)."""
    block = np.full((len(slots), cap), np.inf, dtype=np.float32)
    for i, t in enumerate(slots):
        r = runs[t] if t < len(runs) else ()
        if len(r):
            block[i, : len(r)] = r
    return block


def place_tenant_pack(mesh, runs: Sequence[np.ndarray], t_bucket: int,
                      dtype=np.float32, *, prev=None, dirty=None,
                      metrics=None, device=None
                      ) -> Tuple[torch.Tensor, int, int]:
    """Pack a fleet's sorted runs of one class into one shared padded
    device tensor ``[t_bucket, cap]``.

    ``runs[t]`` is tenant slot t's sorted host run (may be empty; slots
    past ``len(runs)`` are empty rows). ``cap`` is the bucket of the
    longest run, shared by every row; all padding is +inf, so finite
    queries count exactly without masks.

    ``prev``: ``(prev_tensor, prev_cap, prev_t_bucket)`` of the placement
    this one replaces; ``dirty``: the slots whose runs changed since it
    (None: unknown, ship everything). When the geometry is stable (same
    ``t_bucket``, needed cap <= ``prev_cap``) only the dirty rows are
    shipped, in one host-to-device copy, and written into the resident
    tensor in place (``index_copy_``); the bytes a full re-ship would have
    cost beyond them count in ``bytes_h2d_saved``. Any other case ships
    the whole block. ``device``: where a full ship goes (None: the card,
    or raises where there is none); a dirty-row update stays on
    ``prev_tensor``'s device.

    Returns ``(tensor, cap, shipped_bytes)``; shipped bytes count in
    ``bytes_h2d``.
    """
    _check_mesh(mesh)
    if np.dtype(dtype) != np.float32:
        raise TypeError(f"device packs hold float32 runs, got {dtype}")
    need_cap = next_bucket(max((len(r) for r in runs), default=1) or 1)
    if prev is not None and dirty is not None:
        prev_dev, prev_cap, prev_tb = prev
        # geometry-stable reuse keeps the (possibly larger) placed cap:
        # extra +inf padding never changes a finite query's counts
        if (prev_dev is not None and prev_tb == t_bucket
                and need_cap <= prev_cap
                and all(0 <= t < t_bucket for t in dirty)):
            full_bytes = t_bucket * prev_cap * 4
            if not dirty:
                _count_bytes(metrics, 0, full_bytes)
                return prev_dev, prev_cap, 0
            slots = sorted(dirty)
            rows = torch.from_numpy(_rows_block(runs, slots, prev_cap))
            idx = torch.as_tensor(slots, dtype=torch.int64)
            prev_dev.index_copy_(0, idx.to(prev_dev.device),
                                 rows.to(prev_dev.device))
            shipped = len(slots) * prev_cap * 4
            _count_bytes(metrics, shipped, full_bytes - shipped)
            return prev_dev, prev_cap, shipped
    dev = resolve_device(device)
    block = _rows_block(runs, range(t_bucket), need_cap)
    _count_bytes(metrics, block.nbytes, 0)
    return torch.from_numpy(block).to(dev), need_cap, block.nbytes


def tenant_count_searchsorted(pos_pack: torch.Tensor,
                              neg_pack: torch.Tensor, qn: torch.Tensor,
                              qp: torch.Tensor) -> torch.Tensor:
    """The batched ``torch.searchsorted`` twin of kernel 7: each side's
    ``[T, q]`` queries searched, row by row, in its ``[T, cap]`` pack,
    left and right, into the same int32 block [4, T, q]."""
    return torch.stack([
        torch.searchsorted(pack, q, right=right, out_int32=True)
        for pack, q in ((neg_pack, qn), (pos_pack, qp))
        for right in (False, True)])


def tenant_pack_counts(mesh, pos_pack: torch.Tensor, cap_pos: int,
                       neg_pack: torch.Tensor, cap_neg: int, t_bucket: int,
                       q_vs_neg: np.ndarray, q_vs_pos: np.ndarray,
                       dtype=np.float32, *, kernel=None, metrics=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """One fleet count: padded ``[t_bucket, qb]`` query blocks against
    both class packs (placed by :func:`place_tenant_pack`, on their own
    device). Returns four ``[t_bucket, qb]`` int64 arrays ``(less_n,
    leq_n, less_p, leq_p)``.

    Both query blocks ride one host-to-device copy, and the [4, T, qb]
    block comes back in one copy. ``kernel``: None takes the batched
    searchsorted route; True one launch of kernel 7 (its plain version
    on the CPU), counted in ``metrics`` as ``count_kernel_calls_total``.
    """
    _check_mesh(mesh)
    if np.dtype(dtype) != np.float32:
        raise TypeError(f"device counts take float32 packs, got {dtype}")
    qn = np.asarray(q_vs_neg, np.float32)
    qp = np.asarray(q_vs_pos, np.float32)
    if qn.shape != qp.shape or qn.shape[0] != t_bucket:
        raise ValueError(f"query blocks of shapes {qn.shape} and "
                         f"{qp.shape} for t_bucket={t_bucket}")
    if (tuple(pos_pack.shape) != (t_bucket, cap_pos)
            or tuple(neg_pack.shape) != (t_bucket, cap_neg)):
        raise ValueError(
            f"packs of shapes {tuple(pos_pack.shape)} and "
            f"{tuple(neg_pack.shape)} for t_bucket={t_bucket}, "
            f"caps {cap_pos} / {cap_neg}")
    key = ("tenant", t_bucket, cap_pos, cap_neg, qn.shape[1],
           kernel is not None)
    with device_section(key) as ds:
        q = torch.from_numpy(np.stack([qn, qp])).to(pos_pack.device)
        if kernel is not None:
            out = tenant_count(pos_pack, neg_pack, q[0], q[1])
        else:
            out = tenant_count_searchsorted(pos_pack, neg_pack, q[0], q[1])
        ds.dispatched()
        out = out.cpu().numpy().astype(np.int64)
    if kernel is not None and metrics is not None:
        metrics.counter("count_kernel_calls_total").inc()
    return out[0], out[1], out[2], out[3]
