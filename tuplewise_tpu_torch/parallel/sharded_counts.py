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

The mesh form (the counterpart of the JAX module's shard layer). A
``parallel.mesh.Mesh`` of S workers holds each sorted run as S contiguous
slices, one row of an ``[S, cap]`` tensor a worker, +inf padded to a
per-worker bucket (:func:`place_base`): on the worker axis (``LocalComm``)
the whole tensor on one device, across ``torch.distributed`` ranks
(``DistComm``) each rank's ``[1, cap]`` row. A count runs every worker's
rows and adds the per-worker int32 blocks in worker order
(``comm.all_reduce_sum``), the JAX ``psum``: counting is additive over
any partition of a run, so the counts equal the flat ones at every S.
:func:`signed_pair_counts` with a mesh launches kernel 6 over the worker
axis once (``ops.count_kernels.signed_count_mesh``) or, with
``kernel=None``, one batched ``torch.searchsorted`` a run and side over
``[S, cap]``; the fleet's :func:`tenant_pack_counts` does the same with
``[S, T, cap]`` packs and kernel 7 (``tenant_count_mesh``).

The delta tiers of the index ride the same layout. :func:`place_base`
ships only the rows whose slice changed when the geometry (per, cap)
holds (``bytes_h2d`` / ``bytes_h2d_saved``); :func:`delta_append`
rank-merges a placed chunk into each worker's delta row, with no
exchange; :func:`sharded_major_merge` executes the host's
:func:`plan_major_merge` on the mesh, each worker taking its neighbours'
base rows (``comm.start_rotate`` at +1 and -1, the JAX ``ppermute``) and
every delta row (``comm.all_gather``) and building its output slice by
rank arithmetic, in chunks of ``_MERGE_CHUNK`` slots: zero base bytes
cross from the host. These are plain torch operations, as the JAX
package computes them outside any Pallas kernel. The byte counters count
the whole mesh's bytes, as the JAX package does, on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tuplewise_tpu_torch.obs.ledger import device_section
from tuplewise_tpu_torch.ops.count_kernels import (
    signed_count_mesh, tenant_count_mesh,
)
from tuplewise_tpu_torch.utils.device import resolve_device

_MIN_BUCKET = 256
# the launch counters of kernels 6 and 7, by (mesh, flat)
_COUNTERS = (("signed_count[mesh]", "signed_count[flat]"),
             ("tenant_count[mesh]", "tenant_count"))


def next_bucket(n: int, min_bucket: int = _MIN_BUCKET) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


def _check_mesh(mesh) -> None:
    """The serving layer shards over a 1-D ``parallel.mesh.Mesh`` (the
    merge's neighbour exchange runs along its one axis)."""
    if mesh is not None and len(mesh.shape) != 1:
        raise ValueError("the mesh form of serving takes a 1-D mesh, got "
                         f"shape {mesh.shape}")


def _check_float32(dtype) -> None:
    if np.dtype(dtype) != np.float32:
        raise TypeError(f"device runs hold float32 values, got {dtype}")


def _held(mesh) -> list:
    """The worker ids whose rows this process holds, in row order."""
    return mesh.comm.worker_ids("cpu").tolist()


def _on_mesh_device(t: torch.Tensor, mesh) -> bool:
    """``t`` lives on the mesh's device ("cuda" names the current card,
    which a tensor reports with its index)."""
    want = mesh.device
    if want.type == "cuda" and want.index is None:
        want = torch.device("cuda", torch.cuda.current_device())
    return t.device == want


def _to_mesh(mesh, block: np.ndarray) -> torch.Tensor:
    """This process's rows of an [S, ...] host block, on the mesh's
    device."""
    rows = mesh.comm.local_rows(torch.from_numpy(block))
    return rows.contiguous().to(mesh.device)


def place_run(arr: np.ndarray, cap: int, device) -> torch.Tensor:
    """A sorted host run as a float32 tensor of length ``cap`` on
    ``device``, +inf past its values (finite queries never count the
    padding)."""
    out = np.full(cap, np.inf, dtype=np.float32)
    out[: len(arr)] = arr
    return torch.from_numpy(out).to(device)


def signed_count_searchsorted_mesh(runs: Sequence[torch.Tensor],
                                   signs: Sequence[int], sets: Sequence[int],
                                   qa: torch.Tensor,
                                   qb: torch.Tensor) -> torch.Tensor:
    """The ``torch.searchsorted`` twin of the worker-axis kernel 6 (the
    JAX ``sharded_count_fn`` / ``sharded_multi_count_fn``): one batched
    left and one right search a run over its ``[S, cap]`` rows, summed
    with the run's sign into per-worker int32 blocks [S, 4, qcols]."""
    n = runs[0].shape[0] if runs else 1
    qs = (qa, qb)
    out = torch.zeros((n, 4, max(len(qa), len(qb))), dtype=torch.int32,
                      device=qa.device)
    for run, s, a in zip(runs, signs, sets):
        q = qs[a]
        if len(q) == 0:
            continue
        qq = q.expand(n, len(q)).contiguous()
        for row, right in ((2 * a, False), (2 * a + 1, True)):
            c = torch.searchsorted(run, qq, right=right, out_int32=True)
            out[:, row, :len(q)] += s * c
    return out


def signed_count_searchsorted(runs: Sequence[torch.Tensor],
                              signs: Sequence[int], sets: Sequence[int],
                              qa: torch.Tensor,
                              qb: torch.Tensor) -> torch.Tensor:
    """The ``torch.searchsorted`` twin of the fused kernel:
    :func:`signed_count_searchsorted_mesh` at one worker, the int32 block
    [4, max(len(qa), len(qb))]."""
    return signed_count_searchsorted_mesh([r[None] for r in runs], signs,
                                          sets, qa, qb)[0]


def signed_pair_counts(mesh, runs_a, runs_b, q_a: np.ndarray,
                       q_b: np.ndarray, dtype=np.float32, *, kernel=None,
                       metrics=None, device=None, chaos=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Signed counts of two query sets in one device call.

    ``runs_a`` / ``runs_b``: sequences of ``(run, cap, sign)`` counted
    against ``q_a`` / ``q_b``. With ``mesh=None``, ``run`` is a sorted
    host array (padded here to ``cap``) or a placed device tensor of
    length ``cap``, and ``device`` is where host runs and the queries go
    (a placed run's own device wins; None is the card, and raises where
    there is none). With a mesh, ``run`` is a tensor placed by
    :func:`place_base` (this process's ``[n_local, cap]`` rows) and the
    per-worker blocks are added over the mesh. Returns four int64 arrays
    ``(less_a, leq_a, less_b, leq_b)`` trimmed to the query lengths.

    ``kernel``: None takes the searchsorted route; True the fused kernel
    (its plain version on the CPU), counted in ``metrics`` as
    ``count_kernel_calls_total``. No fallback: a kernel that fails
    raises. ``chaos`` fires the ``sharded_count`` hook first. Only
    float32 runs are taken, the index's ``engine="torch"`` storage.
    """
    _check_mesh(mesh)
    if chaos is not None:
        chaos.fire("sharded_count")
    _check_float32(dtype)
    la, lb = len(q_a), len(q_b)
    if not runs_a and not runs_b:
        return (np.zeros(la, np.int64), np.zeros(la, np.int64),
                np.zeros(lb, np.int64), np.zeros(lb, np.int64))
    if mesh is not None:
        dev = mesh.device
    else:
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
                if mesh is not None:
                    raise TypeError("a mesh count takes runs placed by "
                                    "place_base")
                run = place_run(np.asarray(run, np.float32), cap, dev)
            tensors.append(run)
            caps.append(cap)
            signs.append(sign)
            sets.append(side)
    key = ("signed_pair", None if mesh is None else mesh.n_workers,
           tuple(caps), tuple(signs), tuple(sets), kernel is not None)
    with device_section(key) as ds:
        # one host-to-device copy carries both query sets
        q = torch.from_numpy(np.concatenate(
            [np.asarray(q_a, np.float32), np.asarray(q_b, np.float32)]))
        q = q.to(dev)
        qa, qb = q[:la], q[la:]
        if mesh is None:
            tensors = [t[None] for t in tensors]
        if kernel is None:
            blocks = signed_count_searchsorted_mesh(tensors, signs, sets, qa,
                                                    qb)
        else:
            blocks = signed_count_mesh(tensors, signs, sets, qa, qb,
                                       counter=_COUNTERS[0][mesh is None])
        # the psum: per-worker blocks added in worker order, in float64
        # (exact for integers below 2^53) and read back as int64
        out = blocks[0] if mesh is None else mesh.comm.all_reduce_sum(blocks)
        ds.dispatched()
        out = out.cpu().numpy().astype(np.int64)
    if kernel is not None and metrics is not None:
        metrics.counter("count_kernel_calls_total").inc()
    return (out[0, :la], out[1, :la], out[2, :lb], out[3, :lb])


def sharded_counts(mesh, base_dev, cap: int, q: np.ndarray,
                   dtype=np.float32, chaos=None,
                   deltas: Sequence[Tuple[torch.Tensor, int]] = ()
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(less, leq) int64 counts of queries against the placed base run
    and ``deltas`` (placed ``(tensor, cap)`` runs), summed over the mesh:
    the JAX ``sharded_counts``, by the searchsorted route. ``base_dev``
    may be None when only deltas exist. ``chaos`` fires the
    ``sharded_count`` hook."""
    runs = ([(base_dev, cap, 1)] if base_dev is not None else [])
    runs += [(d, c, 1) for d, c in deltas]
    if not runs:
        if chaos is not None:
            chaos.fire("sharded_count")
        z = np.zeros(len(q), dtype=np.int64)
        return z, z
    less, leq, _, _ = signed_pair_counts(
        mesh, runs, (), np.asarray(q, np.float32), np.zeros(0, np.float32),
        dtype, chaos=chaos)
    return less, leq


# --------------------------------------------------------------------- #
# placement of sorted runs over a mesh                                   #
# --------------------------------------------------------------------- #

def _block(sorted_arr: np.ndarray, S: int, per: int,
           cap: int) -> np.ndarray:
    """The [S, cap] host block ``place_base`` ships: one contiguous
    sorted slice a row, +inf padded."""
    out = np.full((S, cap), np.inf, dtype=np.float32)
    for s in range(S):
        chunk = sorted_arr[s * per:(s + 1) * per]
        out[s, : len(chunk)] = chunk
    return out


def place_base(mesh, sorted_arr: np.ndarray, dtype=np.float32, *,
               prev=None, metrics=None, chaos=None
               ) -> Tuple[torch.Tensor, int, int]:
    """Pad and place a sorted run as [S, cap] contiguous slices, slice s
    of ``per = ceil(n / S)`` values in row s, +inf past it; ``cap`` is
    the bucket of ``per``. Returns ``(tensor, cap, shipped_bytes)``, the
    tensor this process's rows on the mesh's device.

    ``prev``: ``(prev_arr, prev_tensor, prev_cap)`` of the placement this
    one replaces. When the geometry (per, cap) is unchanged, rows whose
    slice is equal are not shipped: the new tensor copies the previous
    one on the device (the previous placement stays valid for a count
    in flight) and only the changed rows cross from the host; the bytes
    a full ship would have cost beyond them count in
    ``bytes_h2d_saved``. ``metrics`` receives ``bytes_h2d`` /
    ``bytes_h2d_saved`` (the whole mesh's bytes); ``chaos`` fires the
    ``place_base`` hook.
    """
    _check_mesh(mesh)
    if chaos is not None:
        chaos.fire("place_base")
    _check_float32(dtype)
    S = mesh.n_workers
    n = len(sorted_arr)
    per = -(-n // S) if n else 0       # ceil; 0 only for an empty run
    cap = next_bucket(max(per, 1))
    full_bytes = S * cap * 4
    if prev is not None:
        prev_arr, prev_dev, prev_cap = prev
        if (prev_arr is not None and prev_dev is not None
                and prev_cap == cap
                and tuple(prev_dev.shape) == (mesh.comm.n_local, cap)
                and _on_mesh_device(prev_dev, mesh)
                and (-(-len(prev_arr) // S) if len(prev_arr) else 0) == per):
            changed = [s for s in range(S)
                       if not np.array_equal(sorted_arr[s * per:(s + 1) * per],
                                             prev_arr[s * per:(s + 1) * per])]
            if not changed:
                _count_bytes(metrics, 0, full_bytes)
                return prev_dev, cap, 0
            if len(changed) < S:
                dev = _reuse_rows(mesh, prev_dev, sorted_arr, changed, per,
                                  cap)
                shipped = len(changed) * cap * 4
                _count_bytes(metrics, shipped, full_bytes - shipped)
                return dev, cap, shipped
    dev = _to_mesh(mesh, _block(sorted_arr, S, per, cap))
    _count_bytes(metrics, full_bytes, 0)
    return dev, cap, full_bytes


def _reuse_rows(mesh, prev_dev: torch.Tensor, sorted_arr: np.ndarray,
                changed: Sequence[int], per: int, cap: int) -> torch.Tensor:
    """A [n_local, cap] placement that ships only the ``changed`` rows
    this process holds: the unchanged rows are a device copy of the
    previous placement."""
    dev = prev_dev.clone()
    row_of = {w: i for i, w in enumerate(_held(mesh))}
    mine = [w for w in changed if w in row_of]
    if mine:
        block = np.full((len(mine), cap), np.inf, dtype=np.float32)
        for k, w in enumerate(mine):
            chunk = sorted_arr[w * per:(w + 1) * per]
            block[k, : len(chunk)] = chunk
        idx = torch.as_tensor([row_of[w] for w in mine], device=dev.device)
        dev[idx] = torch.from_numpy(block).to(dev.device)
    return dev


# --------------------------------------------------------------------- #
# the delta tier and the on-mesh major merge                             #
# --------------------------------------------------------------------- #

class MergePlan(NamedTuple):
    """The host's plan of an on-mesh merge (the JAX ``MergePlan``).

    ``pos``: each delta element's rank in the merged run, padded to a
    bucket with the int32 maximum; ``meta = (n, per_b, per_out, n_out)``;
    ``cap_out``: the output bucket; ``ok``: False when some output
    slice's base window reaches past the one-hop neighbour rows (the
    caller then merges on the host and re-places).
    """

    pos: np.ndarray
    meta: np.ndarray
    cap_out: int
    per_out: int
    ok: bool


def plan_major_merge(base: np.ndarray, delta_full: np.ndarray,
                     S: int) -> MergePlan:
    """The merge plan, on the host (a copy of the JAX function): delta
    element j lands at merged rank ``searchsorted(base, d_j, 'right') +
    j`` (base before delta on ties); the one-hop check counts the delta
    ranks below each output slice's bounds."""
    n, m = len(base), len(delta_full)
    per_b = -(-n // S)
    n_out = n + m
    per_out = -(-n_out // S)
    cap_out = next_bucket(max(per_out, 1))
    pos = np.searchsorted(base, delta_full, side="right") + np.arange(m)
    lo = per_out * np.arange(S, dtype=np.int64)
    hi = np.minimum(n_out, lo + per_out)
    lo_d = np.searchsorted(pos, lo, side="left")
    hi_d = np.searchsorted(pos, hi, side="left")
    lo_b = lo - lo_d
    hi_b = hi - hi_d
    s_idx = np.arange(S, dtype=np.int64)
    ok = bool(np.all(lo_b >= (s_idx - 1) * per_b)
              and np.all(hi_b <= (s_idx + 2) * per_b))
    pos_pad = np.full(next_bucket(max(m, 1)), np.iinfo(np.int32).max,
                      dtype=np.int32)
    pos_pad[:m] = pos
    meta = np.asarray([n, per_b, per_out, n_out], dtype=np.int32)
    return MergePlan(pos=pos_pad, meta=meta, cap_out=cap_out,
                     per_out=per_out, ok=ok)


def delta_append(old: torch.Tensor, cap_old: int, chunk: torch.Tensor,
                 cap_chunk: int, cap_new: int) -> torch.Tensor:
    """Each worker's delta row rank-merged with its placed chunk row (the
    JAX ``delta_append_fn``): ``[n_local, cap_old]`` and ``[n_local,
    cap_chunk]`` sorted rows to ``[n_local, cap_new]``, no exchange. The
    rows need not split the delta contiguously: counting is additive over
    any partition into sorted runs. The chunk's +inf padding is
    dropped."""
    n = old.shape[0]
    o = old
    if cap_new > cap_old:
        o = torch.cat([o, torch.full((n, cap_new - cap_old), float("inf"),
                                     dtype=o.dtype, device=o.device)], 1)
    jc = torch.arange(cap_chunk, device=o.device)
    pd = torch.where(torch.isfinite(chunk),
                     jc + torch.searchsorted(o, chunk.contiguous(),
                                             right=True),
                     torch.full_like(jc, cap_new))
    # one extra column takes the dropped (+inf) chunk slots
    marks = torch.zeros((n, cap_new + 1), dtype=torch.int64,
                        device=o.device)
    marks.scatter_add_(1, pd.clamp(max=cap_new), torch.ones_like(pd))
    marks = marks[:, :cap_new]
    i = torch.arange(cap_new, device=o.device)
    cum = torch.cumsum(marks, 1) - marks
    take_c = torch.gather(chunk, 1, cum.clamp(0, cap_chunk - 1))
    take_o = torch.gather(o, 1, (i - cum).clamp(0, cap_new - 1))
    return torch.where(marks > 0, take_c, take_o)


# The merge executes in chunks of _MERGE_CHUNK output slots a worker: the
# merge shares the device with the request path's counts, so the longest
# single step, not the merge's total, bounds the pause a compaction can
# put in front of a count.
_MERGE_CHUNK = 32768


def sharded_major_merge(mesh, base_dev: torch.Tensor, cap_base: int,
                        delta_devs: Sequence[Tuple[torch.Tensor, int]],
                        plan: MergePlan, chaos=None
                        ) -> Tuple[torch.Tensor, int]:
    """Execute a :func:`plan_major_merge` on the mesh; returns ``(tensor,
    cap_out)``, exactly the layout :func:`place_base` gives the merged
    run. Each worker receives both neighbours' base rows (an output
    slice's base window may overhang into them), every delta row, and
    builds its output slice by rank arithmetic: output slot r holds a
    delta element if r is a planned delta position, else base rank r -
    #deltas before r. No run bytes cross from the host; the plan's O(m)
    integers do. ``chaos`` fires the ``major_merge`` hook (a raise here
    takes the index's counted host path)."""
    _check_mesh(mesh)
    if chaos is not None:
        chaos.fire("major_merge")
    comm = mesh.comm
    dev = base_dev.device
    n_local = base_dev.shape[0]
    # the one-hop exchange: rows of workers s - 1 and s + 1
    from_left = comm.start_rotate([base_dev], 0, 1)
    from_right = comm.start_rotate([base_dev], 0, -1)
    window = torch.cat([from_left.wait()[0], base_dev,
                        from_right.wait()[0]], 1)      # [n_local, 3 cap]
    delta_full = torch.sort(torch.cat(
        [comm.all_gather(d).reshape(-1) for d, _ in delta_devs])).values
    chunk = min(plan.cap_out, _MERGE_CHUNK)
    parts = plan.cap_out // chunk
    pos_np = plan.pos
    if len(pos_np) < chunk:    # the window of planned positions
        pos_np = np.concatenate([pos_np, np.full(
            chunk - len(pos_np), np.iinfo(np.int32).max, np.int32)])
    pos = torch.from_numpy(pos_np.astype(np.int64)).to(dev)
    n, per_b, per_out, n_out = (int(x) for x in plan.meta)
    s = comm.worker_ids(dev)[:, None]                   # [n_local, 1]
    ar = torch.arange(chunk, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    out = torch.empty((n_local, plan.cap_out), dtype=torch.float32,
                      device=dev)
    last_d = delta_full.shape[0] - 1
    for k in range(parts):
        local = k * chunk + ar                          # [chunk]
        start = s * per_out + k * chunk                 # [n_local, 1]
        r = s * per_out + local                         # global ranks
        # the planned positions in this window are a contiguous range of
        # the sorted pos: slice it (clamped into pos, as dynamic_slice
        # is), mark the slots, cumsum
        c_lo = torch.searchsorted(pos, start.reshape(-1).contiguous())
        lo = c_lo.clamp(max=len(pos_np) - chunk)[:, None]
        rel = pos[lo + ar] - start
        rel = torch.where(rel >= 0, rel, chunk).clamp(max=chunk)
        marks = torch.zeros((n_local, chunk + 1), dtype=torch.int64,
                            device=dev)
        marks.scatter_add_(1, rel, torch.ones_like(rel))
        marks = marks[:, :chunk]
        c = c_lo[:, None] + torch.cumsum(marks, 1) - marks
        b_rank = r - c
        blk = b_rank // per_b - (s - 1)
        off = b_rank - (b_rank // per_b) * per_b
        flat = blk.clamp(0, 2) * cap_base + off.clamp(0, cap_base - 1)
        bval = torch.gather(window, 1, flat)
        bval = torch.where((b_rank < n) & (blk >= 0) & (blk < 3), bval, inf)
        dval = delta_full[c.clamp(0, last_d)]
        val = torch.where(marks > 0, dval, bval)
        valid = (local < per_out) & (r < n_out)
        out[:, k * chunk:(k + 1) * chunk] = torch.where(valid, val, inf)
    return out, plan.cap_out


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
                      metrics=None, device=None, chaos=None
                      ) -> Tuple[torch.Tensor, int, int]:
    """Pack a fleet's sorted runs of one class into one shared padded
    device tensor.

    ``runs[t]`` is tenant slot t's sorted host run (may be empty; slots
    past ``len(runs)`` are empty rows). Without a mesh the pack is
    ``[t_bucket, cap]``; with a mesh of S workers it is ``[S, t_bucket,
    cap]``, tenant t's contiguous slice s (its own ``ceil(n_t / S)``
    split) in row ``[s, t]``, this process's worker rows on the mesh's
    device. ``cap`` is the bucket of the longest row, shared by every
    tenant; all padding is +inf, so finite queries count exactly without
    masks.

    ``prev``: ``(prev_tensor, prev_cap, prev_t_bucket)`` of the placement
    this one replaces; ``dirty``: the slots whose runs changed since it
    (None: unknown, ship everything). When the geometry is stable (same
    ``t_bucket``, needed cap <= ``prev_cap``, the same workers) only the
    dirty rows are shipped, in one host-to-device copy, and written into
    the resident tensor in place; the bytes a full re-ship would have
    cost beyond them count in ``bytes_h2d_saved``. With a mesh the dirty
    rows ship as the JAX package ships them: a block of the dirty count's
    power-of-two bucket a worker. Any other case ships the whole pack.
    ``device``: where a single-device full ship goes (None: the card, or
    raises where there is none). ``chaos`` fires the ``place_base`` hook.

    Returns ``(tensor, cap, shipped_bytes)``; shipped bytes (the whole
    mesh's) count in ``bytes_h2d``.
    """
    _check_mesh(mesh)
    if chaos is not None:
        chaos.fire("place_base")
    _check_float32(dtype)
    S = mesh.n_workers if mesh is not None else 1
    pers = [-(-len(r) // S) if len(r) else 0 for r in runs]
    need_cap = next_bucket(max(pers, default=1) or 1)
    if prev is not None and dirty is not None:
        prev_dev, prev_cap, prev_tb = prev
        # geometry-stable reuse keeps the (possibly larger) placed cap:
        # extra +inf padding never changes a finite query's counts
        want = ((t_bucket, prev_cap) if mesh is None
                else (mesh.comm.n_local, t_bucket, prev_cap))
        if (prev_dev is not None and prev_tb == t_bucket
                and need_cap <= prev_cap
                and tuple(prev_dev.shape) == want
                and (mesh is None or _on_mesh_device(prev_dev, mesh))
                and all(0 <= t < t_bucket for t in dirty)):
            full_bytes = S * t_bucket * prev_cap * 4
            if not dirty:
                _count_bytes(metrics, 0, full_bytes)
                return prev_dev, prev_cap, 0
            slots = sorted(dirty)
            if mesh is None:
                rows = torch.from_numpy(_rows_block(runs, slots, prev_cap))
                idx = torch.as_tensor(slots, dtype=torch.int64)
                prev_dev.index_copy_(0, idx.to(prev_dev.device),
                                     rows.to(prev_dev.device))
                shipped = len(slots) * prev_cap * 4
            else:
                shipped = _update_pack_rows(mesh, prev_dev, runs, slots,
                                            prev_cap)
            _count_bytes(metrics, shipped, full_bytes - shipped)
            return prev_dev, prev_cap, shipped
    if mesh is None:
        dev = resolve_device(device)
        block = _rows_block(runs, range(t_bucket), need_cap)
        _count_bytes(metrics, block.nbytes, 0)
        return torch.from_numpy(block).to(dev), need_cap, block.nbytes
    block = np.full((S, t_bucket, need_cap), np.inf, dtype=np.float32)
    for t, r in enumerate(runs):
        per = pers[t]
        for w in range(S):
            chunk = r[w * per:(w + 1) * per]
            if len(chunk):
                block[w, t, : len(chunk)] = chunk
    _count_bytes(metrics, block.nbytes, 0)
    return _to_mesh(mesh, block), need_cap, block.nbytes


def _update_pack_rows(mesh, pack: torch.Tensor, runs, dirty,
                      cap: int) -> int:
    """Write the ``dirty`` slots' rows into the resident mesh pack, in
    place; returns the bytes shipped (the whole mesh's). Each worker's
    rows ride one [db, cap] block, db the dirty count's power-of-two
    bucket (+inf past the dirty rows), the JAX ``_update_pack_rows``
    layout."""
    S = mesh.n_workers
    db = next_bucket(len(dirty), min_bucket=1)
    held = _held(mesh)
    block = np.full((len(held), db, cap), np.inf, dtype=np.float32)
    for i, t in enumerate(dirty):
        r = runs[t] if t < len(runs) else ()
        per = -(-len(r) // S) if len(r) else 0
        for k, w in enumerate(held):
            chunk = r[w * per:(w + 1) * per]
            if len(chunk):
                block[k, i, : len(chunk)] = chunk
    rows = torch.from_numpy(block).to(pack.device)
    idx = torch.as_tensor(dirty, dtype=torch.int64, device=pack.device)
    pack[:, idx] = rows[:, : len(dirty)]
    return S * db * cap * 4


def tenant_count_searchsorted_mesh(pos_pack: torch.Tensor,
                                   neg_pack: torch.Tensor, qn: torch.Tensor,
                                   qp: torch.Tensor) -> torch.Tensor:
    """The batched ``torch.searchsorted`` twin of the worker-axis kernel 7
    (the JAX ``tenant_count_fn``): one batched search a side and bound
    over the ``[S, T, cap]`` pack's rows, each worker's slices against the
    shared ``[T, q]`` queries, into per-worker int32 blocks [S, 4, T,
    q]."""
    n, T = pos_pack.shape[0], qn.shape[0]
    outs = []
    for pack, q in ((neg_pack, qn), (pos_pack, qp)):
        rows = pack.reshape(n * T, pack.shape[2])
        qq = q.expand(n, *q.shape).reshape(n * T, q.shape[1]).contiguous()
        for right in (False, True):
            c = torch.searchsorted(rows, qq, right=right, out_int32=True)
            outs.append(c.reshape(n, T, q.shape[1]))
    return torch.stack(outs, 1)


def tenant_count_searchsorted(pos_pack: torch.Tensor,
                              neg_pack: torch.Tensor, qn: torch.Tensor,
                              qp: torch.Tensor) -> torch.Tensor:
    """The batched ``torch.searchsorted`` twin of kernel 7:
    :func:`tenant_count_searchsorted_mesh` at one worker, the int32 block
    [4, T, q]."""
    return tenant_count_searchsorted_mesh(pos_pack[None], neg_pack[None],
                                          qn, qp)[0]


def tenant_pack_counts(mesh, pos_pack: torch.Tensor, cap_pos: int,
                       neg_pack: torch.Tensor, cap_neg: int, t_bucket: int,
                       q_vs_neg: np.ndarray, q_vs_pos: np.ndarray,
                       dtype=np.float32, *, kernel=None, metrics=None,
                       chaos=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """One fleet count: padded ``[t_bucket, qb]`` query blocks against
    both class packs (placed by :func:`place_tenant_pack`, on their own
    device). Returns four ``[t_bucket, qb]`` int64 arrays ``(less_n,
    leq_n, less_p, leq_p)``.

    Both query blocks ride one host-to-device copy, and the [4, T, qb]
    block comes back in one copy; with a mesh the per-worker blocks are
    added over the mesh first. ``kernel``: None takes the batched
    searchsorted route; True one launch of kernel 7 (its plain version
    on the CPU), counted in ``metrics`` as ``count_kernel_calls_total``.
    ``chaos`` fires the ``sharded_count`` hook first.
    """
    _check_mesh(mesh)
    if chaos is not None:
        chaos.fire("sharded_count")
    _check_float32(dtype)
    qn = np.asarray(q_vs_neg, np.float32)
    qp = np.asarray(q_vs_pos, np.float32)
    if qn.shape != qp.shape or qn.shape[0] != t_bucket:
        raise ValueError(f"query blocks of shapes {qn.shape} and "
                         f"{qp.shape} for t_bucket={t_bucket}")
    lead = () if mesh is None else (mesh.comm.n_local,)
    if (tuple(pos_pack.shape) != lead + (t_bucket, cap_pos)
            or tuple(neg_pack.shape) != lead + (t_bucket, cap_neg)):
        raise ValueError(
            f"packs of shapes {tuple(pos_pack.shape)} and "
            f"{tuple(neg_pack.shape)} for t_bucket={t_bucket}, "
            f"caps {cap_pos} / {cap_neg}")
    key = ("tenant", None if mesh is None else mesh.n_workers, t_bucket,
           cap_pos, cap_neg, qn.shape[1], kernel is not None)
    with device_section(key) as ds:
        q = torch.from_numpy(np.stack([qn, qp])).to(pos_pack.device)
        if mesh is None:
            pos_pack, neg_pack = pos_pack[None], neg_pack[None]
        if kernel is None:
            blocks = tenant_count_searchsorted_mesh(pos_pack, neg_pack, q[0],
                                                    q[1])
        else:
            blocks = tenant_count_mesh(pos_pack, neg_pack, q[0], q[1],
                                       counter=_COUNTERS[1][mesh is None])
        out = blocks[0] if mesh is None else mesh.comm.all_reduce_sum(blocks)
        ds.dispatched()
        out = out.cpu().numpy().astype(np.int64)
    if kernel is not None and metrics is not None:
        metrics.counter("count_kernel_calls_total").inc()
    return out[0], out[1], out[2], out[3]
