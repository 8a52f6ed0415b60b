"""Cross-shard all-pairs over a ring of workers (the counterpart of
``tuplewise_tpu.parallel.ring``).

Each worker holds one block of each sample. To touch every cross-shard
pair, the b-side blocks rotate around the ring (``comm.start_rotate``)
while each worker adds the pair sums of its resident block against the
visiting one; after N stops every (shard_i, shard_j) block pair has met
once, and one all-reduce gives the global (sum, count) on every worker.

The functions take per-worker blocks ``[n_local, m(, d)]`` and a mesh
(``parallel.mesh``): on the worker axis n_local = N and ONE stop is ONE
batched launch over all N (resident, visiting) block pairs; on a rank it
is the rank's own pair. Each stop routes as the JAX ``_make_stats_fn``:

* diff kernels with no masks (every block full, known by the caller):
  ``pair_kernels.pair_sum_any`` (kernel 1), count m_a m_b a worker;
* diff kernels with masks: ``pair_kernels.masked_pair_sum`` (kernel 2),
  count sum(ma) sum(mb) a worker in float64;
* ids (one-sample kernels) and pair feature kernels: the plain tiled
  ``pair_tiles.pair_stats``, a worker at a time (the JAX package's XLA
  scan there too);
* triplets: ``triplet_kernels.grouped_triplet_stats`` (kernel 5 through
  the factorisation) with the workers as groups, or the plain tiled
  ``pair_tiles.triplet_stats`` a worker at a time for a custom kernel.

``impl="plain"`` sends every stop to the plain versions. Sums and counts
are float64 (the JAX ring carries float32).

The next visiting block's rotation is issued before the current stop's
kernel and waited on after it, the double buffering of the JAX ring: it
overlaps on NCCL and is a device copy on the worker axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tuplewise_tpu_torch.ops import pair_kernels, pair_tiles, triplet_kernels
from tuplewise_tpu_torch.utils.profiling import annotate

F64 = torch.float64


def _need_dims(mesh, dims: int, what: str) -> None:
    if len(mesh.shape) != dims:
        raise ValueError(f"{what} runs on a {dims}-D mesh, got axes "
                         f"{mesh.axis_names}")


def _make_stats_fn(kernel, mask_a, ids_a, *, use_ids: bool, impl,
                   no_masks: bool):
    """The per-stop (resident a, visiting blocks) -> (sum [W], count
    [W]) reduction, float64 (module docstring for the routes), and the
    visiting fields it reads: ("b",), ("b", "mb") or ("b", "mb", "ib").
    Only those rotate."""
    if kernel.kind == "diff" and not use_ids:
        if no_masks:
            def fast_stats_fn(a, bv):
                s = pair_kernels.pair_sum_any(a, bv, kernel, impl=impl)
                return s, torch.full_like(s, float(a.shape[1] * bv.shape[1]))

            return fast_stats_fn, ("b",)

        def masked_stats_fn(a, bv, mbv):
            ma = torch.ones_like(a) if mask_a is None else mask_a
            s = pair_kernels.masked_pair_sum(a, bv, ma, mbv, kernel,
                                             impl=impl)
            return s, ma.sum(1, dtype=F64) * mbv.sum(1, dtype=F64)

        return masked_stats_fn, ("b", "mb")

    def tiled_stats_fn(a, bv, mbv, ibv=None):
        out = [pair_tiles.pair_stats(
            kernel, a[w], bv[w],
            mask_a=None if mask_a is None else mask_a[w], mask_b=mbv[w],
            ids_a=None if ibv is None else ids_a[w],
            ids_b=None if ibv is None else ibv[w])
            for w in range(a.shape[0])]
        return (torch.stack([s for s, _ in out]).to(F64),
                torch.stack([c for _, c in out]).to(F64))

    return tiled_stats_fn, ("b", "mb", "ib") if use_ids else ("b", "mb")


def _ring_accumulate(stats_fn, a, visiting, *, comm, axis: int, acc):
    """One full rotation of the visiting state around mesh axis
    ``axis``, adding the stats of every stop to ``acc``. Returns (acc,
    visiting) with the visiting state back at its start (a full cycle is
    the identity), so callers can nest rotations. Spans: ``ring.rotate``
    the rotation's start, ``ring.stop`` the stop's stats."""
    vis = list(visiting)
    for _ in range(comm.shape[axis]):
        with annotate("ring.rotate"):
            nxt = comm.start_rotate(vis, axis)  # in flight during the stop
        with annotate("ring.stop"):
            ds, dc = stats_fn(a, *vis)
        acc = (acc[0] + ds, acc[1] + dc)
        vis = nxt.wait()
    return acc, vis


def _pair_ring_setup(kernel, a, b, mask_a, mask_b, ids_a, ids_b, impl,
                     name):
    """(stats_fn, visiting blocks, zero accumulator) of a pair ring."""
    if (ids_a is None) != (ids_b is None):
        raise ValueError(
            f"{name} needs BOTH ids_a and ids_b (or neither); a lone ids "
            "side would silently mis-exclude pairs")
    stats_fn, fields = _make_stats_fn(
        kernel, mask_a, ids_a, use_ids=ids_a is not None, impl=impl,
        no_masks=mask_a is None and mask_b is None)
    blocks = {
        "b": b,
        "mb": (torch.ones(b.shape[:2], dtype=torch.float32, device=b.device)
               if mask_b is None else mask_b),
        "ib": None if ids_b is None else ids_b.to(torch.int64),
    }
    zero = torch.zeros(a.shape[0], dtype=F64, device=a.device)
    return stats_fn, [blocks[f] for f in fields], (zero, zero.clone())


def _reduce(comm, acc) -> Tuple[torch.Tensor, torch.Tensor]:
    tot = comm.all_reduce_sum(torch.stack(acc, dim=1))
    return tot[0], tot[1]


def ring_pair_stats(
    kernel,
    a: torch.Tensor,
    b: torch.Tensor,
    mask_a: Optional[torch.Tensor] = None,
    mask_b: Optional[torch.Tensor] = None,
    ids_a: Optional[torch.Tensor] = None,
    ids_b: Optional[torch.Tensor] = None,
    *,
    mesh,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (sum, count) of h over ALL cross- and within-shard pairs on
    a 1-D mesh, as float64 0-d tensors, the same on every worker and
    equal to the single-device ``pair_stats`` of the concatenated data.

    a, b: the workers' blocks [n_local, m_a(, d)], [n_local, m_b(, d)]
    (one-sample statistics pass the same blocks with their ids); masks
    [n_local, m] float32 weights, ids [n_local, m] global row ids. The
    b side rotates, the a side stays. Passing no masks is the caller's
    promise that every row on every worker is valid, which sends the
    stops to the unmasked kernel."""
    _need_dims(mesh, 1, "ring_pair_stats")
    stats_fn, vis, acc = _pair_ring_setup(kernel, a, b, mask_a, mask_b,
                                          ids_a, ids_b, impl,
                                          "ring_pair_stats")
    acc, _ = _ring_accumulate(stats_fn, a, vis, comm=mesh.comm, axis=0,
                              acc=acc)
    return _reduce(mesh.comm, acc)


def ring_pair_stats_2d(
    kernel,
    a: torch.Tensor,
    b: torch.Tensor,
    mask_a: Optional[torch.Tensor] = None,
    mask_b: Optional[torch.Tensor] = None,
    ids_a: Optional[torch.Tensor] = None,
    ids_b: Optional[torch.Tensor] = None,
    *,
    mesh,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ring_pair_stats`` on a 2-D (dcn, ici) mesh, the double ring:
    the visiting block makes a full ici cycle for every one dcn hop, so
    each worker meets every b block while the slow axis carries D - 1
    block transfers a worker instead of D I - 1. Same contract."""
    _need_dims(mesh, 2, "ring_pair_stats_2d")
    stats_fn, vis, acc = _pair_ring_setup(kernel, a, b, mask_a, mask_b,
                                          ids_a, ids_b, impl,
                                          "ring_pair_stats_2d")
    comm = mesh.comm
    for _ in range(comm.shape[0]):          # dcn, the slow axis
        acc, vis = _ring_accumulate(stats_fn, a, vis, comm=comm, axis=1,
                                    acc=acc)
        vis = comm.start_rotate(vis, 0).wait()
    return _reduce(comm, acc)


def _triplet_block(kernel, a, ma, ia, p, mp, ip, yk, mk, impl):
    """One stop of the double ring: (sum [W], count [W]) float64 of the
    resident anchors against the visiting positives and negatives."""
    if triplet_kernels.triplet_combine_kernel(kernel) is not None:
        s, c = triplet_kernels.grouped_triplet_stats(
            kernel, a, yk, ia, ma, mk, impl, positives=p, mask_p=mp,
            ids_p=ip)
        return s, c.to(F64)
    out = [pair_tiles.triplet_stats(
        kernel, a[w], yk[w], ma[w], mk[w], ia[w], positives=p[w],
        mask_p=mp[w], ids_p=ip[w]) for w in range(a.shape[0])]
    return (torch.stack([s for s, _ in out]).to(F64),
            torch.stack([c for _, c in out]).to(F64))


def _hier_cycle(state, axes, step_fn, acc, comm):
    """Visit all prod(axis sizes) ring positions of ``state``: the LAST
    axis rotates innermost and each earlier axis hops once a completed
    inner cycle, so a full cycle is the identity. ``step_fn(acc,
    state) -> acc`` runs at every position."""
    ax, rest = axes[0], axes[1:]
    for _ in range(comm.shape[ax]):
        if rest:
            acc, state = _hier_cycle(state, rest, step_fn, acc, comm)
            state = comm.start_rotate(state, ax).wait()
        else:
            nxt = comm.start_rotate(state, ax)   # in flight during the stop
            acc = step_fn(acc, state)
            state = nxt.wait()
    return acc, state


def _triplet_ring(kernel, x, y, mask_x, mask_y, ids_x, mesh, impl, name):
    if ids_x is None:
        raise ValueError(
            f"{name} requires global ids_x; per-shard local indices would "
            "mis-exclude cross-shard anchor/positive pairs")
    axes = tuple(range(len(mesh.shape)))     # the last axis innermost
    mx = (torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
          if mask_x is None else mask_x)
    my = (torch.ones(y.shape[:2], dtype=torch.float32, device=y.device)
          if mask_y is None else mask_y)
    ix = ids_x.to(torch.int64)
    comm = mesh.comm

    def at_p(acc, p_state):
        p, mp, ip = p_state

        def at_y(acc2, y_state):
            ds, dc = _triplet_block(kernel, x, mx, ix, p, mp, ip, *y_state,
                                    impl)
            return (acc2[0] + ds, acc2[1] + dc)

        acc, _ = _hier_cycle([y, my], axes, at_y, acc, comm)
        return acc

    zero = torch.zeros(x.shape[0], dtype=F64, device=x.device)
    acc, _ = _hier_cycle([x, mx, ix], axes, at_p, (zero, zero.clone()), comm)
    return _reduce(comm, acc)


def ring_triplet_stats(
    kernel,
    x: torch.Tensor,
    y: torch.Tensor,
    mask_x: Optional[torch.Tensor] = None,
    mask_y: Optional[torch.Tensor] = None,
    ids_x: Optional[torch.Tensor] = None,
    *,
    mesh,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (sum, count) of h(x_i, x_j, y_k) over ALL triplets with
    ids_x[i] != ids_x[j], on a 1-D mesh: a DOUBLE ring. Anchors stay;
    the positives block (x, its mask and ids) walks the ring, and at
    each of its N positions the negatives complete a full cycle: N^2
    stops. ids_x (GLOBAL row ids) is required."""
    _need_dims(mesh, 1, "ring_triplet_stats")
    return _triplet_ring(kernel, x, y, mask_x, mask_y, ids_x, mesh, impl,
                         "ring_triplet_stats")


def ring_triplet_stats_2d(
    kernel,
    x: torch.Tensor,
    y: torch.Tensor,
    mask_x: Optional[torch.Tensor] = None,
    mask_y: Optional[torch.Tensor] = None,
    ids_x: Optional[torch.Tensor] = None,
    *,
    mesh,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The degree-3 statistic on a 2-D (dcn, ici) mesh: the positives
    walk all D I positions (ici inner, dcn outer) and at each the
    negatives make a full hierarchical cycle; N^2 stops, the slow axis
    crossed once a completed inner cycle. Same contract as
    ``ring_triplet_stats``."""
    _need_dims(mesh, 2, "ring_triplet_stats_2d")
    return _triplet_ring(kernel, x, y, mask_x, mask_y, ids_x, mesh, impl,
                         "ring_triplet_stats_2d")
