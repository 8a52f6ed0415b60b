"""Incremental exact-AUC index: the serving-side twin of ops.rank_auc.

The single-device counterpart of ``tuplewise_tpu.serving.index``. The
index keeps the Mann-Whitney statistic incrementally exact under inserts
and sliding-window evictions by maintaining the integer pair-win count

    wins2 = sum over current (p, n) pairs of  2*1{p > n} + 1{p = n}

as a Python int, so ``AUC = wins2 / (2 * n_pos * n_neg)`` equals the
batch rank AUC of the same multiset up to that one final division. Every
mutation updates wins2 with integer counts, never floats, so compaction,
which moves values between containers, never changes it.

Per class the container is LSM-shaped: a sorted base run, a small
unsorted buffer of recent inserts (bounded by ``compact_every``) and a
list of tombstones (evicted values still inside the base). A compaction
merges the buffer into the base and drops the tombstones.

``engine="torch"`` keeps float32 values and counts on the device: the
host holds the authoritative base run, and the device holds one copy of
it padded with +inf to its bucket, re-placed only when the host run is
replaced (after a compaction). An insert micro-batch costs one fused
count, which counts the insert queries and the window-eviction queries
against both classes' base runs at once, then one device-to-host copy of
the [4, q] counts. ``count_kernel`` picks only how that count runs: True
is one launch of the fused signed-count kernel (kernel 6), False
``torch.searchsorted`` per run and query set, the counterpart of the JAX
package's XLA path. The two give the same integers. ``engine="numpy"``
is the float64 host path.

Background compaction (``bg_compact=True``) moves the merge to a side
thread: the compactor snapshots the buffer and tombstone prefixes under
the lock, merges on the host with the lock released, and swaps the new
base in. Evictions racing a build only remove copies from the
unsnapshotted buffer suffix; anything else becomes a tombstone of the
next build. wins2 is always updated on the caller's thread. All device
work runs on the caller's thread, on the default stream: the compactor
touches host arrays only, and the device copy of a swapped base is made
by the next count.

**Sharded base runs** (``shards=S`` or ``mesh=``): the runs are split
into S contiguous slices over the workers of a 1-D ``parallel.mesh.Mesh``
(on the card's worker axis, ``LocalComm``, or one worker a
``torch.distributed`` rank, ``DistComm``), and a micro-batch's one fused
count runs every worker's rows in one launch (kernel 6 over the worker
axis, or one batched ``torch.searchsorted`` a run) and adds the
per-worker counts over the mesh (``parallel.sharded_counts``). Counting
is additive over any partition, so wins2 and every AUC equal the
single-device index's bit for bit at every S. Placements happen when a
run changes, on the thread that changed it (the compactor thread with
``bg_compact``; the default stream orders them with the counts).

With ``delta_fraction > 0`` (the default) a sharded index compacts in the
JAX package's three tiers: a **minor** compaction splices the buffer into
a small consolidated delta run and ships only the O(buffer) chunk, which
each worker rank-merges into its delta row; evictions of values in the
base or delta become a sorted tombstone multiset whose counts subtract
(in the kernel, sign -1, with ``count_kernel``; on the host otherwise).
A **major** merge folds the delta into the base on the mesh once it
outgrows ``delta_fraction`` of the base (or ``max_delta_runs`` minors):
the host plans, the workers exchange neighbour rows and build their
slices, zero base bytes cross from the host. S = 1, or a plan past the
one-hop exchange, merges on the host and re-places. A **full**
compaction (``compact()``, or a tombstone multiset past the fraction)
folds everything on the host.

**Fault tolerance**: the host is authoritative for the runs, the device
rows are a cache. A failed sharded count runs the shared heal-and-retry
protocol (``parallel.self_heal.MeshHealer``, shrink policy): probe, drop
the lost workers, re-place the runs over the survivors, back off, retry;
the healed counts are the same integers. A crashed background build rolls
back its claim and the watchdog restarts the compactor. A major merge
that meets an injected fault, or a worker the healer finds lost, takes
the host path (``major_merge_fallbacks``); any other exception
propagates. Nothing falls back from a kernel: a kernel that fails
raises. Chaos schedules (``testing.chaos.FaultInjector``) fire the
``sharded_count``, ``place_base``, ``major_merge`` and
``compactor_build`` points.

Scores must be finite (the +inf padding relies on it).
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from tuplewise_tpu_torch.obs.health import shard_balance
from tuplewise_tpu_torch.obs.tracing import check_tracer, maybe_span
from tuplewise_tpu_torch.parallel.self_heal import (
    Backoff, HealExhaustedError, MeshHealer,
)
from tuplewise_tpu_torch.parallel.sharded_counts import (
    delta_append, next_bucket, place_base, place_run, plan_major_merge,
    sharded_major_merge, signed_pair_counts,
)
from tuplewise_tpu_torch.testing.chaos import InjectedFault
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.profiling import BYTE_BUCKETS, MetricsRegistry


def _splice_merge(base: np.ndarray, new_sorted: np.ndarray) -> np.ndarray:
    """Merge two sorted arrays into one pre-sized output buffer: each
    input is written once, one O(n + b) allocation."""
    if len(new_sorted) == 0:
        return base
    if len(base) == 0:
        return np.asarray(new_sorted, dtype=base.dtype)
    out = np.empty(len(base) + len(new_sorted), dtype=base.dtype)
    pos = (np.searchsorted(base, new_sorted, side="right")
           + np.arange(len(new_sorted)))
    mask = np.ones(len(out), dtype=bool)
    mask[pos] = False
    out[pos] = new_sorted
    out[mask] = base
    return out


def _remove_sorted(arr: np.ndarray, values: List[float]) -> np.ndarray:
    """Remove one occurrence per entry of ``values`` from sorted ``arr``
    (duplicates consume consecutive slots), in one vectorised pass: the
    values are cast to ``arr``'s dtype once, so no search converts the
    whole array. Every value must be present: tombstones reference
    scores that were inserted."""
    if not values:
        return arr
    vals = np.sort(np.asarray(values, dtype=arr.dtype))
    # the k-th copy of a value takes the k-th slot of its equal run
    dup = np.arange(len(vals)) - np.searchsorted(vals, vals, side="left")
    idxs = np.searchsorted(arr, vals, side="left") + dup
    ok = idxs < len(arr)
    ok[ok] = arr[idxs[ok]] == vals[ok]
    if not ok.all():
        raise RuntimeError(
            f"tombstone value {vals[~ok][0]!r} not present")
    return np.delete(arr, idxs)


class _ClassSide:
    """One class's container: the sorted base run, the pending buffer and
    the tombstones, and the device copies.

    ``snap_buf``/``snap_tomb`` mark the prefixes an in-flight background
    build has snapshotted (0 when idle): mutators treat them as
    immutable, and the swap trims exactly them. ``placed_base`` is the
    host array that ``base_dev`` mirrors.

    The sharded tiers add ``delta_run`` (the consolidated sorted run of
    inserts not yet folded into the base, mirrored by ``delta_dev`` /
    ``delta_cap``, with ``delta_rows`` its per-worker row occupancy and
    ``delta_minors`` the minors merged into it), ``tomb_run`` (the sorted
    tombstone multiset, mirrored by ``tomb_dev`` in kernel mode, whose
    counts subtract) and ``placed_tomb``. While a background job runs
    (``building``) the worker owns base, delta_run, tomb_run and their
    placements; mutators only append to buf/tomb and remove from the
    unsnapshotted buffer suffix.
    """

    def __init__(self, dtype):
        self.dtype = dtype
        self.base = np.empty(0, dtype=dtype)
        self.buf: List[float] = []
        self.tomb: List[float] = []
        self.base_dev: Optional[torch.Tensor] = None
        self.cap = 0
        self.placed_base: Optional[np.ndarray] = None
        self.delta_run = np.empty(0, dtype=dtype)
        self.delta_dev: Optional[torch.Tensor] = None
        self.delta_cap = 0
        self.delta_rows: Optional[np.ndarray] = None
        self.delta_minors = 0
        self.tomb_run = np.empty(0, dtype=dtype)
        self.tomb_dev: Optional[torch.Tensor] = None
        self.tomb_cap = 0
        self.placed_tomb: Optional[np.ndarray] = None
        self.building = False
        self.snap_buf = 0
        self.snap_tomb = 0

    @property
    def size(self) -> int:
        return (len(self.base) + len(self.delta_run) + len(self.buf)
                - len(self.tomb) - len(self.tomb_run))

    @property
    def pending(self) -> Tuple[int, int]:
        """(buf, tomb) entries not claimed by an in-flight build."""
        return len(self.buf) - self.snap_buf, len(self.tomb) - self.snap_tomb

    def clear_delta(self) -> None:
        self.delta_run = np.empty(0, dtype=self.dtype)
        self.delta_dev, self.delta_cap = None, 0
        self.delta_rows = None
        self.delta_minors = 0

    def values(self) -> np.ndarray:
        """Current multiset as a sorted array (oracle path, O(n))."""
        out = np.concatenate(
            [self.base, self.delta_run,
             np.asarray(self.buf, dtype=self.dtype)])
        out = np.sort(out, kind="stable")
        return _remove_sorted(out, self.tomb_run.tolist() + self.tomb)


class ExactAucIndex:
    """Streaming exact AUC with O(log n) amortised inserts.

    Args:
      window: retain only the last ``window`` arrivals (across both
        classes); None = unbounded.
      compact_every: buffer/tombstone size that triggers a compaction.
      engine: "torch" (float32 values; counts and the on-thread
        compaction sort on ``device``) or "numpy" (float64 host path).
      device: where ``engine="torch"`` counts: the card unless the
        caller asks for the CPU (``device="cpu"``), where the plain
        versions run. With no card and no device it raises.
      bg_compact: merge on a side thread; the insert path pays only the
        swap. Not on a distributed mesh (ValueError): its collectives stay
        on the caller's thread, in one order on every rank.
      count_kernel: ``engine="torch"`` only: each insert micro-batch's
        one fused count launches the signed-count kernel; False counts
        with ``torch.searchsorted``. The integers are the same.
      metrics: a ``MetricsRegistry`` receiving ``compactions_total``,
        ``compaction_pause_s``, ``bytes_h2d`` and the count counters;
        None = a private one.
      flight: optional ``FlightRecorder`` receiving compaction and heal
        events.
      shards: None = single-device runs; an int S >= 1 shards the runs
        over a mesh of S workers on ``device``'s worker axis
        (``engine="torch"`` only; S = 1 runs the mesh path on one
        worker). Counts equal the single-device index's at every S.
      mesh: an existing 1-D ``parallel.mesh.Mesh`` (overrides ``shards``
        and ``device``), local or distributed.
      chaos: a ``testing.chaos.FaultInjector`` fired at the
        ``sharded_count``, ``place_base``, ``major_merge`` and
        ``compactor_build`` points.
      shard_retries / retry_backoff_s / probe_timeout_s: the bounded
        heal-and-retry of a sharded count, its backoff base and the
        health probe's wall-clock bound.
      delta_fraction: sharded mode only: > 0 (default 0.25) compacts in
        the delta tiers, a major merge once ``|delta|`` exceeds this
        fraction of the base; 0 is the host-merge path with full
        re-placement.
      max_delta_runs: fold the delta into the base after this many minor
        compactions, whatever its size.
      tracer: an ``obs.tracing.Tracer``: compactions, sharded counts,
        heals and background builds become spans; None = off.
    """

    def __init__(self, window: Optional[int] = None,
                 compact_every: int = 512, engine: str = "torch",
                 device=None, bg_compact: bool = False, metrics=None,
                 count_kernel: bool = False, flight=None,
                 shards: Optional[int] = None, mesh=None, chaos=None,
                 shard_retries: int = 3, retry_backoff_s: float = 0.02,
                 probe_timeout_s: float = 5.0, delta_fraction: float = 0.25,
                 max_delta_runs: int = 64, tracer=None):
        if engine not in ("torch", "numpy"):
            raise ValueError(f"engine must be 'torch' or 'numpy': {engine!r}")
        if window is not None and window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if compact_every < 1:
            raise ValueError(f"compact_every must be >= 1: {compact_every}")
        if mesh is not None:
            if len(mesh.shape) != 1:
                raise ValueError("the sharded index takes a 1-D mesh, got "
                                 f"shape {mesh.shape}")
            shards = mesh.n_workers
        if shards is not None and shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards is not None and engine != "torch":
            raise ValueError("sharded base runs need engine='torch'")
        if delta_fraction < 0:
            raise ValueError(
                f"delta_fraction must be >= 0: {delta_fraction}")
        if max_delta_runs < 1:
            raise ValueError(
                f"max_delta_runs must be >= 1: {max_delta_runs}")
        check_tracer(tracer)
        self.window = window
        self.compact_every = compact_every
        self.engine = engine
        self.shards = shards
        self.bg_compact = bg_compact
        self.delta_fraction = float(delta_fraction)
        self.max_delta_runs = int(max_delta_runs)
        # the delta tiers need the mesh: they cut host-to-device bytes
        self._delta = shards is not None and self.delta_fraction > 0
        self.count_kernel = bool(count_kernel)
        self._ck = self.count_kernel and engine == "torch"
        if shards is not None and mesh is None:
            from tuplewise_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(shards, device)
        if bg_compact and mesh is not None and mesh.distributed:
            # the compactor thread's major merge and heals issue
            # collectives; beside the caller's counts their order would
            # differ from rank to rank
            raise ValueError(
                "bg_compact=True is not taken on a distributed mesh: the "
                "compactor thread's collectives would interleave with the "
                "caller's in an order that differs between ranks")
        self._mesh = mesh
        if mesh is not None:
            self.device = mesh.device
        else:
            self.device = resolve_device(device) if engine == "torch" else None
        self.dtype = np.float32 if engine == "torch" else np.float64
        self.chaos = chaos
        self.shard_retries = shard_retries
        self.retry_backoff_s = retry_backoff_s
        self.probe_timeout_s = probe_timeout_s
        self.tracer = tracer
        self.flight = flight
        self._pos = _ClassSide(self.dtype)
        self._neg = _ClassSide(self.dtype)
        # arrival order for window eviction: (value, is_pos)
        self._log: Deque[Tuple[float, bool]] = collections.deque()
        self._wins2 = 0          # exact: a Python int never overflows
        self.n_compactions = 0
        self.n_major_merges = 0
        self.n_evicted = 0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_compactions = self.metrics.counter("compactions_total")
        self._h_pause = self.metrics.histogram("compaction_pause_s")
        self._g_delta = self.metrics.gauge("delta_run_events")
        self._g_tomb = self.metrics.gauge("tombstone_occupancy")
        self._g_mesh = self.metrics.gauge("mesh_width")
        self._g_mesh.set(shards if shards is not None else 0)
        # shard balance over the per-shard occupancy (base + delta rows)
        self._g_skew = self.metrics.gauge("shard_skew")
        self._g_skew_cv = self.metrics.gauge("shard_balance_cv")
        self._c_heal_exhausted = self.metrics.counter("heal_exhausted_total")
        # host-to-device bytes of placements (the whole mesh's)
        self._c_bytes = self.metrics.counter("bytes_h2d")
        self._c_bytes_saved = self.metrics.counter("bytes_h2d_saved")
        self._h_compaction_bytes = self.metrics.histogram(
            "compaction_bytes", buckets=BYTE_BUCKETS)
        self._h_major = self.metrics.histogram("major_merge_s")
        self._c_major = self.metrics.counter("major_merges_total")
        self._c_major_fb = self.metrics.counter("major_merge_fallbacks")
        self.last_major_merge_error = None
        # the healer records into these (create-or-return)
        self.metrics.counter("reshard_events")
        self.metrics.counter("shard_retries_total")
        self.metrics.histogram("recovery_time_s")
        self._c_bg_restarts = self.metrics.counter("bg_compactor_restarts")
        # calls = fused-kernel dispatches, one per insert micro-batch;
        # fallbacks stays 0: nothing falls back from the kernel
        self.metrics.counter("count_kernel_calls_total")
        self.metrics.counter("count_kernel_fallbacks_total")
        # shrink policy: counts are additive over any partition, so a
        # narrower mesh gives the same integers
        self._healer = None
        if mesh is not None:
            self._healer = MeshHealer(
                mesh, chaos=chaos, probe_timeout_s=probe_timeout_s,
                metrics=self.metrics,
                backoff=Backoff(base_s=retry_backoff_s, cap_s=1.0),
                flight=flight)
        # one re-entrant lock guards all container structure; the
        # condition signals build completion
        self._cv = threading.Condition(threading.RLock())
        self._closed = False
        self.last_compactor_error = None   # repr of a crashed build
        self._bg_test_hook = None    # tests: called at build start
        if bg_compact:
            self._jobs: "queue.Queue[Optional[_ClassSide]]" = queue.Queue()
            self._compactor = threading.Thread(
                target=self._compact_worker, name="tuplewise-compactor",
                daemon=True)
            self._compactor.start()

    # ------------------------------------------------------------------ #
    # counting primitives (all integer-exact)                            #
    # ------------------------------------------------------------------ #
    def _runs(self, side: _ClassSide) -> list:
        """The side's runs for a device count (caller holds the lock).

        Single device: its base run, +1, from the device copy, re-placed
        only when the host run was replaced. Sharded: the placed base and
        delta runs (+1) and, in kernel mode, the tombstone multiset (-1),
        whose mirror is refreshed here when stale."""
        if self.shards is not None:
            if self._ck and side.placed_tomb is not side.tomb_run:
                self._replace_tomb(side)
            runs = []
            if side.base_dev is not None:
                runs.append((side.base_dev, side.cap, 1))
            if side.delta_dev is not None:
                runs.append((side.delta_dev, side.delta_cap, 1))
            if side.tomb_dev is not None:
                runs.append((side.tomb_dev, side.tomb_cap, -1))
            return runs
        if len(side.base) == 0:
            return []
        if side.placed_base is not side.base:
            side.cap = next_bucket(len(side.base))
            side.base_dev = place_run(side.base, side.cap, self.device)
            side.placed_base = side.base
            self._c_bytes.inc(side.cap * 4)
        return [(side.base_dev, side.cap, 1)]

    def _healed(self, fn):
        """``fn()`` under the heal-and-retry protocol when sharded (the
        lock held across each heal round, whichever thread heals)."""
        if self._healer is None:
            return fn()
        try:
            return self._healer.run(fn, retries=self.shard_retries,
                                    on_heal=self._on_heal, lock=self._cv)
        except HealExhaustedError as e:
            # terminal for this mesh: dump the flight ring now
            self._c_heal_exhausted.inc()
            if self.flight is not None:
                self.flight.record("heal_exhausted", error=repr(e))
                self.flight.auto_dump()
            raise

    def _signed_counts(self, sides_a, sides_b, q_a: np.ndarray,
                       q_b: np.ndarray):
        """One fused count of ``q_a`` against the runs of the sides
        ``sides_a`` and ``q_b`` against those of ``sides_b`` (each a
        tuple of at most one side). Sharded, under the heal-and-retry
        protocol: each attempt re-reads the placements, so a heal's
        re-placement is picked up."""
        def attempt():
            runs_a = [r for sd in sides_a for r in self._runs(sd)]
            runs_b = [r for sd in sides_b for r in self._runs(sd)]
            return signed_pair_counts(
                self._mesh, runs_a, runs_b, q_a, q_b, self.dtype,
                kernel=True if self._ck else None, metrics=self.metrics,
                device=self.device,
                chaos=self.chaos if self._mesh is not None else None)

        if self._healer is None:
            return attempt()
        with maybe_span(self.tracer, "index.sharded_count",
                        n_queries=len(q_a) + len(q_b)):
            return self._healed(attempt)

    def _base_counts(self, side: _ClassSide,
                     q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(less, leq) counts of each query against the side's device
        runs (the base, and sharded the delta run and in kernel mode the
        tombstone multiset)."""
        if len(q) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        if self.engine == "torch":
            less, leq, _, _ = self._signed_counts(
                (side,), (), q, np.zeros(0, self.dtype))
            return less, leq
        less = np.searchsorted(side.base, q, side="left")
        leq = np.searchsorted(side.base, q, side="right")
        return less.astype(np.int64), leq.astype(np.int64)

    def _counts(self, side: _ClassSide,
                q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(less, eq) of each query against side's current multiset."""
        q = np.asarray(q, dtype=self.dtype)
        less, leq = self._base_counts(side, q)
        return self._host_adjust(side, q, less, leq)

    def _host_adjust(self, side: _ClassSide, q: np.ndarray,
                     base_less: np.ndarray, base_leq: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(less, eq) against the side's current multiset given its
        device counts: the pending buffer (+) and the tombstones (-)
        adjust on the host, and the tombstone multiset too unless the
        kernel already subtracted it."""
        less = np.asarray(base_less, dtype=np.int64).copy()
        eq = np.asarray(base_leq, dtype=np.int64) - less
        for vals, sign in ((side.buf, 1), (side.tomb, -1)):
            if not vals:
                continue
            arr = np.sort(np.asarray(vals, dtype=self.dtype))
            l2 = np.searchsorted(arr, q, side="left").astype(np.int64)
            r2 = np.searchsorted(arr, q, side="right").astype(np.int64)
            less += sign * l2
            eq += sign * (r2 - l2)
        if len(side.tomb_run) and not self._ck:
            l2 = np.searchsorted(side.tomb_run, q,
                                 side="left").astype(np.int64)
            r2 = np.searchsorted(side.tomb_run, q,
                                 side="right").astype(np.int64)
            less -= l2
            eq -= r2 - l2
        return less, eq

    # ------------------------------------------------------------------ #
    # device placement of the sharded tiers                              #
    # ------------------------------------------------------------------ #
    def _place(self, side: _ClassSide, heal: bool = True) -> int:
        """(Re)place a sharded base run after it changed; returns the
        bytes shipped (unchanged rows are reused when the geometry
        holds). A failed placement heals and retries like a count; the
        heal's own re-placement (``heal=False``) fires no hook.
        Single device: a no-op, ``_runs`` places lazily."""
        if self.shards is None:
            return 0
        if len(side.base) == 0:
            side.base_dev, side.cap = None, 0
            side.placed_base = None
            return 0

        def attempt():
            return place_base(
                self._mesh, side.base, self.dtype,
                prev=(side.placed_base, side.base_dev, side.cap),
                metrics=self.metrics, chaos=self.chaos if heal else None)

        side.base_dev, side.cap, shipped = (
            self._healed(attempt) if heal else attempt())
        side.placed_base = side.base
        return shipped

    def _place_healed(self, arr: np.ndarray, prev=None):
        """Place ``arr`` on the current mesh under the heal-and-retry
        protocol, from any thread; returns (tensor, cap, bytes, mesh),
        the mesh it was placed on (a commit re-places it when a heal has
        replaced that mesh since)."""
        def attempt():
            with self._cv:
                mesh = self._mesh
            return (*place_base(mesh, arr, self.dtype, prev=prev,
                                metrics=self.metrics, chaos=self.chaos),
                    mesh)

        return self._healed(attempt)

    def _current(self, dev, cap: int, mesh, arr: np.ndarray):
        """(tensor, cap) of ``arr`` valid on the current mesh (lock held):
        a placement made on a mesh a heal has replaced is placed again."""
        if dev is not None and mesh is not self._mesh:
            dev, cap, _ = place_base(self._mesh, arr, self.dtype,
                                     metrics=self.metrics)
        return dev, cap

    def _replace_deltas(self, side: _ClassSide) -> None:
        """Rebuild the delta run's placement (a mesh change or a seeded
        state)."""
        if self.shards is None or len(side.delta_run) == 0:
            side.delta_dev, side.delta_cap = None, 0
            side.delta_rows = None
            return
        side.delta_dev, side.delta_cap, _ = place_base(
            self._mesh, side.delta_run, self.dtype, metrics=self.metrics)
        S = self._mesh.n_workers
        per = -(-len(side.delta_run) // S)
        side.delta_rows = np.clip(
            len(side.delta_run) - per * np.arange(S), 0, per
        ).astype(np.int64)

    def _replace_tomb(self, side: _ClassSide) -> None:
        """(Re)place the tombstone multiset's mirror: kernel mode only
        (the searchsorted route subtracts it on the host), reusing rows
        as ``place_base`` allows."""
        if (not self._ck or self.shards is None
                or len(side.tomb_run) == 0):
            side.tomb_dev, side.tomb_cap = None, 0
            side.placed_tomb = None
            return
        side.tomb_dev, side.tomb_cap, _ = place_base(
            self._mesh, side.tomb_run, self.dtype,
            prev=(side.placed_tomb, side.tomb_dev, side.tomb_cap),
            metrics=self.metrics)
        side.placed_tomb = side.tomb_run

    def _on_heal(self, healer) -> None:
        """After a heal round (the lock is held): adopt the possibly
        narrower mesh and rebuild every placement, base, delta and
        tombstones, from the host copies."""
        self._mesh = healer.mesh
        self.shards = healer.n_workers
        self._g_mesh.set(self.shards)
        with maybe_span(self.tracer, "heal.replace"):
            for side in (self._pos, self._neg):
                side.placed_base = None   # another mesh: no row reuse
                self._place(side, heal=False)
                self._replace_deltas(side)
                side.placed_tomb = None
                side.tomb_dev, side.tomb_cap = None, 0
                self._replace_tomb(side)

    def _cross2(self, p_vals: np.ndarray, n_side: _ClassSide) -> int:
        """Sum over p of 2*count_less(p in negs) + count_eq: the wins2
        contribution of positives ``p_vals`` against class ``n_side``."""
        if len(p_vals) == 0 or n_side.size == 0:
            return 0
        less, eq = self._counts(n_side, p_vals)
        return int(2 * less.sum() + eq.sum())

    def _cross2_rev(self, n_vals: np.ndarray, p_side: _ClassSide) -> int:
        """wins2 contribution of pairs (p in p_side, n in n_vals): per
        negative, 2*count_pos_greater + count_pos_eq."""
        if len(n_vals) == 0 or p_side.size == 0:
            return 0
        less, eq = self._counts(p_side, n_vals)
        greater = p_side.size - less - eq
        return int(2 * greater.sum() + eq.sum())

    @staticmethod
    def _cross2_arrays(p: np.ndarray, n: np.ndarray) -> int:
        """wins2 between two plain arrays (intra-batch pairs)."""
        if len(p) == 0 or len(n) == 0:
            return 0
        ns = np.sort(n)
        less = np.searchsorted(ns, p, side="left").astype(np.int64)
        leq = np.searchsorted(ns, p, side="right").astype(np.int64)
        return int(2 * less.sum() + (leq - less).sum())

    # ------------------------------------------------------------------ #
    # mutation                                                           #
    # ------------------------------------------------------------------ #
    def insert_batch(self, scores, labels) -> int:
        """Insert arrivals in order; returns the number inserted.

        ``labels`` truthy = positive class. The pair statistic after the
        call equals the batch statistic over (old set) + (batch), then
        window eviction trims to the last ``window`` arrivals.
        """
        scores = np.asarray(scores, dtype=self.dtype).ravel()
        labels = np.asarray(labels).ravel().astype(bool)
        if scores.shape != labels.shape:
            raise ValueError(
                f"scores/labels length mismatch: {scores.shape} vs "
                f"{labels.shape}")
        if len(scores) and not np.all(np.isfinite(scores)):
            raise ValueError("scores must be finite")
        p_new = scores[labels]
        n_new = scores[~labels]
        with self._cv:
            if self.engine == "torch":
                # insert and eviction counts in one device call
                self._apply_fused(scores, labels, p_new, n_new)
                self._maybe_compact()
                return len(scores)
            # new-vs-old (old sets untouched so far), then new-vs-new
            d = self._cross2(p_new, self._neg)
            d += self._cross2_rev(n_new, self._pos)
            d += self._cross2_arrays(p_new, n_new)
            self._wins2 += d
            self._pos.buf.extend(p_new.tolist())
            self._neg.buf.extend(n_new.tolist())
            self._log.extend(zip(scores.tolist(), labels.tolist()))
            if self.window is not None and len(self._log) > self.window:
                self._evict(len(self._log) - self.window)
            self._maybe_compact()
        return len(scores)

    def _apply_fused(self, scores: np.ndarray, labels: np.ndarray,
                     p_new: np.ndarray, n_new: np.ndarray) -> None:
        """Insert plus window eviction with one fused count: evictions
        are planned from (log ++ batch) before the device call, so the
        evicted values' base-run counts ride the same call as the
        insert queries (only the host buffer and log change during an
        insert; the base runs cannot). The host adjustments then run at
        the container states the unfused path uses (before the insert
        for the insert term, after it for the eviction term), so wins2
        is the same integer."""
        n_evict = 0
        p_out: List[float] = []
        n_out: List[float] = []
        if self.window is not None:
            n_evict = max(0, len(self._log) + len(scores) - self.window)
        if n_evict:
            pool = itertools.chain(
                self._log, zip(scores.tolist(), labels.tolist()))
            for v, is_pos in itertools.islice(pool, n_evict):
                (p_out if is_pos else n_out).append(v)
        p_out_arr = np.asarray(p_out, dtype=self.dtype)
        n_out_arr = np.asarray(n_out, dtype=self.dtype)
        # queries against the negatives (set a) and the positives (set b)
        ln, lqn, lp, lqp = self._signed_counts(
            (self._neg,), (self._pos,),
            np.concatenate([p_new, p_out_arr]),
            np.concatenate([n_new, n_out_arr]))
        kp, kn = len(p_new), len(n_new)
        # --- insert: new-vs-old (containers before the insert) -------- #
        less, eq = self._host_adjust(self._neg, p_new, ln[:kp], lqn[:kp])
        d = int(2 * less.sum() + eq.sum())
        less2, eq2 = self._host_adjust(self._pos, n_new, lp[:kn], lqp[:kn])
        greater = self._pos.size - less2 - eq2
        d += int(2 * greater.sum() + eq2.sum())
        d += self._cross2_arrays(p_new, n_new)
        self._wins2 += d
        self._pos.buf.extend(p_new.tolist())
        self._neg.buf.extend(n_new.tolist())
        self._log.extend(zip(scores.tolist(), labels.tolist()))
        # --- eviction: inclusion-exclusion (containers after it) ------ #
        if n_evict:
            less, eq = self._host_adjust(self._neg, p_out_arr,
                                         ln[kp:], lqn[kp:])
            d = int(2 * less.sum() + eq.sum())
            less2, eq2 = self._host_adjust(self._pos, n_out_arr,
                                           lp[kn:], lqp[kn:])
            greater = self._pos.size - less2 - eq2
            d += int(2 * greater.sum() + eq2.sum())
            d -= self._cross2_arrays(p_out_arr, n_out_arr)
            self._wins2 -= d
            for _ in range(n_evict):
                v, is_pos = self._log.popleft()
                self._drop(self._pos if is_pos else self._neg, v)
            self.n_evicted += n_evict
            self._update_gauges()

    def _evict(self, count: int) -> None:
        """Remove the ``count`` oldest arrivals from the statistic."""
        p_out: List[float] = []
        n_out: List[float] = []
        for _ in range(count):
            v, is_pos = self._log.popleft()
            (p_out if is_pos else n_out).append(v)
        p_arr = np.asarray(p_out, dtype=self.dtype)
        n_arr = np.asarray(n_out, dtype=self.dtype)
        # pairs with >= 1 evicted endpoint, inclusion-exclusion: the
        # P_e x N_e block is inside both cross terms (the containers
        # still hold the evicted values here, as the identity requires)
        d = self._cross2(p_arr, self._neg)
        d += self._cross2_rev(n_arr, self._pos)
        d -= self._cross2_arrays(p_arr, n_arr)
        self._wins2 -= d
        for side, vals in ((self._pos, p_out), (self._neg, n_out)):
            for v in vals:
                self._drop(side, v)
        self.n_evicted += count
        self._update_gauges()

    @staticmethod
    def _drop(side: _ClassSide, v: float) -> None:
        """Remove one evicted copy of ``v``: from the unsnapshotted
        buffer suffix when it is there (an in-flight build owns the
        prefix), else as a tombstone."""
        try:
            i = side.buf.index(v, side.snap_buf)
            side.buf.pop(i)
        except ValueError:
            side.tomb.append(v)

    def _side_name(self, side: _ClassSide) -> str:
        return "pos" if side is self._pos else "neg"

    def _update_gauges(self) -> None:
        """Refresh the container gauges (caller holds the lock or owns
        the containers)."""
        self._g_delta.set(len(self._pos.delta_run)
                          + len(self._neg.delta_run))
        self._g_tomb.set(len(self._pos.tomb_run) + len(self._neg.tomb_run)
                         + len(self._pos.tomb) + len(self._neg.tomb))
        if self.shards is not None:
            bal = shard_balance(self.shard_occupancy())
            self._g_skew.set(bal["skew"])
            self._g_skew_cv.set(bal["cv"])

    def shard_occupancy(self) -> list:
        """Per-shard placed row counts (base + delta), both classes
        summed: shard s of an n-row run holds ``clip(n - s*ceil(n/S), 0,
        ceil(n/S))`` rows (the skew gauges read it)."""
        S = self.shards or 1
        counts = np.zeros(S, dtype=np.int64)
        for side in (self._pos, self._neg):
            for arr in (side.placed_base
                        if side.placed_base is not None else side.base,
                        side.delta_run):
                n = len(arr)
                if n:
                    per = -(-n // S)
                    counts += np.clip(n - per * np.arange(S), 0, per)
        return counts.tolist()

    def _flight_event(self, kind: str, **fields) -> None:
        if self.flight is not None:
            self.flight.record(kind, **fields)

    def _maybe_compact(self) -> None:
        bg_ok = self._ensure_compactor() if self.bg_compact else False
        for side in (self._pos, self._neg):
            buf_pending, tomb_pending = side.pending
            if (buf_pending >= self.compact_every
                    or tomb_pending >= self.compact_every):
                if self.bg_compact and bg_ok:
                    self._submit_compact(side)
                elif not side.building:
                    # synchronous mode, or the compactor thread died (a
                    # crashed build): compact inline rather than let the
                    # buffer grow without bound; a side mid-build is left
                    # to the restarted worker
                    self._compact_side(side)

    def _ensure_compactor(self) -> bool:
        """Watchdog (caller holds the lock): True when the background
        compactor is alive. A dead worker is restarted
        (``bg_compactor_restarts``) and False returned, so the caller
        compacts synchronously this once."""
        if self._compactor.is_alive():
            return True
        if not self._closed:
            self._c_bg_restarts.inc()
            self._compactor = threading.Thread(
                target=self._compact_worker, name="tuplewise-compactor",
                daemon=True)
            self._compactor.start()
        return False

    def _drain_builds(self, timeout: float, what: str) -> None:
        """Wait until no build is queued or in flight, restarting a dead
        compactor along the way."""
        deadline = time.monotonic() + timeout
        while self._pos.building or self._neg.building:
            if self.bg_compact:
                self._ensure_compactor()
            if (not self._cv.wait(timeout=0.25)
                    and time.monotonic() >= deadline):
                raise TimeoutError(what)

    def wait_idle(self, timeout: float = 30.0) -> None:
        """Block until no background build is queued or in flight."""
        with self._cv:
            self._drain_builds(timeout, "background compaction stuck")

    def compact(self) -> None:
        """Force both sides into a single sorted base run, dropping the
        tombstones, after draining any in-flight background builds."""
        with self._cv:
            self._drain_builds(30.0, "background compaction stuck")
            for side in (self._pos, self._neg):
                if (side.buf or side.tomb or len(side.delta_run)
                        or len(side.tomb_run)):
                    self._full_compact(side)

    def _merge(self, side_base: np.ndarray, buf: List[float],
               tomb: List[float], on_thread: bool) -> np.ndarray:
        """Pure merge: sorted(base + buf) minus tombstones.

        ``on_thread`` (synchronous single-device ``engine="torch"``
        compaction) sorts on the device: the caller's thread already owns
        it. The background and sharded merges stay on the host: a device
        sort there would queue behind the batcher's counts on the same
        stream. The host path sorts only the buffer and splices it in,
        O(n + b log b). The values are the same either way."""
        buf_sorted = np.sort(np.asarray(buf, dtype=self.dtype))
        if len(buf_sorted) == 0:
            merged = side_base
        elif on_thread and self.engine == "torch" and self.shards is None:
            t = torch.from_numpy(np.concatenate([side_base, buf_sorted]))
            merged = torch.sort(t.to(self.device)).values.cpu().numpy()
        else:
            merged = _splice_merge(side_base, buf_sorted)
        return _remove_sorted(merged, tomb)

    # ------------------------------------------------------------------ #
    # compaction tiers                                                   #
    # ------------------------------------------------------------------ #
    def _compact_side(self, side: _ClassSide) -> None:
        """Synchronous compaction (caller holds the lock), its pause
        billed inline. In the delta tiers that pause is O(buffer): a
        minor compaction, then whatever heavier tier falls due."""
        with maybe_span(self.tracer, "compaction.sync",
                        side=self._side_name(side)):
            if not self._delta:
                self._full_compact(side)
                return
            buf_vals, tomb_vals = list(side.buf), list(side.tomb)
            t0 = time.perf_counter()
            new_delta, placed = self._healed(
                lambda: self._build_delta(side, buf_vals))
            side.buf = []
            side.tomb = []
            self._commit_minor(side, new_delta, placed, tomb_vals, t0)
            todo = self._followup(side)
            if todo == "major":
                t0 = time.perf_counter()
                with maybe_span(self.tracer, "compaction.major"):
                    self._commit_major(side, self._major_build(side), t0,
                                       t0)
            elif todo == "full":
                self._full_compact(side)

    def _build_delta(self, side: _ClassSide, buf_vals: List[float]):
        """Merge the pending buffer into the consolidated delta run: the
        host copy by a splice, the device copy by shipping only the
        sorted chunk and rank-merging it into each worker's delta row
        (counting is additive over any partition into sorted runs, so
        the rows need no rebalancing). Returns (new_delta_host, (tensor,
        cap, bytes, rows, mesh) or None). Caller owns the delta state; the
        mesh and the placement are read together under the lock (a heal
        on another thread replaces both)."""
        chunk = np.sort(np.asarray(buf_vals, dtype=self.dtype))
        if len(chunk) == 0:
            return side.delta_run, None     # a tombstone-only minor
        new_delta = _splice_merge(side.delta_run, chunk)
        with self._cv:
            mesh, delta_dev = self._mesh, side.delta_dev
            delta_cap, delta_rows = side.delta_cap, side.delta_rows
        S = mesh.n_workers
        if delta_dev is None:
            # the first minor after a fold: place the fresh run
            dev, cap, shipped = place_base(
                mesh, new_delta, self.dtype, metrics=self.metrics,
                chaos=self.chaos)
            per = -(-len(new_delta) // S)
            rows = np.clip(len(new_delta) - per * np.arange(S),
                           0, per).astype(np.int64)
            return new_delta, (dev, cap, shipped, rows, mesh)
        chunk_dev, chunk_cap, shipped = place_base(
            mesh, chunk, self.dtype, metrics=self.metrics, chaos=self.chaos)
        per_c = -(-len(chunk) // S)
        rows = delta_rows + np.clip(
            len(chunk) - per_c * np.arange(S), 0, per_c)
        cap_new = next_bucket(int(rows.max()))
        dev = delta_append(delta_dev, delta_cap, chunk_dev, chunk_cap,
                           cap_new)
        return new_delta, (dev, cap_new, shipped, rows, mesh)

    def _commit_minor(self, side: _ClassSide, new_delta: np.ndarray,
                      placed, tomb_vals: List[float], t0: float) -> None:
        """Adopt a minor compaction (lock held): swap in the delta run,
        fold fresh tombstones into the tombstone multiset. Counts are
        unchanged: the same values moved between containers whose counts
        add and subtract."""
        if placed is not None:
            dev, cap, shipped, rows, mesh = placed
            side.delta_run = new_delta
            side.delta_dev, side.delta_cap = dev, cap
            side.delta_rows = rows
            if mesh is not self._mesh:
                # healed meanwhile: the rows belong to the old mesh
                self._replace_deltas(side)
            side.delta_minors += 1
            self._h_compaction_bytes.observe(shipped)
        if tomb_vals:
            side.tomb_run = _splice_merge(
                side.tomb_run,
                np.sort(np.asarray(tomb_vals, dtype=self.dtype)))
            self._replace_tomb(side)
        self.n_compactions += 1
        self._c_compactions.inc()
        self._update_gauges()
        self._flight_event(
            "compaction", tier="minor", side=self._side_name(side),
            delta_events=len(side.delta_run),
            bytes_shipped=(placed[2] if placed is not None else 0))
        self._h_pause.observe(time.perf_counter() - t0)

    def _followup(self, side: _ClassSide) -> Optional[str]:
        """The heavier tier a minor compaction leaves due, if any: "full"
        when the tombstone multiset outgrew the base fraction (only a
        host rebuild drops tombstones), "major" when the delta outgrew
        ``delta_fraction`` of the base or ``max_delta_runs`` minors were
        merged into it."""
        if len(side.tomb_run) >= max(
                self.compact_every,
                int(self.delta_fraction * len(side.base))):
            return "full"
        if len(side.delta_run) and (
                len(side.delta_run)
                > self.delta_fraction * max(len(side.base), 1)
                or side.delta_minors >= self.max_delta_runs):
            return "major"
        return None

    def _major_build(self, side: _ClassSide):
        """Fold the delta run into the base; returns (merged_host,
        tensor, cap). The host copy is a splice; the device copy is
        built on the mesh (zero run bytes from the host) when the plan
        fits the one-hop exchange, else by a full re-placement. An
        injected fault, or a failure the healer finds to be a lost
        worker, takes the re-placement and counts in
        ``major_merge_fallbacks``; any other exception propagates.
        Caller owns base and delta; the mesh and the placements are read
        together under the lock, and the mesh is returned with the
        result (a heal on another thread replaces both)."""
        with self._cv:
            mesh, base_dev, cap = self._mesh, side.base_dev, side.cap
            delta_dev, delta_cap = side.delta_dev, side.delta_cap
        base = side.base
        merged = _splice_merge(base, side.delta_run)
        S = mesh.n_workers
        if (len(base) and base_dev is not None and delta_dev is not None
                and S >= 2):
            plan = plan_major_merge(base, side.delta_run, S)
            if plan.ok:
                try:
                    dev, cap_out = sharded_major_merge(
                        mesh, base_dev, cap, ((delta_dev, delta_cap),),
                        plan, chaos=self.chaos)
                    # the bytes a host merge would have re-shipped
                    self._c_bytes_saved.inc(S * cap_out * 4)
                    return merged, dev, cap_out, mesh
                except InjectedFault as e:
                    self._major_fallback(side, e)
                except Exception as e:  # noqa: BLE001 — unless lost
                    if not self._healer.lost_worker():
                        raise
                    self._major_fallback(side, e)
        # S = 1, an empty base, a plan past one hop, or a fallback: the
        # host merge, re-placed in full
        dev, cap_out, _ = place_base(mesh, merged, self.dtype,
                                     metrics=self.metrics)
        return merged, dev, cap_out, mesh

    def _major_fallback(self, side: _ClassSide, e: Exception) -> None:
        self._c_major_fb.inc()
        self.last_major_merge_error = repr(e)
        self._flight_event("major_merge_fallback",
                           side=self._side_name(side), error=repr(e))

    def _commit_major(self, side: _ClassSide, built, t_build0: float,
                      t_pause0: float) -> None:
        """Swap a major merge in (lock held): rebind the base, clear the
        folded delta run, keep the tombstones (their counts still
        subtract). A merge built on a mesh a heal has since replaced is
        re-placed on the current one."""
        merged, dev, cap, mesh = built
        dev, cap = self._current(dev, cap, mesh, merged)
        side.base = merged
        side.placed_base = merged
        side.base_dev, side.cap = dev, cap
        side.clear_delta()
        self.n_compactions += 1
        self._c_compactions.inc()
        self.n_major_merges += 1
        self._c_major.inc()
        self._update_gauges()
        now = time.perf_counter()
        self._flight_event("major_merge", side=self._side_name(side),
                           base_events=len(merged), build_s=now - t_build0)
        self._h_major.observe(now - t_build0)
        self._h_pause.observe(now - t_pause0)

    def _full_compact(self, side: _ClassSide) -> None:
        """Fold everything (base, delta run, buffer) into one sorted base
        run, dropping the tombstones, and re-place it (caller holds the
        lock); the work and its pause run inline."""
        t0 = time.perf_counter()
        tombs = side.tomb_run.tolist() + side.tomb
        if len(side.delta_run):
            merged = _remove_sorted(
                _splice_merge(
                    _splice_merge(side.base, side.delta_run),
                    np.sort(np.asarray(side.buf, dtype=self.dtype))),
                tombs)
        else:
            merged = self._merge(side.base, side.buf, tombs,
                                 on_thread=True)
        side.base = merged
        side.buf = []
        side.tomb = []
        side.clear_delta()
        side.tomb_run = np.empty(0, dtype=self.dtype)
        self._replace_tomb(side)    # clears the device mirror
        shipped = self._place(side)
        if not self._delta:
            # the host-merge mode's compaction: the bytes the delta tiers
            # are judged against
            self._h_compaction_bytes.observe(shipped)
        self.n_compactions += 1
        self._c_compactions.inc()
        self._update_gauges()
        self._flight_event("compaction", tier="full",
                           side=self._side_name(side),
                           base_events=len(merged), bytes_shipped=shipped)
        self._h_pause.observe(time.perf_counter() - t0)

    # ------------------------------------------------------------------ #
    # background compaction                                              #
    # ------------------------------------------------------------------ #
    def _submit_compact(self, side: _ClassSide) -> None:
        """Snapshot the side's consumable prefix and enqueue a build
        (caller holds the lock); a no-op while a build is in flight."""
        if side.building:
            return
        side.building = True
        side.snap_buf = len(side.buf)
        side.snap_tomb = len(side.tomb)
        self._jobs.put(side)

    def _compact_worker(self) -> None:
        while True:
            side = self._jobs.get()
            if side is None:
                return
            try:
                self._build_and_swap(side)
            except BaseException as e:
                # roll back the snapshot claim so nothing is lost (the
                # buffer and tombstones still hold every value, and wins2
                # was never touched), keep the error, and die: the
                # watchdog restarts the thread and counts the restart
                with self._cv:
                    side.snap_buf = side.snap_tomb = 0
                    side.building = False
                    self.last_compactor_error = repr(e)
                    self._cv.notify_all()
                return

    def _build_and_swap(self, side: _ClassSide) -> None:
        if self._bg_test_hook is not None:
            self._bg_test_hook(side)
        with maybe_span(self.tracer, "compactor.build",
                        side=self._side_name(side)) as bspan:
            if self.chaos is not None:
                self.chaos.fire("compactor_build")
            if self._delta:
                self._bg_delta_build(side)
                return
            self._bg_merge_build(side, bspan)

    def _bg_merge_build(self, side: _ClassSide, bspan) -> None:
        """The host-merge background job: merge and place with the lock
        released, then swap (``bspan``: the build's span, None untraced)."""
        with self._cv:
            base = side.base
            prev = (side.placed_base, side.base_dev, side.cap)
            buf_snap = list(side.buf[: side.snap_buf])
            tomb_snap = list(side.tomb[: side.snap_tomb])
        # the merge (and, sharded, the placement) runs with the lock
        # released; inserts keep landing in the buffer
        with maybe_span(self.tracer, "compactor.merge",
                        n_buf=len(buf_snap)):
            merged = self._merge(base, buf_snap, tomb_snap, on_thread=False)
        base_dev, cap, shipped, mesh = None, 0, 0, None
        if self.shards is not None and len(merged):
            with maybe_span(self.tracer, "compactor.place_base"):
                base_dev, cap, shipped, mesh = self._place_healed(merged,
                                                                  prev)
        with self._cv:
            t0 = time.perf_counter()
            side.base = merged
            if self.shards is not None:
                side.base_dev, side.cap = self._current(base_dev, cap, mesh,
                                                        merged)
                side.placed_base = merged if base_dev is not None else None
                self._h_compaction_bytes.observe(shipped)
            del side.buf[: side.snap_buf]
            del side.tomb[: side.snap_tomb]
            side.snap_buf = side.snap_tomb = 0
            side.building = False
            self.n_compactions += 1
            self._c_compactions.inc()
            self._update_gauges()
            self._flight_event("compaction", tier="bg_merge",
                               side=self._side_name(side),
                               base_events=len(merged),
                               bytes_shipped=shipped)
            # the swap is the only pause the request path can observe
            t1 = time.perf_counter()
            self._h_pause.observe(t1 - t0)
            if self.tracer is not None:
                self.tracer.record_span("compactor.swap", t0, t1,
                                        parent=bspan)
            self._resubmit(side)

    def _resubmit(self, side: _ClassSide) -> None:
        """Keep draining if the buffer outgrew the threshold while a
        build ran (lock held)."""
        buf_pending, tomb_pending = side.pending
        if (not self._closed
                and (buf_pending >= self.compact_every
                     or tomb_pending >= self.compact_every)):
            self._submit_compact(side)
        self._cv.notify_all()

    def _bg_delta_build(self, side: _ClassSide) -> None:
        """A delta-tier background job: an O(buffer) minor build and
        swap, then, still on the worker thread with the side claimed,
        whatever heavier tier fell due. The request path's only pauses
        are the swaps."""
        with self._cv:
            buf_snap = list(side.buf[: side.snap_buf])
            tomb_snap = list(side.tomb[: side.snap_tomb])
        with maybe_span(self.tracer, "compactor.minor_build",
                        n_buf=len(buf_snap)):
            new_delta, placed = self._healed(
                lambda: self._build_delta(side, buf_snap))
        with self._cv:
            t0 = time.perf_counter()
            self._commit_minor(side, new_delta, placed, tomb_snap, t0)
            del side.buf[: side.snap_buf]
            del side.tomb[: side.snap_tomb]
            side.snap_buf = side.snap_tomb = 0
            todo = self._followup(side)
        # base, delta_run and tomb_run stay the worker's until the job
        # ends: _submit_compact refuses a new claim while building, and
        # the watchdog's synchronous fallback skips a building side
        if todo == "major":
            t0 = time.perf_counter()
            with maybe_span(self.tracer, "compactor.major_build"):
                built = self._major_build(side)
            with self._cv:
                self._commit_major(side, built, t0, time.perf_counter())
        elif todo == "full":
            # tombstone overflow: base + delta minus the tombstone
            # multiset on the host, leaving the (unclaimed) buffer and
            # pending tombstones alone
            merged = _remove_sorted(
                _splice_merge(side.base, side.delta_run),
                side.tomb_run.tolist())
            dev, cap, mesh = None, 0, None
            if len(merged):
                dev, cap, _, mesh = self._place_healed(merged)
            with self._cv:
                t0 = time.perf_counter()
                side.base = merged
                side.base_dev, side.cap = self._current(dev, cap, mesh,
                                                        merged)
                side.placed_base = merged if dev is not None else None
                side.clear_delta()
                side.tomb_run = np.empty(0, dtype=self.dtype)
                self._replace_tomb(side)    # clears the device mirror
                self.n_compactions += 1
                self._c_compactions.inc()
                self._update_gauges()
                self._flight_event("compaction", tier="full",
                                   side=self._side_name(side),
                                   base_events=len(merged))
                self._h_pause.observe(time.perf_counter() - t0)
        with self._cv:
            side.building = False
            self._resubmit(side)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the background compactor (a no-op in synchronous mode)."""
        if not self.bg_compact or self._closed:
            self._closed = True
            return
        self._closed = True
        self._jobs.put(None)
        self._compactor.join(timeout=timeout)

    def __enter__(self) -> "ExactAucIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # queries                                                            #
    # ------------------------------------------------------------------ #
    @property
    def n_pos(self) -> int:
        with self._cv:
            return self._pos.size

    @property
    def n_neg(self) -> int:
        with self._cv:
            return self._neg.size

    @property
    def n_events(self) -> int:
        with self._cv:
            return len(self._log)

    def auc(self) -> Optional[float]:
        """Exact AUC of the current window; None until both classes have
        at least one member."""
        with self._cv:
            if self._pos.size == 0 or self._neg.size == 0:
                return None
            return self._wins2 / (2.0 * self._pos.size * self._neg.size)

    def score_batch(self, scores) -> np.ndarray:
        """Fractional rank of each score against the current negatives:
        (count_less + 0.5*count_eq) / n_neg. NaN when no negatives yet."""
        q = np.asarray(scores, dtype=self.dtype).ravel()
        with self._cv:
            if self._neg.size == 0:
                return np.full(len(q), np.nan)
            less, eq = self._counts(self._neg, q)
            return (less + 0.5 * eq) / float(self._neg.size)

    def oracle_values(self) -> Tuple[np.ndarray, np.ndarray]:
        """(pos, neg) multisets of the current window, for the batch
        oracle. O(n); not a hot path."""
        with self._cv:
            return self._pos.values(), self._neg.values()

    # ------------------------------------------------------------------ #
    # state transfer                                                     #
    # ------------------------------------------------------------------ #
    def seed_state(self, pos_vals, neg_vals, log, wins2: int,
                   n_evicted: int = 0) -> None:
        """Adopt an exact state kept elsewhere, in the JAX index's
        ``export_state`` layout: the sorted class multisets become the
        base runs, the arrival log and the integer ``wins2`` carry over
        as they are. Every count is an integer function of the multiset,
        so the index's later outputs equal the donor's bit for bit. Call
        on a fresh index (no events, no in-flight builds)."""
        with self._cv:
            self._pos.base = np.sort(np.asarray(pos_vals, dtype=self.dtype))
            self._neg.base = np.sort(np.asarray(neg_vals, dtype=self.dtype))
            self._log = collections.deque(log)
            self._wins2 = int(wins2)
            self.n_evicted = int(n_evicted)
            for side in (self._pos, self._neg):
                side.placed_base = None
                self._place(side)
                self._replace_deltas(side)
                self._replace_tomb(side)
            self._update_gauges()

    def export_state(self) -> Tuple[np.ndarray, np.ndarray, list, int,
                                    int]:
        """``(pos_sorted, neg_sorted, log, wins2, n_evicted)`` of the
        current window, the layout :meth:`seed_state` (of either
        package) takes. Consistent at any time: the container invariant
        holds under the lock even mid-build."""
        with self._cv:
            return (self._pos.values(), self._neg.values(),
                    list(self._log), self._wins2, self.n_evicted)

    def state(self) -> dict:
        """The JAX index's state keys, and the port's ``count_kernel``
        and ``device``."""
        with self._cv:
            return {
                "n_pos": self._pos.size,
                "n_neg": self._neg.size,
                "n_events": len(self._log),
                "auc": self.auc(),
                "n_compactions": self.n_compactions,
                "n_evicted": self.n_evicted,
                "buf_pos": len(self._pos.buf),
                "buf_neg": len(self._neg.buf),
                "engine": self.engine,
                "window": self.window,
                "shards": self.shards,
                "bg_compact": self.bg_compact,
                "last_compactor_error": self.last_compactor_error,
                "delta_compact": self._delta,
                "delta_runs": (self._pos.delta_minors
                               + self._neg.delta_minors),
                "delta_events": (len(self._pos.delta_run)
                                 + len(self._neg.delta_run)),
                "tombstones": (len(self._pos.tomb_run)
                               + len(self._neg.tomb_run)
                               + len(self._pos.tomb) + len(self._neg.tomb)),
                "n_major_merges": self.n_major_merges,
                "last_major_merge_error": self.last_major_merge_error,
                "count_kernel": self._ck,
                "device": None if self.device is None else str(self.device),
            }
