"""Multi-tenant serving fleet on one device: thousands of per-tenant exact
AUC statistics counted through shared device packs.

The single-device counterpart of ``tuplewise_tpu.serving.tenancy``.

* :class:`TenantFleetIndex` keeps each tenant's LSM containers on the
  host (a sorted base run per class, a small insert buffer, tombstones,
  the arrival log and the exact integer ``wins2``) and, on the device,
  every tenant's base run of one class as a row of one shared
  +inf-padded ``[T_bucket, cap]`` pack
  (``parallel.sharded_counts.place_tenant_pack``). One fleet count
  serves a whole coalesced multi-tenant batch: insert counts,
  window-eviction counts and score ranks of every tenant the batch
  touched (``tenant_pack_counts``). ``count_kernel`` picks only the route
  of that one call: True is one launch of kernel 7 (``csrc/
  tenant_count.cu``), False the batched ``torch.searchsorted`` route. The
  integers are the same, so every tenant's AUC equals a dedicated
  ``ExactAucIndex`` fed the same events, bit for bit.

  Placement is incremental: a compaction, drop, slot reuse or promotion
  marks only its slot dirty, and the next count ships only the dirty
  rows into the resident pack (``index_copy_``); a new ``T_bucket`` or a
  larger cap ships the whole pack. A tenant crossing ``whale_threshold``
  live events moves into its own :class:`~tuplewise_tpu_torch.serving.
  index.ExactAucIndex` (kernel 6 on its own runs) and moves back below
  the hysteresis floor; wins2 and the log transfer verbatim. With
  ``bg_compact`` the per-tenant splice runs on a side thread that merges
  host arrays only: all device work (placement and counts) runs on the
  caller's thread, on the default stream, under the fleet lock.

* :class:`MultiTenantEngine` is the request path: per-tenant FIFO queues
  with admission control (per-tenant quotas and a fleet-wide tenant cap,
  typed :class:`TenantRejectedError`), a deficit-round-robin drain so one
  hot tenant cannot starve the others, tenant lifecycle (create on first
  request, drop, idle eviction), control-plane throttles and per-tenant
  weights and quotas, per-tenant incomplete-U streams seeded by
  :func:`tenant_seed`, and per-tenant labeled metrics with a cardinality
  cap.

The mesh form (``shards=S`` / ``mesh=``, ``mesh_shards`` on the engine)
splits every tenant's run into S contiguous slices over the workers of a
1-D ``parallel.mesh.Mesh``: the packs become ``[S, T_bucket, cap]``
(worker w's slice of slot t in row ``[w, t]``), a fleet count is one
launch of kernel 7 over the worker axis (or one batched searchsorted a
side and bound) whose per-worker blocks are added over the mesh, and a
dirty-row update ships each worker's rows of the dirty slots. Counting is
additive over any partition, so every tenant's counts are the same
integers at every S. A failed count heals (``parallel.self_heal.
MeshHealer``, shrink policy: the lost workers dropped, the packs
re-placed from the host runs) and retries; :meth:`TenantFleetIndex.
resize_shards` re-widths the mesh on purpose. Whales promoted from a
mesh fleet get a sharded index on the fleet's mesh. A ``chaos`` injector
fires the ``sharded_count``, ``place_base``, ``compactor_build`` and
(engine) ``batcher`` points.

Not ported yet: span tracing (``tracer``) and crash-safe recovery
(``snapshot_dir``/``recover``); they raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from tuplewise_tpu_torch.obs.flight import FlightRecorder
from tuplewise_tpu_torch.obs.ledger import WaveLedger
from tuplewise_tpu_torch.obs.tracing import check_tracer, maybe_span
from tuplewise_tpu_torch.parallel.self_heal import (
    Backoff, HealExhaustedError, MeshHealer,
)
from tuplewise_tpu_torch.parallel.sharded_counts import (
    next_bucket, place_tenant_pack, tenant_bucket, tenant_pack_counts,
)
from tuplewise_tpu_torch.serving.engine import (
    BackpressureError, DeadlineExceededError, EngineClosedError,
    PoisonEventError, ServingConfig,
)
from tuplewise_tpu_torch.serving.index import (
    ExactAucIndex, _remove_sorted, _splice_merge,
)
from tuplewise_tpu_torch.serving.streaming import StreamingIncompleteU
from tuplewise_tpu_torch.testing.chaos import InjectedFault
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry


class TenantRejectedError(RuntimeError):
    """Admission control shed this request: the tenant's queue quota is
    exceeded, or the fleet is at its tenant cap. Carries the tenant id."""

    def __init__(self, msg: str, tenant: Optional[str] = None):
        super().__init__(msg)
        self.tenant = tenant


class TenantThrottledError(RuntimeError):
    """The tenant is throttled for a while (a reversible control-plane
    actuation); retry after ``retry_after_s`` seconds."""

    def __init__(self, msg: str, tenant: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class TenancyConfig:
    """Fleet-level knobs layered over a :class:`ServingConfig`.

    Args:
      max_tenants: cap on live tenants; creating past it raises
        :class:`TenantRejectedError`.
      tenant_quota: max queued (unapplied) requests per tenant.
      weight: requests a tenant may contribute per fair-scheduling round
        (the deficit-round-robin quantum).
      idle_evict_s: drop tenants idle longer than this (None = never).
      min_tenant_bucket: floor of the packs' T axis.
      tenant_metrics: export per-tenant labeled metrics
        (``insert_latency_s{tenant=}`` etc.).
      tenant_metric_cap: at most this many tenants get their own labeled
        series; later ones share one ``{tenant=__other__}`` series.
        None = unbounded.
      whale_threshold: promote a tenant to its own ``ExactAucIndex`` once
        its live event count reaches this; None = never.
      whale_demote_fraction: demote a promoted tenant once its live event
        count falls below ``whale_threshold * fraction`` (hysteresis).
    """

    max_tenants: int = 1024
    tenant_quota: int = 64
    weight: int = 8
    idle_evict_s: Optional[float] = None
    min_tenant_bucket: int = 8
    tenant_metrics: bool = True
    tenant_metric_cap: Optional[int] = None
    whale_threshold: Optional[int] = None
    whale_demote_fraction: float = 0.5

    def __post_init__(self):
        if self.max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1: {self.max_tenants}")
        if self.tenant_quota < 1:
            raise ValueError(
                f"tenant_quota must be >= 1: {self.tenant_quota}")
        if self.weight < 1:
            raise ValueError(f"weight must be >= 1: {self.weight}")
        if self.idle_evict_s is not None and self.idle_evict_s <= 0:
            raise ValueError(
                f"idle_evict_s must be > 0: {self.idle_evict_s}")
        if self.min_tenant_bucket < 1:
            raise ValueError(
                f"min_tenant_bucket must be >= 1: {self.min_tenant_bucket}")
        if self.tenant_metric_cap is not None \
                and self.tenant_metric_cap < 1:
            raise ValueError(
                f"tenant_metric_cap must be >= 1: "
                f"{self.tenant_metric_cap}")
        if self.whale_threshold is not None and self.whale_threshold < 2:
            raise ValueError(
                f"whale_threshold must be >= 2: {self.whale_threshold}")
        if not 0.0 <= self.whale_demote_fraction < 1.0:
            raise ValueError(
                f"whale_demote_fraction must be in [0, 1): "
                f"{self.whale_demote_fraction}")


def tenant_seed(base_seed: int, tid: str) -> int:
    """Deterministic per-tenant RNG seed, stable across processes (the
    same sha256 derivation as the JAX package)."""
    h = hashlib.sha256(f"{base_seed}:{tid}".encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big")


class _TenantStat:
    """One tenant's host-authoritative exact-AUC state: the single-tenant
    index's LSM containers without the device copies (the fleet packs
    hold those).

    ``idx`` is the promoted whale's own index: while it is set every
    read and write routes there and the containers here stay empty.
    ``building`` and the ``snap_*`` prefix lengths are the claim of an
    in-flight background build: mutators only append to the unclaimed
    suffix and evictions only remove from it (else tombstone)."""

    __slots__ = ("tid", "slot", "pos_base", "neg_base", "pos_buf",
                 "neg_buf", "pos_tomb", "neg_tomb", "log", "wins2",
                 "n_evicted", "n_compactions", "last_active", "idx",
                 "building", "snap_pos_buf", "snap_neg_buf",
                 "snap_pos_tomb", "snap_neg_tomb")

    def __init__(self, tid: str, slot: int, dtype):
        self.tid = tid
        self.slot = slot
        self.pos_base = np.empty(0, dtype=dtype)
        self.neg_base = np.empty(0, dtype=dtype)
        self.pos_buf: List[float] = []
        self.neg_buf: List[float] = []
        self.pos_tomb: List[float] = []
        self.neg_tomb: List[float] = []
        self.log: Deque[Tuple[float, bool]] = collections.deque()
        self.wins2 = 0              # exact: a Python int never overflows
        self.n_evicted = 0
        self.n_compactions = 0
        self.last_active = time.monotonic()
        self.idx = None             # the promoted whale's index
        self.building = False
        self.snap_pos_buf = 0
        self.snap_neg_buf = 0
        self.snap_pos_tomb = 0
        self.snap_neg_tomb = 0

    def side(self, pos: bool):
        if pos:
            return self.pos_base, self.pos_buf, self.pos_tomb
        return self.neg_base, self.neg_buf, self.neg_tomb

    def snap(self, pos: bool) -> Tuple[int, int]:
        """(buf, tomb) prefix lengths claimed by an in-flight build."""
        if pos:
            return self.snap_pos_buf, self.snap_pos_tomb
        return self.snap_neg_buf, self.snap_neg_tomb

    def pending(self) -> Tuple[int, int]:
        """(buf, tomb) entries not claimed by a build: what a new
        compaction would consume."""
        return (len(self.pos_buf) + len(self.neg_buf)
                - self.snap_pos_buf - self.snap_neg_buf,
                len(self.pos_tomb) + len(self.neg_tomb)
                - self.snap_pos_tomb - self.snap_neg_tomb)

    def size(self, pos: bool) -> int:
        base, buf, tomb = self.side(pos)
        return len(base) + len(buf) - len(tomb)

    def values(self, pos: bool) -> np.ndarray:
        """Current class multiset (oracle path, O(n))."""
        base, buf, tomb = self.side(pos)
        out = np.sort(np.concatenate(
            [base, np.asarray(buf, dtype=base.dtype)]), kind="stable")
        return _remove_sorted(out, list(tomb))


class _Pack:
    """One class's shared device pack and its placement geometry.

    ``dirty_slots``: the rows changed since the resident placement (the
    next placement ships only those); ``dirty_all`` forces a full ship.
    ``row_events``: the run length placed per slot, read by the occupancy
    and stale-row gauges."""

    __slots__ = ("dev", "cap", "t_bucket", "dirty_all", "dirty_slots",
                 "row_events")

    def __init__(self):
        self.dev = None
        self.cap = 0
        self.t_bucket = 0
        self.dirty_all = True
        self.dirty_slots: set = set()
        self.row_events: List[int] = []

    @property
    def dirty(self) -> bool:
        return self.dirty_all or bool(self.dirty_slots)

    def mark(self, slot: int) -> None:
        if not self.dirty_all:
            self.dirty_slots.add(slot)

    def mark_all(self) -> None:
        self.dirty_all = True
        self.dirty_slots.clear()


class TenantFleetIndex:
    """Exact per-tenant AUC for a fleet, counted through shared packs.

    Args:
      window: per-tenant sliding window (arrivals); None = unbounded.
      compact_every: per-tenant buffer/tombstone size that triggers that
        tenant's compaction (host splice, then its pack rows re-ship).
      device: where the packs live and the counts run: the card unless
        the caller asks for the CPU (``device="cpu"``, the plain
        versions). With no card and no device it raises.
      count_kernel: each fleet count is one launch of kernel 7; False
        counts with batched ``torch.searchsorted``. Same integers.
      min_tenant_bucket: floor of the packs' T axis.
      bg_compact: tenant compactions run on a side thread. Not on a
        distributed mesh (ValueError): its collectives stay on the
        caller's thread, in one order on every rank.
      whale_threshold / whale_demote_fraction: whale promotion and its
        demotion floor (None = never promote).
      incremental_placement: ship only dirty pack rows when the geometry
        allows (False: every placement ships the whole pack).
      metrics / flight: a ``MetricsRegistry`` (None = a private one) and
        an optional ``FlightRecorder``.
      shards: None = single-device packs; an int S >= 1 shards every
        tenant's runs over a mesh of S workers on ``device``'s worker
        axis; the counts are the same integers at every S.
      mesh: an existing 1-D ``parallel.mesh.Mesh`` (overrides ``shards``
        and ``device``).
      chaos: a ``testing.chaos.FaultInjector``: counts fire
        ``sharded_count``, placements ``place_base``, compactions
        ``compactor_build``.
      shard_retries / retry_backoff_s / probe_timeout_s: the heal-and-
        retry of a mesh count.
      tracer: not ported yet; anything but None raises.
    """

    def __init__(self, window: Optional[int] = None,
                 compact_every: int = 512, device=None,
                 count_kernel: bool = False, min_tenant_bucket: int = 8,
                 bg_compact: bool = False,
                 whale_threshold: Optional[int] = None,
                 whale_demote_fraction: float = 0.5,
                 incremental_placement: bool = True, metrics=None,
                 flight=None, shards: Optional[int] = None, mesh=None,
                 chaos=None, shard_retries: int = 3,
                 retry_backoff_s: float = 0.02,
                 probe_timeout_s: float = 5.0, tracer=None):
        if window is not None and window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if compact_every < 1:
            raise ValueError(f"compact_every must be >= 1: {compact_every}")
        if whale_threshold is not None and whale_threshold < 2:
            raise ValueError(
                f"whale_threshold must be >= 2: {whale_threshold}")
        if mesh is not None:
            if len(mesh.shape) != 1:
                raise ValueError("the sharded fleet takes a 1-D mesh, got "
                                 f"shape {mesh.shape}")
            shards = mesh.n_workers
        if shards is not None and shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        check_tracer(tracer)
        if shards is not None and mesh is None:
            from tuplewise_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(shards, device)
        if bg_compact and mesh is not None and mesh.distributed:
            # the compactor thread's heals issue
            # collectives; beside the caller's counts their order would
            # differ from rank to rank
            raise ValueError(
                "bg_compact=True is not taken on a distributed mesh: the "
                "compactor thread's collectives would interleave with the "
                "caller's in an order that differs between ranks")
        self._mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.window = window
        self.compact_every = compact_every
        self.shards = shards
        self.chaos = chaos
        self.shard_retries = shard_retries
        self.min_tenant_bucket = min_tenant_bucket
        self.bg_compact = bg_compact
        self.whale_threshold = whale_threshold
        self.whale_demote_fraction = whale_demote_fraction
        # demotion hysteresis floor; 0 = only explicit demote()
        self._demote_below = (
            int(whale_threshold * whale_demote_fraction)
            if whale_threshold is not None else 0)
        self.incremental_placement = incremental_placement
        self.dtype = np.float32
        self.count_kernel = bool(count_kernel)
        self.tracer = tracer
        self.flight = flight
        self._slots: List[Optional[_TenantStat]] = []
        self._free: List[int] = []
        self._by_tid: Dict[str, _TenantStat] = {}
        self._pos_pack = _Pack()
        self._neg_pack = _Pack()
        self._lock = threading.RLock()
        # signals background-build completion (wait_idle drains on it)
        self._cv = threading.Condition(self._lock)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # one fleet count per coalesced multi-tenant batch
        self._c_count_calls = self.metrics.counter(
            "fleet_count_calls_total")
        self._c_count_tenants = self.metrics.counter(
            "fleet_count_tenant_queries_total")
        self._c_compactions = self.metrics.counter("compactions_total")
        self._c_compact_aborts = self.metrics.counter(
            "fleet_compact_aborts")
        self._h_pause = self.metrics.histogram("compaction_pause_s")
        self._g_tenants = self.metrics.gauge("fleet_tenants")
        self._g_mesh = self.metrics.gauge("mesh_width")
        self._g_mesh.set(shards if shards is not None else 0)
        self._c_heal_exhausted = self.metrics.counter("heal_exhausted_total")
        self.metrics.counter("reshard_events")
        self.metrics.counter("shard_retries_total")
        self.metrics.histogram("recovery_time_s")
        # every pack placement counts, full ships separately: the
        # dirty-row saving is (replaces - full) with bytes_h2d_saved > 0
        self._c_replaces = self.metrics.counter("pack_replaces_total")
        self._c_full_replaces = self.metrics.counter(
            "pack_full_replaces_total")
        self.metrics.counter("bytes_h2d")
        self.metrics.counter("bytes_h2d_saved")
        self._g_occupancy = self.metrics.gauge("pack_occupancy")
        self._g_stale = self.metrics.gauge("pack_stale_rows")
        self._c_promotions = self.metrics.counter("fleet_whale_promotions")
        self._c_demotions = self.metrics.counter("fleet_whale_demotions")
        self._c_promote_aborts = self.metrics.counter(
            "fleet_whale_promote_aborts")
        self._g_whales = self.metrics.gauge("fleet_whales")
        self._c_bg_restarts = self.metrics.counter("bg_compactor_restarts")
        # calls = kernel-7 (or whale kernel-6) launches; fallbacks stays
        # 0: nothing falls back from a kernel
        self.metrics.counter("count_kernel_calls_total")
        self.metrics.counter("count_kernel_fallbacks_total")
        self.last_compactor_error = None
        self._healer = None
        if mesh is not None:
            # pool: the mesh's slots first (a shrink and regrow restores
            # them), its spares after; they let resize_shards grow the
            # mesh past its first width. A heal still shrinks over the
            # current mesh's survivors
            pool = list(mesh.slots) + [x for x in mesh.pool
                                       if x not in mesh.slots]
            self._healer = MeshHealer(
                mesh, pool=pool, chaos=chaos,
                probe_timeout_s=probe_timeout_s, metrics=self.metrics,
                backoff=Backoff(base_s=retry_backoff_s, cap_s=1.0),
                flight=flight)
        self._closed = False
        if bg_compact:
            self._jobs: "queue.Queue[Optional[_TenantStat]]" = queue.Queue()
            self._compactor = threading.Thread(
                target=self._compact_worker,
                name="tuplewise-fleet-compactor", daemon=True)
            self._compactor.start()

    # ------------------------------------------------------------------ #
    # tenant lifecycle                                                   #
    # ------------------------------------------------------------------ #
    @property
    def n_tenants(self) -> int:
        with self._lock:
            return len(self._by_tid)

    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._by_tid)

    def has(self, tid: str) -> bool:
        with self._lock:
            return tid in self._by_tid

    def create(self, tid: str) -> _TenantStat:
        """Create (or return) a tenant. A reused slot is marked dirty (its
        row still holds the dropped tenant's values); a fresh slot inside
        the current T_bucket is already an all-+inf row."""
        with self._lock:
            st = self._by_tid.get(tid)
            if st is not None:
                return st
            if self._free:
                slot = self._free.pop()
                self._pos_pack.mark(slot)
                self._neg_pack.mark(slot)
            else:
                slot = len(self._slots)
                self._slots.append(None)
            st = _TenantStat(tid, slot, self.dtype)
            self._slots[slot] = st
            self._by_tid[tid] = st
            self._g_tenants.set(len(self._by_tid))
            if self.flight is not None:
                self.flight.record("tenant_created", tenant=tid, slot=slot)
            return st

    def drop(self, tid: str) -> bool:
        """Remove a tenant and recycle its slot. The slot is marked dirty
        in both packs, so the next placement reclaims its row (ships one
        +inf row)."""
        with self._lock:
            st = self._by_tid.pop(tid, None)
            if st is None:
                return False
            if st.idx is not None:
                st.idx.close()
                st.idx = None
                self._g_whales.set(self._n_whales())
            self._slots[st.slot] = None
            self._free.append(st.slot)
            self._pos_pack.mark(st.slot)
            self._neg_pack.mark(st.slot)
            self._refresh_pack_gauges()
            self._g_tenants.set(len(self._by_tid))
            if self.flight is not None:
                self.flight.record("tenant_evicted", tenant=tid,
                                   slot=st.slot, events=len(st.log))
            return True

    def _n_whales(self) -> int:
        return sum(1 for st in self._by_tid.values() if st.idx is not None)

    def _refresh_pack_gauges(self) -> None:
        """``pack_occupancy``: device rows holding a live pack tenant's
        data; ``pack_stale_rows``: rows still holding data of a slot that
        is no longer live (dropped or promoted, not yet reclaimed).
        Caller holds the lock."""
        occ = stale = 0
        for pack in (self._pos_pack, self._neg_pack):
            for slot, n in enumerate(pack.row_events):
                if not n:
                    continue
                st = self._slots[slot] if slot < len(self._slots) else None
                if st is not None and st.idx is None:
                    occ += 1
                else:
                    stale += 1
        self._g_occupancy.set(occ)
        self._g_stale.set(stale)

    def idle_tenants(self, idle_s: float) -> List[str]:
        now = time.monotonic()
        with self._lock:
            return [tid for tid, st in self._by_tid.items()
                    if now - st.last_active > idle_s]

    # ------------------------------------------------------------------ #
    # the one-call fleet count                                           #
    # ------------------------------------------------------------------ #
    def _t_bucket(self) -> int:
        return tenant_bucket(len(self._slots),
                             min_bucket=self.min_tenant_bucket)

    def _ensure_packs(self) -> None:
        """(Re)place dirty packs from the host-authoritative runs (caller
        holds the lock, on the caller's thread). When only some slots
        changed and the geometry is stable, only their rows ship; a new
        T_bucket, a larger cap, or ``incremental_placement=False`` ships
        the whole pack and counts in ``pack_full_replaces_total``."""
        tb = self._t_bucket()
        for pack, pos in ((self._pos_pack, True), (self._neg_pack, False)):
            if not pack.dirty and pack.dev is not None \
                    and pack.t_bucket == tb:
                continue
            runs = [(s.pos_base if pos else s.neg_base)
                    if s is not None and s.idx is None
                    else np.empty(0, dtype=self.dtype)
                    for s in self._slots]
            dirty = None
            if (self.incremental_placement and not pack.dirty_all
                    and pack.dev is not None and pack.t_bucket == tb):
                dirty = sorted(pack.dirty_slots)
            with maybe_span(self.tracer, "fleet.place_pack"):
                pack.dev, pack.cap, shipped = place_tenant_pack(
                    self._mesh, runs, tb, self.dtype,
                    prev=(pack.dev, pack.cap, pack.t_bucket),
                    dirty=dirty, metrics=self.metrics, device=self.device,
                    chaos=self.chaos)
            self._c_replaces.inc()
            if shipped >= ((self.shards or 1) * tb * pack.cap
                           * np.dtype(self.dtype).itemsize):
                self._c_full_replaces.inc()
            pack.t_bucket = tb
            pack.dirty_all = False
            pack.dirty_slots.clear()
            pack.row_events = [len(r) for r in runs]
        self._refresh_pack_gauges()

    def _on_heal(self, healer) -> None:
        """Adopt the (possibly narrower) healed mesh and mark both packs
        for a full re-place from the host runs (lock held)."""
        self._mesh = healer.mesh
        self.shards = healer.n_workers
        self._g_mesh.set(self.shards)
        self._pos_pack.mark_all()
        self._neg_pack.mark_all()

    def resize_shards(self, shards: int) -> bool:
        """Re-width the mesh on purpose (a control-plane actuation, not a
        recovery): rebuild it at ``shards`` workers from the healer's
        pool and re-place the packs at the next count. Counts are
        additive over any partition, so every tenant's results are the
        same integers at every width. True when the width changed; False
        for an unsharded or distributed fleet, a no-op width or one the
        pool cannot supply. Promoted whales keep their mesh; new whales
        take the resized one."""
        with self._lock:
            if self._healer is None:
                return False
            if not self._healer.resize(shards):
                return False
            self._on_heal(self._healer)
            return True

    def _fleet_base_counts(self, q_vs_neg: List[np.ndarray],
                           q_vs_pos: List[np.ndarray], slots: List[int]):
        """Base-run counts of every tenant's queries in one device call.
        ``q_vs_neg[i]`` / ``q_vs_pos[i]`` are slot ``slots[i]``'s queries
        against the neg / pos pack; returns per-input (less, leq) int64
        arrays. Caller holds the lock."""
        longest = max((len(q) for q in q_vs_neg + q_vs_pos), default=0)
        if longest == 0:
            z = [np.zeros(0, dtype=np.int64) for _ in slots]
            return list(z), list(z), list(z), list(z)
        qb = next_bucket(longest)
        tb = self._t_bucket()
        qn = np.zeros((tb, qb), dtype=self.dtype)
        qp = np.zeros((tb, qb), dtype=self.dtype)
        for i, slot in enumerate(slots):
            if len(q_vs_neg[i]):
                qn[slot, : len(q_vs_neg[i])] = q_vs_neg[i]
            if len(q_vs_pos[i]):
                qp[slot, : len(q_vs_pos[i])] = q_vs_pos[i]
        def attempt():
            # a placement onto a lost worker heals like a count would
            self._ensure_packs()
            return tenant_pack_counts(
                self._mesh, self._pos_pack.dev, self._pos_pack.cap,
                self._neg_pack.dev, self._neg_pack.cap, tb, qn, qp,
                self.dtype, kernel=True if self.count_kernel else None,
                metrics=self.metrics, chaos=self.chaos)

        try:
            with maybe_span(self.tracer, "fleet.count"):
                if self._healer is not None:
                    out = self._healer.run(attempt,
                                           retries=self.shard_retries,
                                           on_heal=self._on_heal)
                else:
                    out = attempt()
        except HealExhaustedError as e:
            self._c_heal_exhausted.inc()
            if self.flight is not None:
                self.flight.record("heal_exhausted", error=repr(e))
                self.flight.auto_dump()
            raise
        less_n, leq_n, less_p, leq_p = out
        self._c_count_calls.inc()
        self._c_count_tenants.inc(len(slots))
        ln, qn_out, lp, qp_out = [], [], [], []
        for i, slot in enumerate(slots):
            kn, kp = len(q_vs_neg[i]), len(q_vs_pos[i])
            ln.append(less_n[slot, :kn])
            qn_out.append(leq_n[slot, :kn])
            lp.append(less_p[slot, :kp])
            qp_out.append(leq_p[slot, :kp])
        return ln, qn_out, lp, qp_out

    # ------------------------------------------------------------------ #
    # host-side exact arithmetic                                         #
    # ------------------------------------------------------------------ #
    def _host_adjust(self, q: np.ndarray, base_less: np.ndarray,
                     base_leq: np.ndarray, buf: List[float],
                     tomb: List[float]):
        """(less, eq) against the current class multiset: the device's
        base counts corrected by the host buffer (+) and tombstones (-),
        the single-tenant index's signed-multiset arithmetic."""
        less = base_less.astype(np.int64, copy=True)
        eq = (base_leq - base_less).astype(np.int64)
        for vals, sign in ((buf, 1), (tomb, -1)):
            if not vals:
                continue
            arr = np.sort(np.asarray(vals, dtype=self.dtype))
            l2 = np.searchsorted(arr, q, side="left").astype(np.int64)
            r2 = np.searchsorted(arr, q, side="right").astype(np.int64)
            less += sign * l2
            eq += sign * (r2 - l2)
        return less, eq

    @staticmethod
    def _cross2_arrays(p: np.ndarray, n: np.ndarray) -> int:
        if len(p) == 0 or len(n) == 0:
            return 0
        ns = np.sort(n)
        less = np.searchsorted(ns, p, side="left").astype(np.int64)
        leq = np.searchsorted(ns, p, side="right").astype(np.int64)
        return int(2 * less.sum() + (leq - less).sum())

    # ------------------------------------------------------------------ #
    # mutation                                                           #
    # ------------------------------------------------------------------ #
    def insert_batch(self, tid: str, scores, labels) -> int:
        """Single-tenant convenience over :meth:`apply_inserts`."""
        return self.apply_inserts([(tid, scores, labels)])[0]

    def apply_inserts(
        self, items: List[Tuple[str, np.ndarray, np.ndarray]],
    ) -> List[int]:
        """Insert one coalesced batch per tenant: every pack tenant's
        new-vs-old counts and window-eviction counts ride one fleet
        count. Items must name distinct tenants; returns the events
        inserted per item.

        wins2 is a pure integer function of each tenant's event sequence,
        so every tenant's result equals a dedicated single-tenant index
        fed the same events, bit for bit."""
        with self._lock:
            return self._apply_inserts_locked(items)

    def _apply_inserts_locked(self, items) -> List[int]:
        plans = []
        seen = set()
        out_by_slot: Dict[int, int] = {}
        order: List[int] = []
        touched: List[_TenantStat] = []
        for tid, scores, labels in items:
            st = self._by_tid.get(tid)
            if st is None:
                st = self.create(tid)
            if st.slot in seen:
                raise ValueError(
                    f"duplicate tenant {tid!r} in one apply: coalesce per "
                    "tenant first")
            seen.add(st.slot)
            order.append(st.slot)
            touched.append(st)
            scores = np.asarray(scores, dtype=self.dtype).ravel()
            labels = np.asarray(labels).ravel().astype(bool)
            if scores.shape != labels.shape:
                raise ValueError(
                    f"scores/labels length mismatch: {scores.shape} vs "
                    f"{labels.shape}")
            if len(scores) and not np.all(np.isfinite(scores)):
                raise ValueError("scores must be finite")
            if st.idx is not None:
                # the promoted whale's own index (kernel 6 on its runs)
                out_by_slot[st.slot] = st.idx.insert_batch(scores, labels)
                st.last_active = time.monotonic()
                continue
            p_new = scores[labels]
            n_new = scores[~labels]
            # window-eviction plan: the oldest overflow arrivals of (log
            # ++ this batch) leave the window; their values are known
            # before the device call, so their base counts share it
            p_out: List[float] = []
            n_out: List[float] = []
            n_evict = 0
            if self.window is not None:
                n_evict = max(0, len(st.log) + len(scores) - self.window)
            if n_evict:
                pool = itertools.chain(
                    st.log, zip(scores.tolist(), labels.tolist()))
                for v, is_pos in itertools.islice(pool, n_evict):
                    (p_out if is_pos else n_out).append(v)
            plans.append((st, scores, labels, p_new, n_new,
                          np.asarray(p_out, dtype=self.dtype),
                          np.asarray(n_out, dtype=self.dtype), n_evict))
        if plans:
            ln, lqn, lp, lqp = self._fleet_base_counts(
                [np.concatenate([p[3], p[5]]) for p in plans],
                [np.concatenate([p[4], p[6]]) for p in plans],
                [p[0].slot for p in plans])
            for i, plan in enumerate(plans):
                out_by_slot[plan[0].slot] = self._fold_plan(
                    plan, ln[i], lqn[i], lp[i], lqp[i])
        for plan in plans:
            self._maybe_compact(plan[0])
        self._check_whales(touched)
        return [out_by_slot[slot] for slot in order]

    def _maybe_compact(self, st: _TenantStat) -> None:
        """Compact a tenant once its unclaimed buffer or tombstones reach
        ``compact_every`` (lock held): on the side thread with
        ``bg_compact``, where a dead worker is restarted and this trigger
        compacts synchronously once."""
        buf_pending, tomb_pending = st.pending()
        if (buf_pending < self.compact_every
                and tomb_pending < self.compact_every):
            return
        if self.bg_compact and self._ensure_compactor():
            self._submit_compact(st)
            return
        if not st.building:
            self._compact_tenant(st)

    def _check_whales(self, sts: List[_TenantStat]) -> None:
        """Promote pack tenants crossing the threshold; demote whales
        that shrank below the hysteresis floor (lock held)."""
        if self.whale_threshold is None:
            return
        for st in sts:
            if st.idx is None and len(st.log) >= self.whale_threshold:
                self._promote(st)
            elif (st.idx is not None
                    and st.idx.n_events < self._demote_below):
                self._demote(st)

    def _fold_plan(self, plan, less_n, leq_n, less_p, leq_p) -> int:
        """Apply one tenant's insert and eviction with host-exact integer
        arithmetic (lock held). The device gave base counts of
        [p_new ++ p_out] against neg and [n_new ++ n_out] against pos;
        the buffers and tombstones adjust at the container states of the
        single-tenant order (before the insert for its term, after it for
        the eviction's)."""
        (st, scores, labels, p_new, n_new, p_out, n_out, n_evict) = plan
        kp, kn = len(p_new), len(n_new)
        # --- insert: new-vs-old (containers before the insert) -------- #
        less, eq = self._host_adjust(p_new, less_n[:kp], leq_n[:kp],
                                     st.neg_buf, st.neg_tomb)
        d = int(2 * less.sum() + eq.sum())
        less2, eq2 = self._host_adjust(n_new, less_p[:kn], leq_p[:kn],
                                       st.pos_buf, st.pos_tomb)
        greater = st.size(True) - less2 - eq2
        d += int(2 * greater.sum() + eq2.sum())
        d += self._cross2_arrays(p_new, n_new)
        st.wins2 += d
        st.pos_buf.extend(p_new.tolist())
        st.neg_buf.extend(n_new.tolist())
        st.log.extend(zip(scores.tolist(), labels.tolist()))
        # --- eviction: inclusion-exclusion (containers after it) ------ #
        if n_evict:
            less, eq = self._host_adjust(p_out, less_n[kp:], leq_n[kp:],
                                         st.neg_buf, st.neg_tomb)
            d = int(2 * less.sum() + eq.sum())
            less2, eq2 = self._host_adjust(n_out, less_p[kn:], leq_p[kn:],
                                           st.pos_buf, st.pos_tomb)
            greater = st.size(True) - less2 - eq2
            d += int(2 * greater.sum() + eq2.sum())
            d -= self._cross2_arrays(p_out, n_out)
            st.wins2 -= d
            for _ in range(n_evict):
                v, is_pos = st.log.popleft()
                buf = st.pos_buf if is_pos else st.neg_buf
                snap_buf, _ = st.snap(is_pos)
                try:
                    # only the unclaimed suffix is removable in place: an
                    # in-flight build owns the prefix
                    buf.pop(buf.index(v, snap_buf))
                except ValueError:
                    (st.pos_tomb if is_pos else st.neg_tomb).append(v)
            st.n_evicted += n_evict
        st.last_active = time.monotonic()
        return len(scores)

    def _merged(self, base: np.ndarray, buf: List[float],
                tomb: List[float]) -> np.ndarray:
        """sorted(base + buf) minus the tombstones, on the host."""
        return _remove_sorted(
            _splice_merge(base, np.sort(np.asarray(buf, dtype=self.dtype))),
            list(tomb))

    def _compact_tenant(self, st: _TenantStat) -> None:
        """Synchronous tenant compaction (lock held): fold the buffers
        and tombstones into the sorted bases and mark the slot dirty in
        the packs it touched; the next count ships only its rows. An
        injected ``compactor_build`` crash aborts cleanly: the containers
        are untouched (compaction never touches wins2) and the next
        trigger retries."""
        if self.chaos is not None:
            try:
                self.chaos.fire("compactor_build")
            except InjectedFault as e:
                self._c_compact_aborts.inc()
                self.last_compactor_error = repr(e)
                if self.flight is not None:
                    self.flight.record("compaction_abort", tenant=st.tid,
                                       error=repr(e))
                return
        t0 = time.perf_counter()
        with maybe_span(self.tracer, "fleet.compact"):
            for pos in (True, False):
                base, buf, tomb = st.side(pos)
                if not buf and not tomb:
                    continue
                merged = self._merged(base, buf, tomb)
                if pos:
                    st.pos_base, st.pos_buf, st.pos_tomb = merged, [], []
                    self._pos_pack.mark(st.slot)
                else:
                    st.neg_base, st.neg_buf, st.neg_tomb = merged, [], []
                    self._neg_pack.mark(st.slot)
        st.n_compactions += 1
        self._c_compactions.inc()
        self._h_pause.observe(time.perf_counter() - t0)
        if self.flight is not None:
            self.flight.record("compaction", tier="tenant", tenant=st.tid,
                               base_events=len(st.pos_base)
                               + len(st.neg_base))

    # ------------------------------------------------------------------ #
    # background tenant builds                                           #
    # ------------------------------------------------------------------ #
    def _ensure_compactor(self) -> bool:
        """Watchdog (lock held): True when the side compactor is alive; a
        dead worker is restarted and False returned, so the caller
        compacts synchronously this once."""
        if self._compactor.is_alive():
            return True
        if not self._closed:
            self._c_bg_restarts.inc()
            self._compactor = threading.Thread(
                target=self._compact_worker,
                name="tuplewise-fleet-compactor", daemon=True)
            self._compactor.start()
        return False

    def _submit_compact(self, st: _TenantStat) -> None:
        """Claim the tenant's consumable prefixes and enqueue a build
        (lock held); a no-op while one is in flight."""
        if st.building:
            return
        st.building = True
        st.snap_pos_buf = len(st.pos_buf)
        st.snap_neg_buf = len(st.neg_buf)
        st.snap_pos_tomb = len(st.pos_tomb)
        st.snap_neg_tomb = len(st.neg_tomb)
        self._jobs.put(st)

    def _compact_worker(self) -> None:
        while True:
            st = self._jobs.get()
            if st is None:
                return
            try:
                self._bg_build(st)
            except BaseException as e:
                # roll back the claim: the buffers still hold every value
                # and wins2 was never touched, so the next trigger
                # re-compacts; the watchdog restarts the thread
                with self._cv:
                    st.snap_pos_buf = st.snap_neg_buf = 0
                    st.snap_pos_tomb = st.snap_neg_tomb = 0
                    st.building = False
                    self._c_compact_aborts.inc()
                    self.last_compactor_error = repr(e)
                    if self.flight is not None:
                        self.flight.record("compaction_abort",
                                           tenant=st.tid, error=repr(e))
                    self._cv.notify_all()
                return

    def _bg_build(self, st: _TenantStat) -> None:
        """One off-batcher tenant build: merge the claimed prefixes into
        fresh host bases with the lock released, then swap them in and
        mark the slot dirty. The device copy is made by the next count,
        on the caller's thread."""
        if self.chaos is not None:
            self.chaos.fire("compactor_build")
        with self._cv:
            pos_base, neg_base = st.pos_base, st.neg_base
            buf_p = list(st.pos_buf[: st.snap_pos_buf])
            buf_n = list(st.neg_buf[: st.snap_neg_buf])
            tomb_p = list(st.pos_tomb[: st.snap_pos_tomb])
            tomb_n = list(st.neg_tomb[: st.snap_neg_tomb])
        with maybe_span(self.tracer, "fleet.bg_compact"):
            merged_p = self._merged(pos_base, buf_p, tomb_p)
            merged_n = self._merged(neg_base, buf_n, tomb_n)
        with self._cv:
            t0 = time.perf_counter()
            st.pos_base, st.neg_base = merged_p, merged_n
            del st.pos_buf[: st.snap_pos_buf]
            del st.neg_buf[: st.snap_neg_buf]
            del st.pos_tomb[: st.snap_pos_tomb]
            del st.neg_tomb[: st.snap_neg_tomb]
            st.snap_pos_buf = st.snap_neg_buf = 0
            st.snap_pos_tomb = st.snap_neg_tomb = 0
            st.building = False
            self._pos_pack.mark(st.slot)
            self._neg_pack.mark(st.slot)
            st.n_compactions += 1
            self._c_compactions.inc()
            # the swap is the only pause the request path can observe
            self._h_pause.observe(time.perf_counter() - t0)
            if self.flight is not None:
                self.flight.record("compaction", tier="tenant_bg",
                                   tenant=st.tid,
                                   base_events=len(merged_p)
                                   + len(merged_n))
            buf_pending, tomb_pending = st.pending()
            if (not self._closed
                    and (buf_pending >= self.compact_every
                         or tomb_pending >= self.compact_every)):
                self._submit_compact(st)
            self._cv.notify_all()

    def wait_idle(self, timeout: float = 30.0) -> None:
        """Block until no background tenant build is queued or in flight
        (so byte and pause accounting is deterministic)."""
        if not self.bg_compact:
            return
        deadline = time.monotonic() + timeout
        with self._cv:
            while any(st is not None and st.building
                      for st in self._slots) or not self._jobs.empty():
                self._ensure_compactor()
                if (not self._cv.wait(timeout=0.25)
                        and time.monotonic() >= deadline):
                    raise TimeoutError("fleet background compaction stuck")

    def close(self, timeout: float = 10.0) -> None:
        """Stop the side compactor and close every whale index."""
        if self._closed:
            return
        self._closed = True
        if self.bg_compact:
            self._jobs.put(None)
            self._compactor.join(timeout=timeout)
        with self._lock:
            for st in self._by_tid.values():
                if st.idx is not None:
                    st.idx.close(timeout=timeout)

    # ------------------------------------------------------------------ #
    # whale promotion / demotion                                         #
    # ------------------------------------------------------------------ #
    def _make_whale_index(self) -> ExactAucIndex:
        """A dedicated exact index for one promoted tenant on the fleet's
        device, sharing its registry, flight recorder and injector; on a
        mesh fleet, a sharded index (the delta tiers) on the fleet's
        mesh."""
        kw = dict(window=self.window, compact_every=self.compact_every,
                  engine="torch", device=self.device, metrics=self.metrics,
                  bg_compact=self.bg_compact, count_kernel=self.count_kernel,
                  flight=self.flight, chaos=self.chaos,
                  shard_retries=self.shard_retries)
        if self._mesh is not None:
            kw["mesh"] = self._mesh
        return ExactAucIndex(**kw)

    def promote(self, tid: str) -> bool:
        """Promote a tenant explicitly; False when absent or already
        promoted."""
        with self._lock:
            st = self._by_tid.get(tid)
            if st is None or st.idx is not None:
                return False
            return self._promote(st)

    def demote(self, tid: str) -> bool:
        """Demote a promoted tenant back into the shared packs."""
        with self._lock:
            st = self._by_tid.get(tid)
            if st is None or st.idx is None:
                return False
            self._demote(st)
            return True

    def _promote(self, st: _TenantStat) -> bool:
        """Move a pack tenant's state into its own index (lock held). All
        fallible work (building and seeding the index) happens before the
        handoff, so a failure aborts cleanly with the pack state
        untouched (``fleet_whale_promote_aborts``) and the next trigger
        retries. wins2 and the log transfer verbatim."""
        if st.building:
            return False     # a build in flight owns the containers
        idx = None
        try:
            idx = self._make_whale_index()
            idx.seed_state(st.values(True), st.values(False),
                           list(st.log), st.wins2, n_evicted=st.n_evicted)
        except Exception as e:    # noqa: BLE001 — abort cleanly
            self._c_promote_aborts.inc()
            if self.flight is not None:
                self.flight.record("whale_promote_abort", tenant=st.tid,
                                   error=repr(e))
            if idx is not None:
                idx.close()
            return False
        st.idx = idx
        st.pos_base = np.empty(0, dtype=self.dtype)
        st.neg_base = np.empty(0, dtype=self.dtype)
        st.pos_buf, st.neg_buf = [], []
        st.pos_tomb, st.neg_tomb = [], []
        st.log = collections.deque()
        st.wins2 = 0
        # reclaim the pack rows (one +inf row each at the next placement)
        self._pos_pack.mark(st.slot)
        self._neg_pack.mark(st.slot)
        self._c_promotions.inc()
        self._g_whales.set(self._n_whales())
        self._refresh_pack_gauges()
        if self.flight is not None:
            self.flight.record("whale_promoted", tenant=st.tid,
                               events=idx.n_events)
        return True

    def _demote(self, st: _TenantStat) -> None:
        """Fold a shrunken whale back into the packs (lock held): its
        exact state transfers verbatim; the slot re-places at the next
        count."""
        idx = st.idx
        pos, neg, log, wins2, n_evicted = idx.export_state()
        st.idx = None
        idx.close()
        st.pos_base = np.asarray(pos, dtype=self.dtype)
        st.neg_base = np.asarray(neg, dtype=self.dtype)
        st.pos_buf, st.neg_buf = [], []
        st.pos_tomb, st.neg_tomb = [], []
        st.log = collections.deque(log)
        st.wins2 = wins2
        st.n_evicted = n_evicted
        self._pos_pack.mark(st.slot)
        self._neg_pack.mark(st.slot)
        self._c_demotions.inc()
        self._g_whales.set(self._n_whales())
        self._refresh_pack_gauges()
        if self.flight is not None:
            self.flight.record("whale_demoted", tenant=st.tid,
                               events=len(st.log))

    # ------------------------------------------------------------------ #
    # queries                                                            #
    # ------------------------------------------------------------------ #
    def apply_scores(
        self, items: List[Tuple[str, np.ndarray]],
    ) -> List[np.ndarray]:
        """Fractional ranks against each tenant's negatives for a
        coalesced multi-tenant score batch: one fleet count (promoted
        whales answer from their own index)."""
        with self._lock:
            plans = []
            out_by_pos: Dict[int, np.ndarray] = {}
            for i, (tid, q) in enumerate(items):
                st = self._by_tid.get(tid)
                if st is None:
                    st = self.create(tid)
                q = np.asarray(q, dtype=self.dtype).ravel()
                if st.idx is not None:
                    out_by_pos[i] = st.idx.score_batch(q)
                    st.last_active = time.monotonic()
                else:
                    plans.append((i, st, q))
            if plans:
                empty = np.zeros(0, dtype=self.dtype)
                ln, lqn, _, _ = self._fleet_base_counts(
                    [q for _, _, q in plans], [empty for _ in plans],
                    [st.slot for _, st, _ in plans])
                for k, (i, st, q) in enumerate(plans):
                    n_neg = st.size(False)
                    if n_neg == 0:
                        out_by_pos[i] = np.full(len(q), np.nan)
                        continue
                    less, eq = self._host_adjust(
                        q, ln[k], lqn[k], st.neg_buf, st.neg_tomb)
                    out_by_pos[i] = (less + 0.5 * eq) / float(n_neg)
                    st.last_active = time.monotonic()
            return [out_by_pos[i] for i in range(len(items))]

    def is_whale(self, tid: str) -> bool:
        with self._lock:
            st = self._by_tid.get(tid)
            return st is not None and st.idx is not None

    def wins2(self, tid: str) -> int:
        with self._lock:
            st = self._by_tid[tid]
            return st.idx._wins2 if st.idx is not None else st.wins2

    def auc(self, tid: str) -> Optional[float]:
        with self._lock:
            st = self._by_tid.get(tid)
            if st is None:
                return None
            if st.idx is not None:
                return st.idx.auc()
            np_, nn = st.size(True), st.size(False)
            if np_ == 0 or nn == 0:
                return None
            return st.wins2 / (2.0 * np_ * nn)

    def oracle_values(self, tid: str) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            st = self._by_tid[tid]
            if st.idx is not None:
                return st.idx.oracle_values()
            return st.values(True), st.values(False)

    def tenant_state(self, tid: str) -> Optional[dict]:
        with self._lock:
            st = self._by_tid.get(tid)
            if st is None:
                return None
            if st.idx is not None:
                idx = st.idx
                return {"tenant": tid, "n_pos": idx.n_pos,
                        "n_neg": idx.n_neg, "n_events": idx.n_events,
                        "auc": idx.auc(), "n_compactions": idx.n_compactions,
                        "n_evicted": idx.n_evicted, "promoted": True}
            return {"tenant": tid, "n_pos": st.size(True),
                    "n_neg": st.size(False), "n_events": len(st.log),
                    "auc": self.auc(tid), "n_compactions": st.n_compactions,
                    "n_evicted": st.n_evicted, "promoted": False}

    def state(self) -> dict:
        with self._lock:
            return {
                "tenants": len(self._by_tid),
                "slots": len(self._slots),
                "t_bucket": self._t_bucket(),
                "shards": self.shards,
                "window": self.window,
                "pack_caps": {"pos": self._pos_pack.cap,
                              "neg": self._neg_pack.cap},
                "count_calls": self._c_count_calls.value,
                "whales": self._n_whales(),
                "whale_threshold": self.whale_threshold,
                "bg_compact": self.bg_compact,
                "incremental_placement": self.incremental_placement,
                "last_compactor_error": self.last_compactor_error,
                "count_kernel": self.count_kernel,
                "device": str(self.device),
            }


# --------------------------------------------------------------------- #
# fleet request path                                                     #
# --------------------------------------------------------------------- #

class _FleetRequest:
    __slots__ = ("kind", "tenant", "scores", "labels", "future",
                 "t_enqueue")

    def __init__(self, kind: str, tenant: str, scores, labels):
        self.kind = kind
        self.tenant = tenant
        self.scores = scores
        self.labels = labels
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()


class MultiTenantEngine:
    """Micro-batched fleet engine: per-tenant queues, admission control,
    weighted-fair scheduling, one batcher thread, one device.

    The single-tenant engine's semantics hold per tenant (per-tenant
    event order, exact per-tenant AUC, per-tenant windows and streams),
    while the queue capacity, the batcher and the device packs are
    shared:

    * admission: ``submit`` raises :class:`TenantRejectedError` past the
      tenant's queue quota or the fleet's tenant cap (counted globally
      and per tenant), :class:`TenantThrottledError` while the tenant is
      throttled, and the global ``queue_size``/``policy`` backpressure
      applies on top;
    * fair scheduling: the batcher drains per-tenant FIFOs in
      deficit-round-robin order, up to the tenant's weight per round;
    * lifecycle: tenants are created on first request (or with
      :meth:`create_tenant`), dropped explicitly, or evicted after
      ``idle_evict_s`` idle.

    ``config.device`` places the fleet (the card unless "cpu");
    ``config.engine`` is not read (the fleet is the float32 device path).
    ``close()`` fails every unapplied request with an
    ``EngineClosedError`` naming its tenant. ``config.mesh_shards``
    shards the fleet over a mesh of that many workers; a ``chaos``
    injector fires the ``batcher`` point between batches and the fleet's
    points. ``snapshot_dir``/``recover`` and ``tracer`` are not ported
    yet and raise.
    """

    _KINDS = ("insert", "score", "query")

    def __init__(self, config: Optional[ServingConfig] = None,
                 tenancy: Optional[TenancyConfig] = None, chaos=None,
                 tracer=None, **overrides):
        if config is None:
            config = ServingConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        if config.kernel != "auc":
            raise ValueError(
                "MultiTenantEngine serves the exact AUC fleet; "
                f"kernel={config.kernel!r} is not supported")
        if config.snapshot_dir or config.recover:
            raise NotImplementedError(
                "crash-safe fleet recovery (snapshot_dir/recover) is not "
                "ported to tuplewise_tpu_torch yet")
        check_tracer(tracer)
        self.config = config
        self.tenancy = tenancy if tenancy is not None else TenancyConfig()
        self.chaos = chaos
        self.tracer = tracer
        self.metrics = MetricsRegistry()
        self.flight = FlightRecorder(capacity=config.flight_recorder_size)
        if chaos is not None:
            chaos.attach(flight=self.flight)
        self.fleet = TenantFleetIndex(
            window=config.window, compact_every=config.compact_every,
            device=config.device, count_kernel=config.count_kernel,
            shards=config.mesh_shards, chaos=chaos,
            min_tenant_bucket=self.tenancy.min_tenant_bucket,
            bg_compact=config.bg_compact,
            whale_threshold=self.tenancy.whale_threshold,
            whale_demote_fraction=self.tenancy.whale_demote_fraction,
            metrics=self.metrics, flight=self.flight)
        # bounded metric cardinality: tenants past tenant_metric_cap
        # share one {tenant=__other__} series
        self._labeled_tenants: set = set()
        self._collapsed_tenants: set = set()
        self._g_collapsed = self.metrics.gauge("tenant_metric_collapsed")
        self._streams: Dict[str, StreamingIncompleteU] = {}
        m = self.metrics
        self._c_req = {k: m.counter(f"requests_{k}_total")
                       for k in self._KINDS}
        self._c_rejected = m.counter("rejected_total")
        self._c_dropped = m.counter("dropped_total")
        self._c_tenant_rejected = m.counter("tenant_rejected_total")
        self._c_tenants_created = m.counter("tenants_created_total")
        self._c_tenants_evicted = m.counter("tenants_evicted_total")
        self._c_batches = m.counter("batches_total")
        self._c_events = m.counter("events_total")
        self._c_pairs = m.counter("incomplete_pairs_total")
        self._c_poison = m.counter("poison_rejects")
        self._c_batcher_restarts = m.counter("batcher_restarts")
        self._c_deadline = m.counter("deadline_expired_total")
        self._c_throttled = m.counter("tenant_throttled_total")
        self._h_latency = m.histogram("request_latency_s")
        self._h_insert_lat = m.histogram("insert_latency_s")
        self._h_fill = m.histogram(
            "batch_fill", buckets=[i / 16 for i in range(1, 17)])
        self._g_depth = m.gauge("queue_depth_live")
        self._g_live = m.gauge("tenants_live")
        # host-tax split of the insert waves; the fleet takes its lock
        # inside apply_inserts, so lock wait stays in host_python here
        self.ledger = WaveLedger(m)
        self._c_exemplars = m.counter("tail_exemplars_total")
        self._pending: Dict[str, Deque[_FleetRequest]] = {}
        self._rotation: List[str] = []
        self._n_pending = 0
        self._inflight = 0
        self._cv = threading.Condition()
        self._closed = False
        self._last_idle_check = time.monotonic()
        # control-plane overrides, all empty by default
        self._throttles: Dict[str, Tuple[float, float]] = {}
        self._tenant_weights: Dict[str, int] = {}
        self._tenant_quotas: Dict[str, int] = {}
        self._worker = threading.Thread(
            target=self._supervise, name="tuplewise-fleet-batcher",
            daemon=True)
        self._worker.start()
        # deadline reaper: over-deadline pending requests fail typed on a
        # timer, not only when the batcher gets to them
        self._reaper = None
        if config.deadline_s is not None:
            self._reaper = threading.Thread(
                target=self._reap_expired, name="tuplewise-fleet-reaper",
                daemon=True)
            self._reaper.start()

    # ------------------------------------------------------------------ #
    # tenant lifecycle                                                   #
    # ------------------------------------------------------------------ #
    def _metric_tenant(self, tid: str) -> str:
        """The label value of a tenant's metrics: its own id until
        ``tenant_metric_cap`` tenants are labeled, then ``__other__``
        (first come keeps its label)."""
        cap = self.tenancy.tenant_metric_cap
        if cap is None or tid in self._labeled_tenants:
            return tid
        if len(self._labeled_tenants) < cap:
            self._labeled_tenants.add(tid)
            return tid
        if tid not in self._collapsed_tenants:
            self._collapsed_tenants.add(tid)
            self._g_collapsed.set(len(self._collapsed_tenants))
        return "__other__"

    def _count_tenant(self, name: str, tid: str) -> None:
        """Add one to a per-tenant labeled counter."""
        if self.tenancy.tenant_metrics:
            self.metrics.counter(
                name, labels={"tenant": self._metric_tenant(tid)}).inc()

    def _ensure_tenant(self, tid: str) -> None:
        """Create on first request, under the tenant cap (admission)."""
        if self.fleet.has(tid):
            return
        if self.fleet.n_tenants >= self.tenancy.max_tenants:
            self._c_tenant_rejected.inc()
            self._count_tenant("tenant_rejected_total", tid)
            raise TenantRejectedError(
                f"fleet at max_tenants={self.tenancy.max_tenants}; "
                f"tenant {tid!r} not admitted", tenant=tid)
        self.create_tenant(tid)

    def create_tenant(self, tid: str) -> None:
        self.fleet.create(tid)
        if tid not in self._streams:
            self._streams[tid] = StreamingIncompleteU(
                kernel=self.config.kernel, budget=self.config.budget,
                reservoir=self.config.reservoir, design=self.config.design,
                seed=tenant_seed(self.config.seed, tid))
            self._c_tenants_created.inc()
        self._g_live.set(self.fleet.n_tenants)

    def drop_tenant(self, tid: str) -> bool:
        """Remove a tenant's statistic state (also the idle-eviction
        path); its pending requests still apply and re-create it."""
        dropped = self.fleet.drop(tid)
        self._streams.pop(tid, None)
        if dropped:
            self._c_tenants_evicted.inc()
            self._g_live.set(self.fleet.n_tenants)
        return dropped

    def _maybe_evict_idle(self) -> None:
        idle_s = self.tenancy.idle_evict_s
        if idle_s is None:
            return
        now = time.monotonic()
        if now - self._last_idle_check < min(idle_s, 1.0):
            return
        self._last_idle_check = now
        for tid in self.fleet.idle_tenants(idle_s):
            with self._cv:
                busy = tid in self._pending
            if not busy:
                self.drop_tenant(tid)

    # ------------------------------------------------------------------ #
    # control-plane actuation surface                                    #
    # ------------------------------------------------------------------ #
    def throttle_tenant(self, tid: str, retry_after_s: float = 0.5) -> None:
        """Shed ``tid``'s new requests for ``retry_after_s`` seconds with
        a :class:`TenantThrottledError`; queued requests still apply.
        Expires by itself; re-issue to extend."""
        with self._cv:
            self._throttles[str(tid)] = (
                time.monotonic() + retry_after_s, retry_after_s)

    def clear_throttles(self, tid: Optional[str] = None) -> int:
        """Lift one tenant's throttle (or all); returns how many."""
        with self._cv:
            if tid is not None:
                return 1 if self._throttles.pop(str(tid), None) else 0
            n = len(self._throttles)
            self._throttles.clear()
            return n

    def throttled_tenants(self) -> List[str]:
        now = time.monotonic()
        with self._cv:
            return [t for t, (until, _) in self._throttles.items()
                    if until > now]

    def set_tenant_weight(self, tid: str, weight: Optional[int]) -> None:
        """Override one tenant's DRR quantum (None restores the
        default)."""
        with self._cv:
            if weight is None:
                self._tenant_weights.pop(str(tid), None)
            else:
                self._tenant_weights[str(tid)] = max(1, int(weight))

    def set_tenant_quota(self, tid: str, quota: Optional[int]) -> None:
        """Override one tenant's queued-request quota (None restores the
        default)."""
        with self._cv:
            if quota is None:
                self._tenant_quotas.pop(str(tid), None)
            else:
                self._tenant_quotas[str(tid)] = max(1, int(quota))

    def pending_by_tenant(self) -> Dict[str, int]:
        """Queued (unapplied) request counts per tenant."""
        with self._cv:
            return {t: len(dq) for t, dq in self._pending.items()}

    def _check_throttle(self, tenant: str) -> None:
        th = self._throttles.get(tenant)
        if th is None:
            return
        remaining = th[0] - time.monotonic()
        if remaining <= 0:
            with self._cv:
                # expired: drop it, unless it was re-issued meanwhile
                if self._throttles.get(tenant, (0, 0))[0] <= \
                        time.monotonic():
                    self._throttles.pop(tenant, None)
            return
        self._c_throttled.inc()
        self._count_tenant("tenant_throttled_total", tenant)
        self.flight.record("tenant_throttled", tenant=tenant,
                           retry_after_s=remaining)
        raise TenantThrottledError(
            f"tenant {tenant!r} throttled by the control plane; retry "
            f"after {remaining:.3f}s", tenant=tenant,
            retry_after_s=remaining)

    def _reap_expired(self) -> None:
        """Fail over-deadline pending requests typed and remove them from
        their tenant queues (their quota slots free up)."""
        deadline = self.config.deadline_s
        interval = min(max(deadline / 4.0, 0.005), 0.25)
        while not self._closed:
            time.sleep(interval)
            now = time.perf_counter()
            expired: List[_FleetRequest] = []
            with self._cv:
                for tid in list(self._pending):
                    dq = self._pending[tid]
                    keep = collections.deque(
                        r for r in dq if now - r.t_enqueue <= deadline)
                    if len(keep) != len(dq):
                        expired.extend(r for r in dq
                                       if now - r.t_enqueue > deadline)
                        self._n_pending -= len(dq) - len(keep)
                        if keep:
                            self._pending[tid] = keep
                        else:
                            del self._pending[tid]
                            self._rotation.remove(tid)
                if expired:
                    self._cv.notify_all()   # capacity freed
            for r in expired:
                if r.future.done():
                    continue
                try:
                    r.future.set_exception(DeadlineExceededError(
                        f"request expired after {now - r.t_enqueue:.3f}s "
                        f"in queue (deadline_s={deadline}, "
                        f"tenant={r.tenant})"))
                except Exception:   # noqa: BLE001 — lost the race
                    continue
                self._c_deadline.inc()
                self.flight.record("deadline_expired", kind_req=r.kind,
                                   tenant=r.tenant,
                                   waited_s=now - r.t_enqueue)
                self._finish(r, now)

    # ------------------------------------------------------------------ #
    # request side                                                       #
    # ------------------------------------------------------------------ #
    def submit(self, kind: str, tenant, scores=None,
               labels=None) -> Future:
        """Enqueue one request for ``tenant``; returns its Future.

        Raises :class:`TenantRejectedError` (admission),
        :class:`TenantThrottledError`, ``BackpressureError`` (global
        queue policy) or ``PoisonEventError`` (edge validation), all
        before the request can take batcher time."""
        if kind not in self._KINDS:
            raise ValueError(f"unknown request kind {kind!r}")
        tenant = str(tenant)
        if self._closed:
            raise EngineClosedError(
                f"engine is closed (tenant={tenant})", tenant=tenant)
        self._check_throttle(tenant)
        if kind == "insert":
            scores, labels = self._validate_insert(tenant, scores, labels)
        elif kind == "score":
            scores = np.atleast_1d(np.asarray(scores, dtype=np.float64))
        self._ensure_tenant(tenant)
        req = _FleetRequest(kind, tenant, scores, labels)
        self._c_req[kind].inc()
        with self._cv:
            dq = self._pending.get(tenant)
            quota = self._tenant_quotas.get(tenant,
                                            self.tenancy.tenant_quota)
            if dq is not None and len(dq) >= quota:
                self._c_tenant_rejected.inc()
                self._count_tenant("tenant_rejected_total", tenant)
                raise TenantRejectedError(
                    f"tenant {tenant!r} queue quota ({quota}) exceeded",
                    tenant=tenant)
            while self._n_pending >= self.config.queue_size:
                if self.config.policy == "reject":
                    self._c_rejected.inc()
                    raise BackpressureError(
                        f"fleet queue full ({self.config.queue_size}); "
                        f"request rejected (tenant={tenant})")
                if self.config.policy == "drop_oldest":
                    self._drop_oldest_locked()
                    continue
                # block: wait for capacity; close() must unblock us
                self._cv.wait(timeout=0.05)
                if self._closed:
                    raise EngineClosedError(
                        "engine closed while blocked on queue capacity "
                        f"(tenant={tenant})", tenant=tenant)
            if dq is None:
                dq = self._pending[tenant] = collections.deque()
                self._rotation.append(tenant)
            dq.append(req)
            self._n_pending += 1
            self._g_depth.set(self._n_pending)
            self._cv.notify_all()
        return req.future

    def _drop_oldest_locked(self) -> None:
        """drop_oldest across tenants: shed the head of the longest
        tenant queue, so the flooding tenant pays first."""
        if not self._pending:
            return
        tid = max(self._pending, key=lambda t: len(self._pending[t]))
        old = self._pending[tid].popleft()
        if not self._pending[tid]:
            del self._pending[tid]
            self._rotation.remove(tid)
        self._n_pending -= 1
        self._c_dropped.inc()
        if not old.future.done():
            old.future.set_exception(BackpressureError(
                f"dropped by a newer request (drop_oldest, "
                f"tenant={old.tenant})"))

    def _validate_insert(self, tenant, scores, labels):
        scores = np.atleast_1d(np.asarray(scores, dtype=np.float64))
        labels = np.atleast_1d(np.asarray(labels))
        msg = None
        if scores.shape != labels.shape:
            msg = (f"insert: scores/labels shape mismatch: "
                   f"{scores.shape} vs {labels.shape}")
        elif len(scores) and not np.all(np.isfinite(scores)):
            msg = "insert: non-finite score(s) rejected"
        elif labels.dtype.kind == "f" and len(labels) \
                and not np.all(np.isfinite(labels)):
            msg = "insert: non-finite label(s) rejected"
        if msg is not None:
            self._c_poison.inc()
            self.flight.record("poison_reject", reason=msg, tenant=tenant)
            raise PoisonEventError(f"{msg} (tenant={tenant})")
        return scores, labels

    def insert(self, tenant, scores, labels) -> Future:
        return self.submit("insert", tenant, scores, labels)

    def score(self, tenant, scores) -> Future:
        return self.submit("score", tenant, scores)

    def query(self, tenant) -> Future:
        return self.submit("query", tenant)

    def flush(self, timeout: Optional[float] = 30.0) -> None:
        """Barrier: everything enqueued so far is applied on return."""
        deadline = time.monotonic() + (timeout or 30.0)
        with self._cv:
            while (self._n_pending or self._inflight) and not self._closed:
                self._cv.wait(timeout=0.05)
                if time.monotonic() >= deadline:
                    raise TimeoutError("fleet flush timed out")

    # ------------------------------------------------------------------ #
    # batcher side                                                       #
    # ------------------------------------------------------------------ #
    def _supervise(self) -> None:
        while True:
            try:
                self._run()
                return
            except BaseException as e:
                if self._closed:
                    return
                self._c_batcher_restarts.inc()
                self.flight.record("batcher_restart", error=repr(e))
                self.flight.auto_dump()

    def _run(self) -> None:
        while True:
            if self.chaos is not None:
                self.chaos.fire("batcher")
            batch = self._next_batch()
            if batch is None:
                self._fail_pending()
                return
            if batch:
                try:
                    self._dispatch(batch)
                finally:
                    with self._cv:
                        self._inflight = 0
                        self._cv.notify_all()
            self._maybe_evict_idle()

    def _next_batch(self) -> Optional[List[_FleetRequest]]:
        with self._cv:
            while self._n_pending == 0:
                if self._closed:
                    return None
                self._cv.wait(timeout=0.05)
            if self._closed:
                # close() fails unapplied requests, tenant-attributed
                return None
            deadline = time.perf_counter() + self.config.flush_timeout_s
            while (self._n_pending < self.config.max_batch
                   and not self._closed):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch = self._drr_take(self.config.max_batch)
            # the gauge tracks the remaining backlog
            self._g_depth.set(self._n_pending)
            self._inflight = len(batch)
            self._cv.notify_all()    # capacity freed: wake producers
            return batch

    def _drr_take(self, n: int) -> List[_FleetRequest]:
        """Deficit-round-robin drain (lock held): every pending tenant is
        served up to its weight per round before any tenant is served
        again."""
        out: List[_FleetRequest] = []
        while len(out) < n and self._rotation:
            tid = self._rotation.pop(0)
            dq = self._pending.get(tid)
            if dq is None:
                continue
            w = self._tenant_weights.get(tid, self.tenancy.weight)
            take = min(w, n - len(out), len(dq))
            for _ in range(take):
                out.append(dq.popleft())
            self._n_pending -= take
            if dq:
                self._rotation.append(tid)
            else:
                del self._pending[tid]
        return out

    @staticmethod
    def _waves(batch: List[_FleetRequest]):
        """Split a drained batch into kind waves that keep each tenant's
        submission order: per tenant, consecutive same-kind segments;
        wave i holds every tenant's i-th segment, grouped by kind.
        Inserts across tenants in one wave coalesce into one fleet
        count."""
        segs: Dict[str, List[Tuple[str, List[_FleetRequest]]]] = {}
        for r in batch:
            runs = segs.setdefault(r.tenant, [])
            if runs and runs[-1][0] == r.kind:
                runs[-1][1].append(r)
            else:
                runs.append((r.kind, [r]))
        depth = max((len(v) for v in segs.values()), default=0)
        for i in range(depth):
            wave: Dict[str, List[Tuple[str, List[_FleetRequest]]]] = {
                "insert": [], "score": [], "query": []}
            for tid, runs in segs.items():
                if i < len(runs):
                    kind, reqs = runs[i]
                    wave[kind].append((tid, reqs))
            yield wave

    def _dispatch(self, batch: List[_FleetRequest]) -> None:
        self._c_batches.inc()
        self._h_fill.observe(len(batch) / self.config.max_batch)
        for wave in self._waves(batch):
            # the apply helpers fail their own dispatch errors; anything
            # after them (resolution, metrics, tenant_stats) must still
            # fail every unresolved future of the wave
            try:
                if wave["insert"]:
                    self._apply_insert_wave(wave["insert"])
                if wave["score"]:
                    self._apply_score_wave(wave["score"])
                for tid, reqs in wave["query"]:
                    snap = self.tenant_stats(tid)
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_result(snap)
                        self._finish(r)
            except Exception as e:      # fail the wave, keep serving
                for group in (wave["insert"], wave["score"],
                              wave["query"]):
                    for _tid, reqs in group:
                        for r in reqs:
                            if not r.future.done():
                                r.future.set_exception(e)
                                self._finish(r)

    def _finish(self, r: _FleetRequest,
                now: Optional[float] = None) -> None:
        now = now if now is not None else time.perf_counter()
        self._h_latency.observe(now - r.t_enqueue)

    def _fail_group(self, groups, e: Exception) -> None:
        for _, reqs in groups:
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
                self._finish(r)

    def _apply_insert_wave(self, groups) -> None:
        """One wave of per-tenant insert runs: one fleet count, then the
        per-tenant stream extends; futures resolve per request."""
        t_start = time.perf_counter()
        # opened before the per-tenant concatenation, so plan assembly
        # bills to host_python
        wave = self.ledger.begin_wave()
        try:
            self._apply_insert_wave_ledgered(groups, t_start, wave)
        finally:
            self.ledger.abort_wave(wave)

    def _apply_insert_wave_ledgered(self, groups, t_start: float,
                                    wave) -> None:
        items = []
        for tid, reqs in groups:
            scores = np.concatenate([r.scores for r in reqs])
            labels = np.concatenate([r.labels for r in reqs]).astype(bool)
            items.append((tid, scores, labels))
        with maybe_span(self.tracer, "fleet.insert_wave"):
            try:
                self.fleet.apply_inserts(items)
                for tid, scores, labels in items:
                    stream = self._streams.get(tid)
                    if stream is None:
                        # dropped while its requests were queued
                        self.create_tenant(tid)
                        stream = self._streams[tid]
                    self._c_pairs.inc(stream.extend(scores, labels))
                    self._c_events.inc(len(scores))
            except Exception as e:
                self._fail_group(groups, e)
                return
        now = time.perf_counter()
        # close the host-tax wave at the resolve boundary: per-request
        # buckets tile [enqueue, resolve] exactly
        n_reqs = sum(len(reqs) for _, reqs in groups)
        buckets = self.ledger.finish_wave(
            wave, t_start=t_start, t_end=now,
            queue_waits=[t_start - r.t_enqueue
                         for _, reqs in groups for r in reqs])
        th = self.config.tail_exemplar_ms
        for tid, reqs in groups:
            h_tenant = None
            if self.tenancy.tenant_metrics:
                mt = self._metric_tenant(tid)
                h_tenant = self.metrics.histogram(
                    "insert_latency_s", labels={"tenant": mt})
                self.metrics.counter(
                    "tenant_events_total", labels={"tenant": mt}).inc(
                    sum(len(r.scores) for r in reqs))
            for r in reqs:
                if not r.future.done():
                    r.future.set_result(len(r.scores))
                lat = now - r.t_enqueue
                self._h_insert_lat.observe(lat)
                if h_tenant is not None:
                    h_tenant.observe(lat)
                if th is not None and lat * 1e3 >= th:
                    self._c_exemplars.inc()
                    self.flight.record(
                        "tail_exemplar", kind_req="insert", tenant=tid,
                        lat_ms=lat * 1e3, n_events=len(r.scores),
                        n_requests=n_reqs,
                        buckets=dict(buckets,
                                     queue_wait=t_start - r.t_enqueue))
                self._finish(r, now)

    def _apply_score_wave(self, groups) -> None:
        items = [(tid, np.concatenate([r.scores for r in reqs]))
                 for tid, reqs in groups]
        try:
            ranks = self.fleet.apply_scores(items)
        except Exception as e:
            self._fail_group(groups, e)
            return
        for (tid, reqs), rk in zip(groups, ranks):
            off = 0
            for r in reqs:
                n = len(r.scores)
                if not r.future.done():
                    r.future.set_result(rk[off:off + n])
                off += n
                self._finish(r)

    def _fail_pending(self) -> None:
        """Fail every queued request with an ``EngineClosedError`` naming
        its tenant."""
        with self._cv:
            pending = list(self._pending.items())
            self._pending.clear()
            self._rotation.clear()
            self._n_pending = 0
            self._cv.notify_all()
        for tid, dq in pending:
            for r in dq:
                if not r.future.done():
                    r.future.set_exception(EngineClosedError(
                        "engine closed before the request was applied "
                        f"(tenant={tid})", tenant=tid))
                self._finish(r)

    # ------------------------------------------------------------------ #
    def tenant_stats(self, tid: str) -> dict:
        out = dict(self.fleet.tenant_state(tid) or {"tenant": tid})
        st = self._streams.get(tid)
        if st is not None:
            out["estimate_incomplete"] = st.estimate()
            out["streaming"] = st.state()
        out["auc_exact"] = out.pop("auc", None)
        return out

    def stats(self) -> dict:
        return {
            "metrics": self.metrics.snapshot(),
            "fleet": self.fleet.state(),
            "tenants_live": self.fleet.n_tenants,
        }

    def close(self, timeout: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        with self._cv:
            self._cv.notify_all()
        self._worker.join(timeout=timeout)
        self._fail_pending()
        self.fleet.close(timeout=timeout)
        self.flight.record("engine_closed")

    def __enter__(self) -> "MultiTenantEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
