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

Mesh sharding, the delta and major-merge tiers, self-healing and fault
injection of the JAX index are not ported yet: ``shards``, ``mesh`` and
``chaos`` raise ``NotImplementedError``.

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

from tuplewise_tpu_torch.obs.tracing import check_tracer, maybe_span
from tuplewise_tpu_torch.parallel.sharded_counts import (
    next_bucket, place_run, signed_pair_counts,
)
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry


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
    the tombstones, and the device copy of the base.

    ``snap_buf``/``snap_tomb`` mark the prefixes an in-flight background
    build has snapshotted (0 when idle): mutators treat them as
    immutable, and the swap trims exactly them. ``placed_base`` is the
    host array that ``base_dev`` mirrors.
    """

    def __init__(self, dtype):
        self.dtype = dtype
        self.base = np.empty(0, dtype=dtype)
        self.buf: List[float] = []
        self.tomb: List[float] = []
        self.base_dev: Optional[torch.Tensor] = None
        self.cap = 0
        self.placed_base: Optional[np.ndarray] = None
        self.building = False
        self.snap_buf = 0
        self.snap_tomb = 0

    @property
    def size(self) -> int:
        return len(self.base) + len(self.buf) - len(self.tomb)

    @property
    def pending(self) -> Tuple[int, int]:
        """(buf, tomb) entries not claimed by an in-flight build."""
        return len(self.buf) - self.snap_buf, len(self.tomb) - self.snap_tomb

    def values(self) -> np.ndarray:
        """Current multiset as a sorted array (oracle path, O(n))."""
        out = np.concatenate(
            [self.base, np.asarray(self.buf, dtype=self.dtype)])
        out = np.sort(out, kind="stable")
        return _remove_sorted(out, self.tomb)


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
        swap.
      count_kernel: ``engine="torch"`` only: each insert micro-batch's
        one fused count launches the signed-count kernel; False counts
        with ``torch.searchsorted``. The integers are the same.
      metrics: a ``MetricsRegistry`` receiving ``compactions_total``,
        ``compaction_pause_s``, ``bytes_h2d`` and the count counters;
        None = a private one.
      flight: optional ``FlightRecorder`` receiving compaction events.
      shards, mesh, chaos, tracer: not ported yet; anything but None
        raises.
    """

    def __init__(self, window: Optional[int] = None,
                 compact_every: int = 512, engine: str = "torch",
                 device=None, bg_compact: bool = False, metrics=None,
                 count_kernel: bool = False, flight=None,
                 shards: Optional[int] = None, mesh=None, chaos=None,
                 tracer=None):
        if engine not in ("torch", "numpy"):
            raise ValueError(f"engine must be 'torch' or 'numpy': {engine!r}")
        if window is not None and window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if compact_every < 1:
            raise ValueError(f"compact_every must be >= 1: {compact_every}")
        if shards is not None or mesh is not None or chaos is not None:
            raise NotImplementedError(
                "mesh-sharded base runs, the delta tiers, self-healing and "
                "fault injection are not ported to tuplewise_tpu_torch yet")
        check_tracer(tracer)
        self.window = window
        self.compact_every = compact_every
        self.engine = engine
        self.bg_compact = bg_compact
        self.count_kernel = bool(count_kernel)
        self._ck = self.count_kernel and engine == "torch"
        self.device = resolve_device(device) if engine == "torch" else None
        self.dtype = np.float32 if engine == "torch" else np.float64
        self.tracer = tracer
        self.flight = flight
        self._pos = _ClassSide(self.dtype)
        self._neg = _ClassSide(self.dtype)
        # arrival order for window eviction: (value, is_pos)
        self._log: Deque[Tuple[float, bool]] = collections.deque()
        self._wins2 = 0          # exact: a Python int never overflows
        self.n_compactions = 0
        self.n_evicted = 0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_compactions = self.metrics.counter("compactions_total")
        self._h_pause = self.metrics.histogram("compaction_pause_s")
        self._g_tomb = self.metrics.gauge("tombstone_occupancy")
        self.metrics.gauge("mesh_width").set(0)
        # host-to-device bytes of base placements
        self._c_bytes = self.metrics.counter("bytes_h2d")
        self._c_bg_restarts = self.metrics.counter("bg_compactor_restarts")
        # calls = fused-kernel dispatches, one per insert micro-batch;
        # fallbacks stays 0: nothing falls back from the kernel
        self.metrics.counter("count_kernel_calls_total")
        self.metrics.counter("count_kernel_fallbacks_total")
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
        """The side's runs for a device count: its base run, +1, from the
        device copy, which is re-placed only when the host run was
        replaced (caller holds the lock)."""
        if len(side.base) == 0:
            return []
        if side.placed_base is not side.base:
            side.cap = next_bucket(len(side.base))
            side.base_dev = place_run(side.base, side.cap, self.device)
            side.placed_base = side.base
            self._c_bytes.inc(side.cap * 4)
        return [(side.base_dev, side.cap, 1)]

    def _signed_counts(self, runs_a, runs_b, q_a: np.ndarray,
                       q_b: np.ndarray):
        return signed_pair_counts(
            None, runs_a, runs_b, q_a, q_b, self.dtype,
            kernel=True if self._ck else None, metrics=self.metrics,
            device=self.device)

    def _base_counts(self, side: _ClassSide,
                     q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(less, leq) counts of each query against side.base."""
        if len(q) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        if self.engine == "torch":
            less, leq, _, _ = self._signed_counts(
                self._runs(side), (), q, np.zeros(0, self.dtype))
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
        base-run counts: the pending buffer (+) and the tombstones (-)
        adjust on the host."""
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
        return less, eq

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
            self._runs(self._neg), self._runs(self._pos),
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
        self._g_tomb.set(len(self._pos.tomb) + len(self._neg.tomb))

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
                    self._full_compact(side)

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
                if side.buf or side.tomb:
                    self._full_compact(side)

    def _merge(self, side_base: np.ndarray, buf: List[float],
               tomb: List[float], on_thread: bool) -> np.ndarray:
        """Pure merge: sorted(base + buf) minus tombstones.

        ``on_thread`` (synchronous ``engine="torch"`` compaction) sorts
        on the device: the caller's thread already owns it. The
        background merge stays on the host: a device sort there would
        queue behind the batcher's counts on the same stream. The host
        path sorts only the buffer and splices it in, O(n + b log b).
        The values are the same either way."""
        buf_sorted = np.sort(np.asarray(buf, dtype=self.dtype))
        if len(buf_sorted) == 0:
            merged = side_base
        elif on_thread and self.engine == "torch":
            t = torch.from_numpy(np.concatenate([side_base, buf_sorted]))
            merged = torch.sort(t.to(self.device)).values.cpu().numpy()
        else:
            merged = _splice_merge(side_base, buf_sorted)
        return _remove_sorted(merged, tomb)

    def _full_compact(self, side: _ClassSide) -> None:
        """Fold the buffer into the base and drop the tombstones (caller
        holds the lock); the work and its pause run inline."""
        t0 = time.perf_counter()
        with maybe_span(self.tracer, "compaction.sync",
                        side=self._side_name(side)):
            merged = self._merge(side.base, side.buf, side.tomb,
                                 on_thread=True)
            side.base = merged
            side.buf = []
            side.tomb = []
        self.n_compactions += 1
        self._c_compactions.inc()
        self._update_gauges()
        self._flight_event("compaction", tier="full",
                           side=self._side_name(side),
                           base_events=len(merged))
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
        with self._cv:
            base = side.base
            buf_snap = list(side.buf[: side.snap_buf])
            tomb_snap = list(side.tomb[: side.snap_tomb])
        # the merge runs with the lock released; inserts keep landing in
        # the buffer
        with maybe_span(self.tracer, "compactor.merge",
                        n_buf=len(buf_snap)):
            merged = self._merge(base, buf_snap, tomb_snap, on_thread=False)
        with self._cv:
            t0 = time.perf_counter()
            side.base = merged
            del side.buf[: side.snap_buf]
            del side.tomb[: side.snap_tomb]
            side.snap_buf = side.snap_tomb = 0
            side.building = False
            self.n_compactions += 1
            self._c_compactions.inc()
            self._update_gauges()
            self._flight_event("compaction", tier="bg_merge",
                               side=self._side_name(side),
                               base_events=len(merged))
            # the swap is the only pause the request path can observe
            self._h_pause.observe(time.perf_counter() - t0)
            # keep draining if the buffer outgrew the threshold meanwhile
            buf_pending, tomb_pending = side.pending
            if (not self._closed
                    and (buf_pending >= self.compact_every
                         or tomb_pending >= self.compact_every)):
                self._submit_compact(side)
            self._cv.notify_all()

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
        """The JAX index's state keys; the tiers not ported yet report
        their idle values."""
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
                "shards": None,
                "bg_compact": self.bg_compact,
                "last_compactor_error": self.last_compactor_error,
                "delta_compact": False,
                "delta_runs": 0,
                "delta_events": 0,
                "tombstones": len(self._pos.tomb) + len(self._neg.tomb),
                "n_major_merges": 0,
                "last_major_merge_error": None,
                "count_kernel": self._ck,
                "device": None if self.device is None else str(self.device),
            }
