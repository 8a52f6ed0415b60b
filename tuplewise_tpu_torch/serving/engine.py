"""Async micro-batched request path of the streaming estimators.

The single-tenant counterpart of ``tuplewise_tpu.serving.engine``.
Request threads submit small insert/score/query requests; one batcher
thread drains the bounded queue, coalesces consecutive same-kind
requests (order between kinds is kept, so a query issued after an insert
observes it) and applies each run as one call: with
``count_kernel=True`` an insert micro-batch is one launch of the fused
count kernel on the card plus one copy of its counts back.

Batching: the batcher blocks for the first request, then drains what
arrives within ``flush_timeout_s`` up to ``max_batch``. Backpressure is
explicit at enqueue time:

  * "reject"      — a full queue fails the submit with BackpressureError;
  * "drop_oldest" — the oldest queued request fails with
                    BackpressureError and the new one is admitted;
  * "block"       — the submitting thread waits for capacity.

Every engine owns a ``MetricsRegistry`` (request and batch counters,
latency, batch-fill and queue-depth histograms, live gauges), the
per-stage insert-latency attribution (queue_wait, coalesce, wal_append,
index_insert, stream_extend, snapshot, resolve: consecutive boundary
timestamps, so one request's stages sum to its insert latency), the
host-tax ``WaveLedger`` below the stages, a ``FlightRecorder`` of
lifecycle events, and, with ``health=True``, CI-width and drift
monitors of the streaming estimate.

Lifecycle: the batcher runs under a supervisor that restarts it if it
dies (``batcher_restarts``); ``close()`` drains the queue and fails
unapplied requests, blocked producers included, with
``EngineClosedError``; per-request deadlines (``deadline_s``) fail stale
requests with ``DeadlineExceededError``, at dispatch or from a reaper
thread; NaN/inf scores and shape mismatches raise ``PoisonEventError``
at the edge. ``mesh_shards`` shards the exact index over a mesh of that
many workers (with its delta tiers, ``delta_fraction`` and
``max_delta_runs``), and a ``chaos`` injector fires the ``batcher``
point between batches (a crash there exercises the supervisor) and the
index's points. Crash-safe recovery (``snapshot_dir``/``recover``) and
span tracing are not ported yet and raise ``NotImplementedError``; the
``wal_append`` and ``snapshot`` stages stay in the attribution and
measure no work.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional, Tuple

import numpy as np

from tuplewise_tpu_torch.obs.flight import FlightRecorder
from tuplewise_tpu_torch.obs.health import DriftDetector, EstimateHealth
from tuplewise_tpu_torch.obs.ledger import WaveLedger
from tuplewise_tpu_torch.obs.report import INSERT_STAGES, stage_metric
from tuplewise_tpu_torch.obs.tracing import check_tracer, maybe_span
from tuplewise_tpu_torch.serving.index import ExactAucIndex
from tuplewise_tpu_torch.serving.streaming import StreamingIncompleteU
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry

_KINDS = ("insert", "score", "query")


class BackpressureError(RuntimeError):
    """The request was shed by the engine's backpressure policy."""


class EngineClosedError(RuntimeError):
    """The engine shut down before (or while) the request was applied.
    ``tenant`` carries the request's tenant tag when it had one."""

    def __init__(self, msg: str, tenant: Optional[str] = None):
        super().__init__(msg)
        self.tenant = tenant


class PoisonEventError(ValueError):
    """An insert payload failed edge validation (NaN/inf score, shape
    mismatch) and was rejected before reaching the index."""


class DeadlineExceededError(RuntimeError):
    """The request aged past ``ServingConfig.deadline_s`` in the queue
    and was failed rather than served stale."""


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the online service: the JAX package's fields of the
    service, with ``engine="torch"`` and a ``device`` (the card unless
    "cpu"). ``snapshot_dir``/``recover`` are not ported yet and raise
    when set; the WAL knobs are not ported yet."""

    kernel: str = "auc"
    budget: int = 64               # incomplete-U pairs per arrival
    reservoir: int = 4096          # per-class reservoir capacity
    design: str = "swr"            # partner sampling design
    window: Optional[int] = None   # sliding window (arrivals); None = all
    compact_every: int = 512       # index buffer size triggering compaction
    engine: str = "torch"          # index count/compaction engine
    device: Optional[str] = None   # engine="torch": None = the card
    mesh_shards: Optional[int] = None  # shard the index over a mesh
    bg_compact: bool = False       # compact on a side thread
    # the sharded index's delta tiers: > 0 ships O(buffer) delta runs a
    # minor compaction and folds them back on the mesh once they exceed
    # this fraction of the base; 0 = host merge and full re-placement
    delta_fraction: float = 0.25
    max_delta_runs: int = 64       # fold after this many minors merged
    # one fused count-kernel launch per insert micro-batch (False:
    # torch.searchsorted per query set); the integers are the same
    count_kernel: bool = False
    max_batch: int = 256           # micro-batch size cap
    flush_timeout_s: float = 0.002  # batcher drain window
    queue_size: int = 1024         # bounded request queue
    policy: str = "reject"         # reject | drop_oldest | block
    deadline_s: Optional[float] = None  # fail requests older than this
    snapshot_dir: Optional[str] = None  # not ported yet
    recover: bool = False               # not ported yet
    flight_recorder_size: int = 4096   # lifecycle-event ring size
    # CI-width tracking of the streaming estimate and a windowed drift
    # check against the exact index (AUC kernel only)
    health: bool = True
    drift_window: int = 256        # micro-batches in the drift window
    drift_threshold: float = 0.05  # rolling |live - oracle| that alerts
    # an insert at or above this latency records its host-tax buckets
    # as a `tail_exemplar` flight event; None = never
    tail_exemplar_ms: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.policy not in ("reject", "drop_oldest", "block"):
            raise ValueError(f"unknown backpressure policy {self.policy!r}")
        if self.engine not in ("torch", "numpy"):
            raise ValueError(
                f"engine must be 'torch' or 'numpy': {self.engine!r}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {self.max_batch}")
        if self.queue_size < 1:
            raise ValueError(f"queue_size must be >= 1: {self.queue_size}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0: {self.deadline_s}")
        if self.flight_recorder_size < 1:
            raise ValueError(
                f"flight_recorder_size must be >= 1: "
                f"{self.flight_recorder_size}")
        if self.drift_window < 1:
            raise ValueError(
                f"drift_window must be >= 1: {self.drift_window}")
        if self.drift_threshold <= 0:
            raise ValueError(
                f"drift_threshold must be > 0: {self.drift_threshold}")
        if self.tail_exemplar_ms is not None and self.tail_exemplar_ms <= 0:
            raise ValueError(
                f"tail_exemplar_ms must be > 0: {self.tail_exemplar_ms}")
        if self.delta_fraction < 0:
            raise ValueError(
                f"delta_fraction must be >= 0: {self.delta_fraction}")
        if self.max_delta_runs < 1:
            raise ValueError(
                f"max_delta_runs must be >= 1: {self.max_delta_runs}")


class _Request:
    __slots__ = ("kind", "scores", "labels", "future", "t_enqueue",
                 "tenant")

    def __init__(self, kind: str, scores, labels, tenant=None):
        self.kind = kind
        self.scores = scores
        self.labels = labels
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        # optional tag carried so failure paths can name the owner
        self.tenant = tenant


class MicroBatchEngine:
    """Bounded-queue dynamic batcher over the streaming estimators.

    Use as a context manager (or call ``close()``): a worker thread runs
    between construction and close.
    """

    def __init__(self, config: Optional[ServingConfig] = None,
                 chaos=None, tracer=None, **overrides):
        if config is None:
            config = ServingConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        if config.snapshot_dir or config.recover:
            raise NotImplementedError(
                "crash-safe recovery (snapshot_dir/recover) is not ported "
                "to tuplewise_tpu_torch yet")
        check_tracer(tracer)
        self.config = config
        self.chaos = chaos
        self.tracer = tracer
        self.metrics = MetricsRegistry()
        self.flight = FlightRecorder(capacity=config.flight_recorder_size)
        if chaos is not None:
            # every injected fault records a flight event
            chaos.attach(flight=self.flight)
        # the index records compactions into the engine's registry, so
        # stats() carries the pause histogram
        self.index = ExactAucIndex(
            window=config.window, compact_every=config.compact_every,
            engine=config.engine, device=config.device,
            shards=config.mesh_shards, bg_compact=config.bg_compact,
            metrics=self.metrics, count_kernel=config.count_kernel,
            flight=self.flight, chaos=chaos,
            delta_fraction=config.delta_fraction,
            max_delta_runs=config.max_delta_runs,
        ) if config.kernel == "auc" else None
        self._est_health = self._drift = None
        if config.health:
            self._est_health = EstimateHealth(metrics=self.metrics)
            self._drift = DriftDetector(
                window=config.drift_window,
                threshold=config.drift_threshold,
                metrics=self.metrics, flight=self.flight)
        self.streaming = StreamingIncompleteU(
            kernel=config.kernel, budget=config.budget,
            reservoir=config.reservoir, design=config.design,
            seed=config.seed, health=self._est_health,
        )
        m = self.metrics
        self._c_req = {k: m.counter(f"requests_{k}_total") for k in _KINDS}
        self._c_rejected = m.counter("rejected_total")
        self._c_dropped = m.counter("dropped_total")
        self._c_batches = m.counter("batches_total")
        self._c_events = m.counter("events_total")
        self._c_pairs = m.counter("incomplete_pairs_total")
        self._c_poison = m.counter("poison_rejects")
        self._c_deadline = m.counter("deadline_expired_total")
        self._c_batcher_restarts = m.counter("batcher_restarts")
        self._h_latency = m.histogram("request_latency_s")
        # per-event insert latency (enqueue -> applied)
        self._h_insert_lat = m.histogram("insert_latency_s")
        self._h_fill = m.histogram(
            "batch_fill", buckets=[i / 16 for i in range(1, 17)])
        self._h_depth = m.histogram(
            "queue_depth", buckets=[1, 2, 4, 8, 16, 32, 64, 128, 256,
                                    512, 1024, 2048])
        self._h_stage = {s: m.histogram(stage_metric(s))
                         for s in INSERT_STAGES}
        self.ledger = WaveLedger(m)
        self._c_exemplars = m.counter("tail_exemplars_total")
        self._g_depth = m.gauge("queue_depth_live")
        self._g_inflight = m.gauge("inflight_requests")
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=config.queue_size)
        self._lock = threading.Lock()   # guards estimator state
        self._closed = False
        self._worker = threading.Thread(
            target=self._supervise, name="tuplewise-batcher", daemon=True)
        self._worker.start()
        # deadline reaper: dispatch-time expiry only runs when the
        # batcher dispatches, so a timer also fails over-deadline queued
        # requests, whoever gets there first
        self._reaper = None
        if config.deadline_s is not None:
            self._reaper = threading.Thread(
                target=self._reap_expired, name="tuplewise-reaper",
                daemon=True)
            self._reaper.start()

    # ------------------------------------------------------------------ #
    # request side                                                       #
    # ------------------------------------------------------------------ #
    def submit(self, kind: str, scores=None, labels=None,
               tenant=None) -> Future:
        """Enqueue one request; returns its Future.

        insert: scores + labels (scalars or arrays), resolves to the
          number of events inserted.
        score: scores, resolves to fractional ranks vs negatives.
        query: no payload, resolves to a state snapshot dict.
        tenant: optional tag; close and deadline failures name it.
        """
        if kind not in _KINDS:
            raise ValueError(f"unknown request kind {kind!r}")
        if self._closed:
            raise EngineClosedError("engine is closed", tenant=tenant)
        if kind == "insert":
            scores, labels = self._validate_insert(scores, labels)
        elif kind == "score":
            scores = np.atleast_1d(np.asarray(scores, dtype=np.float64))
        req = _Request(kind, scores, labels, tenant=tenant)
        self._c_req[kind].inc()
        policy = self.config.policy
        if policy == "block":
            self._q.put(req)
            if self._closed:
                # close() raced this enqueue: its drain may already have
                # run, so drain (and fail) here
                self._fail_queued()
        else:
            try:
                self._q.put_nowait(req)
            except queue.Full:
                if policy == "reject":
                    self._c_rejected.inc()
                    raise BackpressureError(
                        f"queue full ({self.config.queue_size}); request "
                        "rejected") from None
                # drop_oldest: shed the stalest queued request; the
                # done() guard arbitrates against the deadline reaper,
                # which fails queued requests without dequeuing them
                try:
                    old = self._q.get_nowait()
                    if old is not None and not old.future.done():
                        self._c_dropped.inc()
                        old.future.set_exception(BackpressureError(
                            "dropped by a newer request (drop_oldest)"))
                except queue.Empty:
                    pass
                self._q.put(req)
        return req.future

    def _poison(self, msg: str) -> None:
        """Count, flight-record and raise one poison rejection."""
        self._c_poison.inc()
        self.flight.record("poison_reject", reason=msg)
        raise PoisonEventError(msg)

    def _validate_insert(self, scores, labels):
        """Edge validation: a poison event fails its submitter (typed,
        counted) instead of riding a micro-batch into the index."""
        scores = np.atleast_1d(np.asarray(scores, dtype=np.float64))
        labels = np.atleast_1d(np.asarray(labels))
        if scores.shape != labels.shape:
            self._poison(
                f"insert: scores/labels shape mismatch: {scores.shape} "
                f"vs {labels.shape}")
        if len(scores) and not np.all(np.isfinite(scores)):
            self._poison("insert: non-finite score(s) rejected")
        if labels.dtype.kind == "f" and len(labels) \
                and not np.all(np.isfinite(labels)):
            self._poison("insert: non-finite label(s) rejected")
        return scores, labels

    def insert(self, scores, labels, tenant=None) -> Future:
        return self.submit("insert", scores, labels, tenant=tenant)

    def score(self, scores, tenant=None) -> Future:
        return self.submit("score", scores, tenant=tenant)

    def query(self, tenant=None) -> Future:
        return self.submit("query", tenant=tenant)

    def flush(self, timeout: Optional[float] = 30.0) -> dict:
        """Barrier: wait until everything enqueued so far is applied."""
        return self.submit("query").result(timeout=timeout)

    # ------------------------------------------------------------------ #
    # batcher side                                                       #
    # ------------------------------------------------------------------ #
    def _supervise(self) -> None:
        """Restart the batcher loop in place if it dies, and count it;
        on close, just exit (close() drains)."""
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
                # fired between batches: no future is in flight here, so
                # an injected crash exercises the supervisor's restart
                # without stranding a request
                self.chaos.fire("batcher")
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if first is None or self._closed:
                self._fail_queued(first)
                return
            # the queue-depth gauge updates here, where qsize is read
            # anyway, never on the submit path
            depth = self._q.qsize() + 1
            self._h_depth.observe(depth)
            self._g_depth.set(depth)
            batch = [first]
            deadline = time.perf_counter() + self.config.flush_timeout_s
            while len(batch) < self.config.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(batch)
                    self._fail_queued()
                    return
                batch.append(nxt)
            self._dispatch(batch)

    def _fail_queued(self, first: Optional[_Request] = None) -> None:
        """Drain the queue, failing every unapplied request with
        EngineClosedError. Draining is what unblocks producers stuck in
        a full-queue put under the "block" policy."""
        r = first
        while True:
            if r is not None and not r.future.done():
                if r.tenant is not None:
                    r.future.set_exception(EngineClosedError(
                        "engine closed before the request was applied "
                        f"(tenant={r.tenant})", tenant=r.tenant))
                else:
                    r.future.set_exception(EngineClosedError(
                        "engine closed before the request was applied"))
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return

    def _dispatch(self, batch: List[_Request]) -> None:
        if self.config.deadline_s is not None:
            batch = self._expire(batch)
            if not batch:
                return
        self._g_inflight.set(self._q.qsize() + len(batch))
        self._c_batches.inc()
        self._h_fill.observe(len(batch) / self.config.max_batch)
        for kind, run in self._runs(batch):
            try:
                if kind == "insert":
                    self._apply_inserts(run)
                elif kind == "score":
                    self._apply_scores(run)
                else:
                    snap = self.stats()
                    for r in run:
                        if not r.future.done():
                            r.future.set_result(snap)
            except Exception as e:      # fail the run, keep serving
                for r in run:
                    if not r.future.done():
                        r.future.set_exception(e)
            now = time.perf_counter()
            for r in run:
                self._h_latency.observe(now - r.t_enqueue)
        self._g_inflight.set(self._q.qsize())

    def _expire_request(self, r: _Request, now: float) -> bool:
        """Fail one over-deadline request typed; True when this caller
        won the resolution (the dispatch check and the reaper race, and
        only the winner counts the expiry)."""
        try:
            r.future.set_exception(DeadlineExceededError(
                f"request expired after {now - r.t_enqueue:.3f}s "
                f"in queue (deadline_s={self.config.deadline_s})"))
        except InvalidStateError:   # already resolved elsewhere
            return False
        self._c_deadline.inc()
        self.flight.record("deadline_expired", kind_req=r.kind,
                           waited_s=now - r.t_enqueue)
        return True

    def _expire(self, batch: List[_Request]) -> List[_Request]:
        """Deadline enforcement at dispatch: a request that aged past
        ``deadline_s`` fails typed; ones the reaper already failed are
        dropped silently."""
        now = time.perf_counter()
        live: List[_Request] = []
        for r in batch:
            if r.future.done():
                continue
            if now - r.t_enqueue > self.config.deadline_s:
                self._expire_request(r, now)
            else:
                live.append(r)
        return live

    def _reap_expired(self) -> None:
        """Deadline timer: periodically scan the queued requests (under
        the queue's own mutex, without dequeuing) and fail those past
        ``deadline_s``, so a producer blocked on a wedged batcher gets
        its typed failure in bounded time."""
        deadline = self.config.deadline_s
        interval = min(max(deadline / 4.0, 0.005), 0.25)
        while not self._closed:
            time.sleep(interval)
            now = time.perf_counter()
            with self._q.mutex:
                stale = [r for r in self._q.queue
                         if r is not None and not r.future.done()
                         and now - r.t_enqueue > deadline]
            for r in stale:
                self._expire_request(r, now)

    @staticmethod
    def _runs(batch: List[_Request]) -> List[Tuple[str, List[_Request]]]:
        """Split a batch into maximal consecutive same-kind runs."""
        runs: List[Tuple[str, List[_Request]]] = []
        for r in batch:
            if runs and runs[-1][0] == r.kind:
                runs[-1][1].append(r)
            else:
                runs.append((r.kind, [r]))
        return runs

    def _apply_inserts(self, run: List[_Request]) -> None:
        t_start = time.perf_counter()            # queue_wait ends
        # device sections and GC pauses on this thread bill to the wave
        wave = self.ledger.begin_wave()
        try:
            self._apply_inserts_wave(run, t_start, wave)
        finally:
            self.ledger.abort_wave(wave)

    def _apply_inserts_wave(self, run: List[_Request], t_start: float,
                            wave) -> None:
        scores = np.concatenate([r.scores for r in run])
        labels = np.concatenate([r.labels for r in run]).astype(bool)
        with maybe_span(self.tracer, "insert.apply"):
            t_lock_req = time.perf_counter()     # lock wait begins
            with self._lock:
                t_lock = time.perf_counter()     # coalesce = concat+lock
                t_wal = time.perf_counter()      # no write-ahead log yet
                if self.index is not None:
                    self.index.insert_batch(scores, labels)
                t_index = time.perf_counter()
                spent = self.streaming.extend(scores, labels)
                t_stream = time.perf_counter()
                t_snap = time.perf_counter()     # no snapshots yet
        self._c_events.inc(len(scores))
        self._c_pairs.inc(spent)
        for r in run:
            # a request the reaper expired mid-flight keeps its typed
            # failure; the event is applied either way
            if not r.future.done():
                r.future.set_result(len(r.scores))
        t_end = time.perf_counter()              # resolve ends
        n = len(run)
        h = self._h_stage
        h["coalesce"].observe_n(t_lock - t_start, n)
        h["wal_append"].observe_n(t_wal - t_lock, n)
        h["index_insert"].observe_n(t_index - t_wal, n)
        h["stream_extend"].observe_n(t_stream - t_index, n)
        h["snapshot"].observe_n(t_snap - t_stream, n)
        h["resolve"].observe_n(t_end - t_snap, n)
        qw = h["queue_wait"]
        queue_waits = []
        for r in run:
            qw_r = t_start - r.t_enqueue
            queue_waits.append(qw_r)
            qw.observe(qw_r)
            self._h_insert_lat.observe(t_end - r.t_enqueue)
        buckets = self.ledger.finish_wave(
            wave, t_start=t_start, t_end=t_end,
            queue_waits=queue_waits,
            t_lock_req=t_lock_req, t_lock=t_lock)
        th = self.config.tail_exemplar_ms
        if th is not None:
            for r, qw_r in zip(run, queue_waits):
                lat_ms = (t_end - r.t_enqueue) * 1e3
                if lat_ms >= th:
                    self._c_exemplars.inc()
                    self.flight.record(
                        "tail_exemplar", kind_req="insert",
                        lat_ms=lat_ms, n_events=len(r.scores),
                        buckets=dict(buckets, queue_wait=qw_r))
        # drift check: live budgeted estimate vs the exact index, once
        # per micro-batch, after the latency boundaries
        if self._drift is not None and self.index is not None:
            live = self.streaming.estimate()
            oracle = self.index.auc()
            if live is not None and oracle is not None:
                self._drift.observe(live, oracle)

    def _apply_scores(self, run: List[_Request]) -> None:
        if self.index is None:
            raise ValueError(
                "score requests need the exact AUC index "
                "(kernel='auc')")
        scores = np.concatenate([r.scores for r in run])
        with maybe_span(self.tracer, "score.apply"):
            with self._lock:
                ranks = self.index.score_batch(scores)
        off = 0
        for r in run:
            n = len(r.scores)
            if not r.future.done():
                r.future.set_result(ranks[off:off + n])
            off += n

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        with self._lock:
            out = {
                "metrics": self.metrics.snapshot(),
                "streaming": self.streaming.state(),
            }
            if self._drift is not None:
                out["drift"] = self._drift.state()
            if self.index is not None:
                out["index"] = self.index.state()
                out["auc_exact"] = self.index.auc()
            out["estimate_incomplete"] = self.streaming.estimate()
        return out

    def close(self, timeout: float = 10.0) -> None:
        """Shut down without stranding anyone: the worker drains the
        queue (which unblocks "block"-policy producers) and every
        unapplied request fails with ``EngineClosedError``; a final drain
        here catches requests that raced the shutdown."""
        if self._closed:
            return
        self._closed = True
        try:
            self._q.put_nowait(None)    # wake the worker fast; the
        except queue.Full:              # 0.05 s poll catches it anyway
            pass
        self._worker.join(timeout=timeout)
        self._fail_queued()
        if self.index is not None:
            self.index.close(timeout=timeout)
        self.flight.record("engine_closed")

    def __enter__(self) -> "MicroBatchEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
