"""Crash-safe serving recovery: atomic snapshots and a replayable event
tail (write-ahead log).

A copy of ``tuplewise_tpu.serving.recovery``, with the same file layout,
records and ``.npz`` keys, so the two packages' WAL records and snapshot
arrays for one stream are equal. The exact index is deterministic state:
wins2 and the containers are a function of the admitted event sequence,
independent of batching. So crash safety is two durable artifacts:

* **Snapshot**: one ``.npz`` of the whole estimator state (base runs,
  delta runs and the tombstone multiset, buffers, tombstones, the arrival
  log, wins2 as a decimal string since it is an unbounded Python int,
  the incomplete-U sums, the reservoirs and the host RNG state via
  ``utils.rng.capture_np_rng``), written through
  ``utils.checkpoint.save_checkpoint`` (fsync'd temporary file and
  atomic rename: a snapshot exists completely or not at all). Device
  placements are a cache: a restore rebuilds them from the host arrays.
* **WAL**: an append-only JSONL log of admitted insert batches, flushed
  to the OS before the batch is applied, so a SIGKILL cannot lose an
  admitted event. ``wal_fsync="batch"`` also fsyncs every append
  (durable against power loss, at per-batch latency); the default
  ``"snapshot"`` fsyncs durable state only when a snapshot lands. Each
  entry carries its absolute event sequence number, so replay after a
  snapshot at seq S skips entries below S.

**Snapshot writes are asynchronous**: the batcher thread only captures
the state (host-array copies under the engine lock) and seals the live
WAL into a segment file; ``np.savez``, fsync and rename run on a side
writer thread, so inserts proceed during a slow write. The WAL is
segment-structured to make that safe under concurrent appends:

    events.wal              the live log (appends land here)
    events.wal.upto<SEQ>    sealed segments; every entry's seq < SEQ

At capture time (seq = S) the live log is sealed as ``upto S`` and a
fresh live log opened; once the snapshot at S has landed, the writer
deletes every segment whose name-seq <= S. A crash at any point leaves
snapshot, segments and live log that replay to the exact pre-crash
state: replay walks the segments in seq order, then the live log,
skipping entries below the snapshot's seq.

Recovery = restore the snapshot, replay the tail. Both are bit-exact:
wins2 round-trips through its decimal string, scores through JSON's
shortest-repr floats, and the tail replays through the same
``insert_batch`` integer-count updates the live path runs (on the card,
the count kernels), so every prefix AUC after recovery equals the
uninterrupted run's bit for bit.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from tuplewise_tpu_torch.obs.tracing import maybe_span
from tuplewise_tpu_torch.utils.checkpoint import (
    check_config, load_checkpoint, save_checkpoint,
)
from tuplewise_tpu_torch.utils.rng import capture_np_rng, restore_np_rng

SNAPSHOT_FILE = "snapshot.npz"
WAL_FILE = "events.wal"
_SEG_SEP = ".upto"


class EventLog:
    """Append-only JSONL WAL of admitted insert batches.

    ``fsync=True`` (``wal_fsync="batch"``) forces every append to disk
    — durable against power loss, at per-batch fsync latency; the
    default flush-only append survives process death (SIGKILL) but
    rides the page cache.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._f = open(path, "a", encoding="utf-8")

    def append(self, seq: int, scores: np.ndarray,
               labels: np.ndarray, tenant: Optional[str] = None) -> None:
        rec = {"seq": int(seq),
               "s": [float(x) for x in scores],
               "l": [int(bool(x)) for x in labels]}
        if tenant is not None:
            # tenant namespacing: one physical log, logically
            # namespaced by the tenant tag (thousands of tenants cannot
            # each own a file descriptor); replay groups by it
            rec["t"] = str(tenant)
        self._f.write(json.dumps(rec) + "\n")
        # flush past the process boundary: survives SIGKILL; fsync
        # additionally survives power loss (wal_fsync="batch")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def seal(self, upto_seq: int) -> str:
        """Rotate the live log aside as an immutable segment holding
        only entries with seq < ``upto_seq``, and reopen a fresh live
        log. Called by the snapshot capture (batcher thread) so the
        async writer can later delete exactly the entries the landed
        snapshot covers, while new appends keep flowing."""
        self._f.close()
        seg = f"{self.path}{_SEG_SEP}{int(upto_seq):020d}"
        os.replace(self.path, seg)
        self._f = open(self.path, "w", encoding="utf-8")
        return seg

    def truncate(self) -> None:
        """Start a fresh live log (synchronous-snapshot path: every
        entry is already inside the snapshot that just landed)."""
        self._f.close()
        self._f = open(self.path, "w", encoding="utf-8")

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def segments(path: str) -> List[Tuple[int, str]]:
        """Sealed (seq, segment_path) pairs for a live-log path, in
        ascending seq order."""
        d, name = os.path.split(path)
        prefix = name + _SEG_SEP
        out = []
        for fn in os.listdir(d or "."):
            if not fn.startswith(prefix):
                continue
            try:
                seq = int(fn[len(prefix):])
            except ValueError:
                continue
            out.append((seq, os.path.join(d, fn)))
        return sorted(out)

    @staticmethod
    def replay_records(path: str) -> Iterator[dict]:
        """Yield raw WAL records (``seq``/``s``/``l`` plus the optional
        tenant tag ``t``); a torn final line (the crash interrupted the
        write) ends the replay cleanly."""
        if not os.path.exists(path):
            return
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    return

    @staticmethod
    def replay(path: str) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Yield (seq, scores, labels) entries (tenant tags dropped)."""
        for rec in EventLog.replay_records(path):
            yield (int(rec["seq"]),
                   np.asarray(rec["s"], dtype=np.float64),
                   np.asarray(rec["l"], dtype=bool))

    @staticmethod
    def replay_all_records(path: str) -> Iterator[dict]:
        """Raw records from sealed segments (seq order) then the live
        log — the full surviving tail regardless of where a crash
        landed."""
        for _, seg in EventLog.segments(path):
            yield from EventLog.replay_records(seg)
        yield from EventLog.replay_records(path)

    @staticmethod
    def replay_all(path: str) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """(seq, scores, labels) over segments then the live log."""
        for rec in EventLog.replay_all_records(path):
            yield (int(rec["seq"]),
                   np.asarray(rec["s"], dtype=np.float64),
                   np.asarray(rec["l"], dtype=bool))


def _compat_config(config) -> dict:
    """The config keys a snapshot must agree on to be resumable —
    anything that changes what the recovered state MEANS."""
    return {
        "kernel": config.kernel, "budget": config.budget,
        "reservoir": config.reservoir, "design": config.design,
        "window": config.window, "engine": config.engine,
        "seed": config.seed,
    }


def capture_index_arrays(idx, extra: dict, prefix: str = "") -> dict:
    """Capture ONE exact index's containers into ``extra`` under
    ``prefix`` and return its meta dict (wins2 as a decimal string —
    it is an unbounded Python int — plus the lifecycle counters).
    The fleet snapshots a promoted whale tenant's index through the
    same function the single-tenant engine uses."""
    with idx._cv:
        for name, side in (("pos", idx._pos), ("neg", idx._neg)):
            # base arrays are rebound, never mutated in place
            # (compaction swaps a NEW merged array in), so aliasing
            # is a consistent capture with no O(n) copy
            extra[f"{prefix}{name}_base"] = np.asarray(side.base,
                                                       dtype=idx.dtype)
            extra[f"{prefix}{name}_buf"] = np.asarray(side.buf,
                                                      dtype=idx.dtype)
            extra[f"{prefix}{name}_tomb"] = np.asarray(side.tomb,
                                                       dtype=idx.dtype)
            # delta-compaction state: the host-
            # authoritative consolidated delta run (plus its
            # fold-trigger minor count) and the sorted tombstone
            # multiset; device placements are a pure cache rebuilt
            # on restore
            extra[f"{prefix}{name}_delta_run"] = np.asarray(
                side.delta_run, dtype=idx.dtype)
            extra[f"{prefix}{name}_delta_minors"] = np.asarray(
                [side.delta_minors], dtype=np.int64)
            extra[f"{prefix}{name}_tomb_run"] = np.asarray(
                side.tomb_run, dtype=idx.dtype)
        extra[f"{prefix}log_scores"] = np.asarray(
            [v for v, _ in idx._log], dtype=idx.dtype)
        extra[f"{prefix}log_labels"] = np.asarray(
            [p for _, p in idx._log], dtype=bool)
        return {
            "wins2": str(idx._wins2),
            "n_compactions": idx.n_compactions,
            "n_evicted": idx.n_evicted,
            "n_major_merges": idx.n_major_merges,
        }


def restore_index_arrays(idx, extra: dict, meta: dict,
                         prefix: str = "") -> None:
    """Restore ONE exact index's containers from a capture made by
    :func:`capture_index_arrays` (same ``prefix``), then rebuild the
    device placements (a pure cache)."""
    with idx._cv:
        for name, side in (("pos", idx._pos), ("neg", idx._neg)):
            side.base = extra[f"{prefix}{name}_base"].astype(idx.dtype)
            side.buf = extra[f"{prefix}{name}_buf"].astype(
                idx.dtype).tolist()
            side.tomb = extra[f"{prefix}{name}_tomb"].astype(
                idx.dtype).tolist()
            # delta run + tombstone multiset; absent in
            # pre-delta snapshots (empty defaults keep them loadable)
            dr = extra.get(f"{prefix}{name}_delta_run")
            side.delta_run = (dr.astype(idx.dtype) if dr is not None
                              else np.empty(0, dtype=idx.dtype))
            dm = extra.get(f"{prefix}{name}_delta_minors")
            side.delta_minors = int(dm[0]) if dm is not None else 0
            tr = extra.get(f"{prefix}{name}_tomb_run")
            side.tomb_run = (tr.astype(idx.dtype) if tr is not None
                             else np.empty(0, dtype=idx.dtype))
        idx._log = collections.deque(zip(
            extra[f"{prefix}log_scores"].astype(idx.dtype).tolist(),
            [bool(b) for b in extra[f"{prefix}log_labels"]]))
        idx._wins2 = int(meta["wins2"])
        idx.n_compactions = int(meta.get("n_compactions", 0))
        idx.n_evicted = int(meta.get("n_evicted", 0))
        idx.n_major_merges = int(meta.get("n_major_merges", 0))
        for side in (idx._pos, idx._neg):
            # the device copies are keyed on the identity of the host
            # arrays they mirror: clear them, so every count reads a
            # placement of the restored arrays (the tombstone mirror is
            # re-placed by the next ``_runs``)
            side.placed_base = None
            side.base_dev, side.cap = None, 0
            side.placed_tomb = None
            side.tomb_dev, side.tomb_cap = None, 0
            idx._place(side)
            idx._replace_deltas(side)


def capture_stream_arrays(st, extra: dict, prefix: str = "") -> dict:
    """Capture ONE streaming estimator (the incomplete-U sums and
    counts, both reservoirs) into ``extra`` under ``prefix``; returns
    its host RNG state for the config block. The fleet captures each
    tenant's estimator through it under the ``t{i}_`` prefix."""
    extra[f"{prefix}stream_sums"] = np.asarray([st._sum_h, st._sum_h2],
                                               dtype=np.float64)
    extra[f"{prefix}stream_counts"] = np.asarray(
        [st._n_terms, st.n_arrivals], dtype=np.int64)
    for name, res in (("rpos", st._pos), ("rneg", st._neg)):
        extra[f"{prefix}{name}_items"] = res.items[: res.size].copy()
        extra[f"{prefix}{name}_meta"] = np.asarray([res.size, res.seen],
                                                   dtype=np.int64)
    return capture_np_rng(st._rng)


def restore_stream_arrays(st, extra: dict, rng_state: dict,
                          prefix: str = "") -> None:
    """Restore ONE streaming estimator from a capture made by
    :func:`capture_stream_arrays` (same ``prefix``) and its RNG state."""
    st._sum_h, st._sum_h2 = (float(x) for x in extra[f"{prefix}stream_sums"])
    st._n_terms, st.n_arrivals = (
        int(x) for x in extra[f"{prefix}stream_counts"])
    for name, res in (("rpos", st._pos), ("rneg", st._neg)):
        size, seen = (int(x) for x in extra[f"{prefix}{name}_meta"])
        res.items[:size] = extra[f"{prefix}{name}_items"]
        res.size, res.seen = size, seen
    restore_np_rng(st._rng, rng_state)


def capture_snapshot_state(engine) -> Tuple[dict, dict]:
    """The atomic handoff: copy the engine's full
    estimator state into host arrays (cheap — no serialization, no
    disk) and return (extra, cfg) for a writer to persist. Runs on the
    batcher thread under the engine lock, so the capture is a
    consistent cut at the current event seq."""
    extra = {}
    cfg = dict(_compat_config(engine.config))
    idx = engine.index
    if idx is not None:
        cfg.update(capture_index_arrays(idx, extra))
    cfg["rng_state"] = capture_stream_arrays(engine.streaming, extra)
    return extra, cfg


def write_snapshot(directory: str, *, seq: int, extra: dict,
                   cfg: dict) -> None:
    """Persist a captured state atomically (fsync'd temp + rename)."""
    save_checkpoint(os.path.join(directory, SNAPSHOT_FILE),
                    step=seq, extra=extra, config=cfg)


def save_snapshot(directory: str, *, seq: int, engine) -> None:
    """Capture + write in one (synchronous) call."""
    extra, cfg = capture_snapshot_state(engine)
    write_snapshot(directory, seq=seq, extra=extra, cfg=cfg)


def restore_snapshot(directory: str, engine) -> Optional[int]:
    """Restore a snapshot into a freshly-constructed engine; returns
    the snapshot's event seq, or None when no snapshot exists. Raises
    if the stored config is incompatible with the engine's (resuming a
    different experiment would silently corrupt the statistic)."""
    ck = load_checkpoint(os.path.join(directory, SNAPSHOT_FILE))
    if ck is None:
        return None
    cfg, extra = ck["config"], ck["extra"]
    check_config(
        {k: cfg.get(k) for k in _compat_config(engine.config)},
        _compat_config(engine.config))
    idx = engine.index
    if idx is not None and "pos_base" in extra:
        restore_index_arrays(idx, extra, cfg)
    restore_stream_arrays(engine.streaming, extra, cfg["rng_state"])
    return int(ck["step"])


class RecoveryManager:
    """Owns a recovery directory: the WAL, the snapshot cadence, the
    async writer, and the recover-on-start protocol. One per engine;
    capture/record calls arrive on the batcher thread (or before the
    worker starts) — the internal lock only coordinates with the side
    writer thread."""

    def __init__(self, directory: str, snapshot_every: int = 4096,
                 wal_fsync: str = "snapshot",
                 snapshot_async: bool = True, tracer=None, flight=None):
        if wal_fsync not in ("snapshot", "batch"):
            raise ValueError(
                f"wal_fsync must be 'snapshot' or 'batch': {wal_fsync!r}")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.snapshot_every = snapshot_every
        self.wal_fsync = wal_fsync
        self.snapshot_async = snapshot_async
        # observability: snapshot/WAL lifecycle goes to the
        # flight recorder; captures/writes become spans. The flight
        # ring is ALSO dumped whenever a snapshot lands, so the
        # forensics file next to snapshot.npz is never older than the
        # state it explains.
        self.tracer = tracer
        self.flight = flight
        self._wal: Optional[EventLog] = None
        self._seq = 0
        self._since_snapshot = 0
        self._lock = threading.Lock()
        self._inflight = False          # one async write at a time
        self._jobs: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self.last_snapshot_error: Optional[str] = None
        self.last_recovery: Optional[dict] = None
        self._write_test_hook = None    # tests: called before the write

    def _wal_path(self) -> str:
        return os.path.join(self.directory, WAL_FILE)

    def _open_wal(self) -> EventLog:
        return EventLog(self._wal_path(), fsync=self.wal_fsync == "batch")

    # ------------------------------------------------------------------ #
    def start_fresh(self) -> None:
        """A non-recovering start owns the directory: stale state from
        a previous run must not leak into a later --recover."""
        snap = os.path.join(self.directory, SNAPSHOT_FILE)
        if os.path.exists(snap):
            os.unlink(snap)
        for _, seg in EventLog.segments(self._wal_path()):
            os.unlink(seg)
        self._wal = self._open_wal()
        self._wal.truncate()

    # the engine-shape seam: a manager subclass (the
    # multi-tenant fleet's) swaps what a snapshot captures/restores and
    # how a WAL record is re-applied, while the WAL/segment/async-writer
    # protocol stays ONE implementation
    def _capture(self, engine) -> Tuple[dict, dict]:
        return capture_snapshot_state(engine)

    def _restore(self, engine) -> Optional[int]:
        return restore_snapshot(self.directory, engine)

    def _replay_entry(self, engine, rec: dict) -> None:
        scores = np.asarray(rec["s"], dtype=np.float64)
        labels = np.asarray(rec["l"], dtype=bool)
        if engine.index is not None:
            engine.index.insert_batch(scores, labels)
        engine.streaming.extend(scores, labels)

    def recover(self, engine) -> int:
        """Snapshot + tail replay (sealed segments, then the live
        log); returns the recovered event seq. ``last_recovery`` keeps
        the snapshot's seq, the records and events replayed, and the
        seconds of the restore and of the replay."""
        t0 = time.perf_counter()
        seq = snap_seq = self._restore(engine) or 0
        t1 = time.perf_counter()
        records = 0
        for rec in EventLog.replay_all_records(self._wal_path()):
            if int(rec["seq"]) < seq:
                continue    # already inside the snapshot
            self._replay_entry(engine, rec)
            seq = int(rec["seq"]) + len(rec["s"])
            records += 1
        self._seq = seq
        self._wal = self._open_wal()
        self.last_recovery = dict(
            snapshot_seq=snap_seq, seq=seq, records=records,
            events=seq - snap_seq, restore_s=t1 - t0,
            replay_s=time.perf_counter() - t1)
        return seq

    # ------------------------------------------------------------------ #
    def record(self, scores: np.ndarray, labels: np.ndarray,
               tenant: Optional[str] = None) -> None:
        self._wal.append(self._seq, scores, labels, tenant=tenant)
        self._seq += len(scores)
        self._since_snapshot += len(scores)

    def maybe_snapshot(self, engine) -> None:
        if self._since_snapshot < self.snapshot_every:
            return
        if not self.snapshot_async:
            self.snapshot(engine)
            return
        with self._lock:
            if self._inflight:
                # a slow write is still landing: keep serving (and keep
                # accruing _since_snapshot); the next insert after it
                # lands triggers the capture
                return
            self._inflight = True
        # the atomic handoff: capture host copies + seal the live WAL
        # on this (batcher) thread — cheap; the np.savez + fsync +
        # rename runs on the writer thread
        seq = self._seq
        with maybe_span(self.tracer, "snapshot.capture", seq=seq):
            extra, cfg = self._capture(engine)
            self._wal.seal(seq)
        if self.flight is not None:
            self.flight.record("wal_seal", seq=seq)
        self._since_snapshot = 0
        self._ensure_writer()
        self._jobs.put((seq, extra, cfg))

    def snapshot(self, engine) -> None:
        """Synchronous capture + write (close path, and the
        ``snapshot_async=False`` escape hatch)."""
        extra, cfg = self._capture(engine)
        write_snapshot(self.directory, seq=self._seq, extra=extra,
                       cfg=cfg)
        if self.flight is not None:
            self.flight.record("snapshot_landed", seq=self._seq,
                               mode="sync")
            self.flight.auto_dump()
        self._prune_segments(self._seq)
        # safe to prune only AFTER the snapshot atomically landed; a
        # crash in between leaves WAL entries below seq, which replay
        # skips
        self._wal.truncate()
        self._since_snapshot = 0

    # ------------------------------------------------------------------ #
    # side writer thread                             #
    # ------------------------------------------------------------------ #
    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._write_worker, name="tuplewise-snapshotter",
                daemon=True)
            self._writer.start()

    def _write_worker(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                seq, extra, cfg = job
                try:
                    if self._write_test_hook is not None:
                        self._write_test_hook(seq)
                    with maybe_span(self.tracer, "snapshot.write",
                                    seq=seq):
                        write_snapshot(self.directory, seq=seq,
                                       extra=extra, cfg=cfg)
                    if self.flight is not None:
                        self.flight.record("snapshot_landed", seq=seq,
                                           mode="async")
                        # forensics freshness: the dump next to
                        # snapshot.npz reflects at least this seal
                        self.flight.auto_dump()
                    self._prune_segments(seq)
                except BaseException as e:   # noqa: BLE001 — kept, not raised
                    # a failed write loses nothing: the sealed segments
                    # it would have pruned still replay over the OLD
                    # snapshot; record the error for stats()/operators
                    self.last_snapshot_error = repr(e)
                    if self.flight is not None:
                        self.flight.record("snapshot_error", seq=seq,
                                           error=repr(e))
            finally:
                with self._lock:
                    self._inflight = False
                self._jobs.task_done()

    def _prune_segments(self, landed_seq: int) -> None:
        """Delete sealed segments fully covered by the snapshot that
        just landed (name-seq <= landed seq: every entry is < it)."""
        for seq, seg in EventLog.segments(self._wal_path()):
            if seq <= landed_seq:
                try:
                    os.unlink(seg)
                except OSError:
                    pass    # already pruned (or raced a fresh start)

    def _drain_writer(self) -> None:
        """Block until every queued async write has landed (or
        failed) — ordering guard so a final synchronous snapshot can
        never be overwritten by an older async one."""
        if self._writer is not None:
            self._jobs.join()

    def checkpoint_and_close(self, engine) -> None:
        """Graceful shutdown: drain the async writer, take one final
        snapshot so restart is tail-free, then release the WAL."""
        if self._wal is None:
            return
        self._drain_writer()
        if self._since_snapshot:
            self.snapshot(engine)
        if self._writer is not None and self._writer.is_alive():
            self._jobs.put(None)
            self._writer.join(timeout=10.0)
        self._wal.close()
        self._wal = None

    @property
    def seq(self) -> int:
        return self._seq
