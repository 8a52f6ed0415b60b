"""Live metrics export: periodic whole-registry snapshots to JSONL.

A copy of ``tuplewise_tpu.obs.metrics_export``. The
:class:`MetricsFlusher` is a side thread that appends one registry
snapshot per cadence tick to a JSONL path, each stamped with wall and
monotonic timestamps (wall for joins, monotonic for rates), the torch
platform (``"cuda"`` or ``"cpu"``) and a config digest, so rows of
different configs are never averaged together.

Appends are flushed but not fsync'd: metrics are a lossy observability
stream, not durable state (the WAL keeps its own fsync policy).
``flush()`` also runs once at ``start()`` and once at ``stop()``, so even
a short run leaves two snapshots to difference.

* **rotation**: ``max_bytes`` rolls ``metrics.jsonl`` to
  ``metrics.jsonl.1`` (one generation, replaced on the next roll) when
  an append passes the bound.
* **observers**: callables invoked with each flushed row; the SLO
  monitor rides here and judges exactly the snapshots the file records.
  ``path`` may be None for an observer-only flusher.

Errors of a flush or an observer are kept (``last_error``, counters),
never raised: observation must not take down what it observes.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Optional


# Config fields added AFTER the digest began stamping perf-history
# rows, mapped to their defaults. A field at its default is dropped
# from the digest blob, so rows recorded before the field existed keep
# joining runs that don't use it — an additive config evolution must
# not orphan the perf gate's committed history.
# A NON-default value still lands in the blob (different config =>
# different digest, as it should).
_ADDITIVE_DEFAULTS = {"count_kernel": False,
                      "tail_exemplar_ms": None}


def config_digest(config) -> str:
    """Short stable digest of a config mapping/dataclass — the join key
    that keeps metrics rows from different configs apart."""
    import dataclasses

    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        config = dataclasses.asdict(config)
    if isinstance(config, dict):
        config = {k: v for k, v in config.items()
                  if not (k in _ADDITIVE_DEFAULTS
                          and v == _ADDITIVE_DEFAULTS[k])}
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def _platform() -> str:
    """The torch platform rows are stamped with: "cuda" when a card is
    present, else "cpu"."""
    try:
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:   # noqa: BLE001 — metrics must not require torch
        return "unknown"


class MetricsFlusher:
    """Side-thread JSONL appender for a ``MetricsRegistry``.

    Args:
      registry: the ``utils.profiling.MetricsRegistry`` to snapshot.
      path: JSONL output (parent dirs created; appended, not truncated
        — restarts of the same service extend one history file). None
        = observer-only: snapshots are built and handed to observers,
        nothing is written.
      every_s: cadence between snapshots.
      meta: extra fields stamped on every row (e.g. ``stage``); the
        platform and ``config_digest`` ride along automatically when
        ``config`` is given.
      config: config object/dict digested into ``config_digest``.
      max_bytes: roll ``path`` to ``path + ".1"`` when an append
        pushes past this size (None = never roll).
      observers: callables receiving each flushed row dict (on the
        flusher thread; exceptions are swallowed into
        ``last_flush_error`` — observation must not kill the flusher).

    Use as a context manager, or ``start()`` / ``stop()``.
    """

    def __init__(self, registry, path: Optional[str],
                 every_s: float = 1.0,
                 meta: Optional[dict] = None, config=None,
                 max_bytes: Optional[int] = None, observers=()):
        if every_s <= 0:
            raise ValueError(f"every_s must be > 0: {every_s}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1: {max_bytes}")
        self.registry = registry
        self.path = path
        self.every_s = every_s
        self.max_bytes = max_bytes
        self.observers = list(observers)
        self.rotations = 0
        self.meta = dict(meta or {})
        self.meta.setdefault("platform", _platform())
        if config is not None:
            self.meta.setdefault("config_digest", config_digest(config))
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()    # serializes appends
        self._f = None
        self.last_flush_error: Optional[str] = None
        # wedged-observer escape hatch: when stop()
        # gives up waiting on a flush stuck inside a slow observer,
        # the in-flight flush becomes the final row and closes the
        # file itself; the counter makes the event observable
        self._late = threading.Event()
        self._c_late = registry.counter("flusher_late_flushes_total")

    # ------------------------------------------------------------------ #
    def flush(self) -> int:
        """Append one snapshot row now; returns its seq number. Never
        raises (the error lands in ``last_flush_error``) — a full disk
        must not take the service down."""
        with self._lock:
            self._seq += 1
            row = {
                "seq": self._seq,
                "ts_wall": time.time(),
                "ts_mono": time.perf_counter(),
            }
            row.update(self.meta)
            row["metrics"] = self.registry.snapshot()
            try:
                if self.path is not None:
                    if self._f is None:
                        d = os.path.dirname(self.path)
                        if d:
                            os.makedirs(d, exist_ok=True)
                        self._f = open(self.path, "a", encoding="utf-8")
                    self._f.write(json.dumps(row) + "\n")
                    self._f.flush()
                    if (self.max_bytes is not None
                            and self._f.tell() >= self.max_bytes):
                        # roll AFTER a complete row: both generations
                        # always hold whole lines
                        self._f.close()
                        self._f = None
                        os.replace(self.path, self.path + ".1")
                        self.rotations += 1
            except Exception as e:   # noqa: BLE001 — lossy by design
                self.last_flush_error = repr(e)
            for obs in self.observers:
                try:
                    obs(row)
                except Exception as e:   # noqa: BLE001 — see docstring
                    self.last_flush_error = repr(e)
            if self._late.is_set() and self._f is not None:
                # stop() already returned without the final close
                # (this very flush was wedged in an observer): the
                # row above is the final row; release the file here
                self._f.close()
                self._f = None
            return self._seq

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            self.flush()

    def start(self) -> "MetricsFlusher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self.flush()     # row 1: the starting state
            self._thread = threading.Thread(
                target=self._run, name="tuplewise-metrics-flusher",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the flusher thread and write the final row.

        The final flush used to race a wedged
        observer: observers run under the flush lock, so a stop()
        while an observer hangs would block on that lock FOREVER
        (shutdown wedged behind the very observer the flusher exists
        to tolerate). Now the join is bounded: if the thread is still
        mid-flush after ``timeout``, stop() counts a
        ``flusher_late_flushes_total``, marks the in-flight flush as
        the final one (it closes the file when it completes), and
        returns — shutdown never inherits an observer's hang."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                self._c_late.inc()
                self.last_flush_error = (
                    "stop(): flusher thread still mid-flush after "
                    f"{timeout}s (wedged observer?) — final flush "
                    "left to the in-flight one")
                self._late.set()
                return
            self._thread = None
        self.flush()         # final row: the exit state
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "MetricsFlusher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
