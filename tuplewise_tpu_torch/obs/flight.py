"""Flight recorder: a bounded ring of structured lifecycle events.

A copy of ``tuplewise_tpu.obs.flight``. Metrics say how many and how
slow; the flight recorder says what the process was doing: the last N
lifecycle events (compactions, batcher restarts, poison rejects,
deadline expiries, drift alerts), each stamped with a sequence number,
wall and monotonic timestamps and an optional trace id.

``dump()`` returns the events; ``dump_to(path)`` writes JSONL (a header
line, then one event per line); ``auto_dump()`` writes to the
configured ``dump_path`` and never raises. Recording is one lock and
one append: lifecycle events are rare, and the hot path never records.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional


class FlightRecorder:
    """Bounded, thread-safe ring of lifecycle events.

    Args:
      capacity: events retained (oldest evicted first).
      tracer: optional ``obs.tracing.Tracer``; when attached, each event
        records the trace id active on the recording thread (an explicit
        ``trace_id=`` wins).
      dump_path: where ``auto_dump()`` writes; None disables auto dumps
        (``dump_to`` still works).
    """

    def __init__(self, capacity: int = 4096, tracer=None,
                 dump_path: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self.tracer = tracer
        self.dump_path = dump_path
        self._lock = threading.Lock()
        self._ring: List[dict] = []
        self._ring_pos = 0
        self._seq = 0
        self.dropped = 0
        self.last_dump_error: Optional[str] = None

    def record(self, kind: str, trace_id: Optional[int] = None,
               **fields) -> int:
        """Record one event; returns its sequence number. ``fields``
        must be JSON-able."""
        if trace_id is None and self.tracer is not None:
            trace_id = self.tracer.current_trace_id()
        ev = {
            "kind": kind,
            "t_wall": time.time(),
            "t_mono": time.perf_counter(),
            "trace_id": trace_id,
        }
        if fields:
            ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) < self.capacity:
                self._ring.append(ev)
            else:
                self._ring[self._ring_pos] = ev
                self._ring_pos = (self._ring_pos + 1) % self.capacity
                self.dropped += 1
            return self._seq

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Retained events in sequence order (optionally one kind)."""
        with self._lock:
            evs = (self._ring[self._ring_pos:]
                   + self._ring[: self._ring_pos])
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def counts(self) -> dict:
        """{kind: count} over the retained window."""
        out: dict = {}
        for e in self.events():
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self) -> dict:
        """The full dump as one JSON-able dict."""
        evs = self.events()
        with self._lock:
            dropped = self.dropped
        return {
            "format": "tuplewise-flight-v1",
            "dumped_at_wall": time.time(),
            "dumped_at_mono": time.perf_counter(),
            "n_events": len(evs),
            "dropped": dropped,
            "events": evs,
        }

    def dump_to(self, path: str) -> int:
        """Write the dump as JSONL; returns the number of events written.
        Atomic via a temporary file and a rename."""
        d = self.dump()
        evs = d.pop("events")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(d) + "\n")
            for e in evs:
                f.write(json.dumps(e) + "\n")
        os.replace(tmp, path)
        return len(evs)

    def auto_dump(self) -> bool:
        """Dump to the configured path; returns True on success. Never
        raises: forensics must not take down what it observes (the error
        lands in ``last_dump_error``)."""
        if not self.dump_path:
            return False
        try:
            self.dump_to(self.dump_path)
            return True
        except OSError as e:
            self.last_dump_error = repr(e)
            return False

    @staticmethod
    def load_dump(path: str) -> dict:
        """Read a ``dump_to`` file back into the ``dump()`` shape."""
        with open(path, "r", encoding="utf-8") as f:
            header = json.loads(f.readline())
            events = []
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    break    # torn tail: keep what survived
        header["events"] = events
        return header
