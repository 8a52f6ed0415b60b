"""Span tracing for the serving and batch paths.

A copy of ``tuplewise_tpu.obs.tracing``. Design constraints, in
priority order:

1. **Hard-off by default, near-zero cost.** Instrumented call sites
   hold ``tracer = None`` and pay one ``is not None`` check per hook; no
   span object is allocated when tracing is off. ``Tracer(enabled=
   False)`` keeps a tracer threadable while every call is a no-op.
2. **Monotonic clocks.** Span times are ``time.perf_counter()``. One
   (wall, monotonic) anchor pair taken at construction converts
   exported timestamps to an absolute timeline.
3. **Explicit parent/child ids.** Same-thread nesting is automatic (a
   thread-local span stack); cross-thread parenting (a batcher span
   continuing a request's trace) passes the parent ``Span`` explicitly.
4. **Thread-safe ring storage.** Finished spans land in a bounded ring
   (oldest dropped first), so memory stays flat.

Exports: ``export_jsonl(path)`` (one span per line: trace_id / span_id
/ parent_id / name / t0_s / dur_s / thread / attrs) and
``export_chrome(path)`` (Chrome trace-event JSON, loadable by perfetto
or ``chrome://tracing``). ``check_tracer`` is the constructors' guard:
None or a ``Tracer``, anything else raises ``TypeError``.

The hot paths (the Monte-Carlo runner, the mesh backend, the ring, the
trainer) take no tracer: their spans are ``utils.profiling.annotate``
ranges on the profiler's own clock, beside the kernels they launch, and
``COUNTS`` counts at the same boundaries.

Usage::

    tr = Tracer()
    with tr.span("request.insert", n=3) as sp:   # new trace (no parent)
        with tr.span("queue_wait"):               # child of sp
            ...
    with tr.span("batch.apply", parent=sp):       # another thread
        ...
    tr.record_span("swap", t0, t1, parent=sp)     # retro-timed span
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import Dict, List, Optional

# shared no-op context manager returned by maybe_span(None, ...): the
# disabled path allocates nothing
class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

#: process-wide counts at the hot paths' layer boundaries, always on (as
#: ``ops.pair_kernels.LAUNCHES`` counts the kernel launches): each read
#: of the estimate by the Monte-Carlo runner's host adds one under
#: ``host_read[mc.read]``. The one home of always-on boundary counts:
#: a new one is a key here, not another counter (the serving layer's
#: ``utils.profiling.MetricsRegistry`` is per engine, not process-wide)
COUNTS: collections.Counter = collections.Counter()


def check_tracer(tracer) -> None:
    """Raise ``TypeError`` unless ``tracer`` is None or a
    :class:`Tracer` (the constructors' guard, so a wrong object fails
    at construction and not at its first span)."""
    if tracer is not None and not isinstance(tracer, Tracer):
        raise TypeError(
            f"tracer must be None or an obs.tracing.Tracer, not "
            f"{type(tracer).__name__}")


def maybe_span(tracer: Optional["Tracer"], name: str, parent=None,
               **attrs):
    """``tracer.span(...)`` when a tracer is attached, else a shared
    no-op context manager — the one-line guard every instrumented call
    site uses so the disabled path costs a single ``is None`` check."""
    if tracer is None:
        return _NULL_SPAN
    return tracer.span(name, parent=parent, **attrs)


class Span:
    """One in-flight span; finished via the tracer (or as a context
    manager through ``Tracer.span``)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0",
                 "attrs", "thread")

    def __init__(self, trace_id: int, span_id: int,
                 parent_id: Optional[int], name: str, t0: float,
                 thread: str, attrs: Optional[dict]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.thread = thread
        self.attrs = attrs


class Tracer:
    """Thread-safe span recorder with bounded ring storage.

    Args:
      capacity: max retained finished spans (oldest evicted first).
      enabled: ``False`` turns every call into a cheap no-op while
        keeping the object threadable through constructors.
    """

    def __init__(self, capacity: int = 1 << 16, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        # (wall, monotonic) anchor: exported t0 is monotonic-relative;
        # the anchor converts to absolute wall time without ever using
        # wall clocks for durations
        self.wall_anchor = time.time()
        self.mono_anchor = time.perf_counter()
        self._ids = itertools.count(1)      # next() is atomic in CPython
        self._trace_ids = itertools.count(1)
        self._lock = threading.Lock()
        self._ring: List[dict] = []
        self._ring_pos = 0
        self.dropped = 0
        self._local = threading.local()

    # ------------------------------------------------------------------ #
    # context                                                            #
    # ------------------------------------------------------------------ #
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        """The active span on THIS thread (None outside any span)."""
        st = getattr(self._local, "stack", None)
        return st[-1] if st else None

    def current_trace_id(self) -> Optional[int]:
        sp = self.current()
        return sp.trace_id if sp is not None else None

    def new_trace_id(self) -> int:
        """A fresh trace id (for correlating events recorded outside
        any span, e.g. a chaos injection between batches)."""
        return next(self._trace_ids)

    # ------------------------------------------------------------------ #
    # span lifecycle                                                     #
    # ------------------------------------------------------------------ #
    def start(self, name: str, parent: Optional[Span] = None,
              trace_id: Optional[int] = None,
              **attrs) -> Optional[Span]:
        """Open a span. Parent resolution: explicit ``parent`` wins,
        else the calling thread's active span, else a NEW trace root.
        Does NOT touch the thread-local stack — cross-thread holders
        finish it with :meth:`finish`."""
        if not self.enabled:
            return None
        if parent is None:
            parent = self.current()
        if parent is not None:
            tid = parent.trace_id
            pid = parent.span_id
        else:
            tid = trace_id if trace_id is not None \
                else next(self._trace_ids)
            pid = None
        return Span(tid, next(self._ids), pid, name,
                    time.perf_counter(),
                    threading.current_thread().name, attrs or None)

    def finish(self, span: Optional[Span],
               t1: Optional[float] = None) -> None:
        if span is None or not self.enabled:
            return
        t1 = time.perf_counter() if t1 is None else t1
        self._store({
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "name": span.name,
            "t0_s": span.t0 - self.mono_anchor,
            "dur_s": max(0.0, t1 - span.t0),
            "thread": span.thread,
            "attrs": span.attrs,
        })

    def span(self, name: str, parent: Optional[Span] = None, **attrs):
        """Context-manager form: pushes the span on this thread's stack
        (so nested ``span()`` calls become children) and records it on
        exit. An exception inside marks ``attrs["error"]``."""
        return _SpanCtx(self, name, parent, attrs)

    def record_span(self, name: str, t0: float, t1: float,
                    parent: Optional[Span] = None,
                    trace_id: Optional[int] = None, **attrs) -> None:
        """Record a retroactively-timed span (both endpoints are
        already-taken ``perf_counter`` readings) — queue-wait intervals
        and O(1) swap pauses are measured before anyone knows whether
        they deserve a span object."""
        if not self.enabled:
            return
        if parent is not None:
            tid, pid = parent.trace_id, parent.span_id
        else:
            tid = trace_id if trace_id is not None \
                else next(self._trace_ids)
            pid = None
        self._store({
            "trace_id": tid,
            "span_id": next(self._ids),
            "parent_id": pid,
            "name": name,
            "t0_s": t0 - self.mono_anchor,
            "dur_s": max(0.0, t1 - t0),
            "thread": threading.current_thread().name,
            "attrs": attrs or None,
        })

    def _store(self, rec: dict) -> None:
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(rec)
            else:
                self._ring[self._ring_pos] = rec
                self._ring_pos = (self._ring_pos + 1) % self.capacity
                self.dropped += 1

    # ------------------------------------------------------------------ #
    # introspection / export                                             #
    # ------------------------------------------------------------------ #
    def spans(self) -> List[dict]:
        """Finished spans, oldest first (ring order restored)."""
        with self._lock:
            return (self._ring[self._ring_pos:]
                    + self._ring[: self._ring_pos])

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def export_jsonl(self, path: str) -> int:
        """One span per line; returns the number written."""
        spans = self.spans()
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({
                "meta": {
                    "format": "tuplewise-spans-v1",
                    "wall_anchor": self.wall_anchor,
                    "dropped": self.dropped,
                    "n_spans": len(spans),
                }}) + "\n")
            for s in spans:
                f.write(json.dumps(s) + "\n")
        return len(spans)

    def export_chrome(self, path: str) -> int:
        """Chrome trace-event JSON (perfetto / chrome://tracing).

        Each OS thread becomes a ``tid`` lane with a ``thread_name``
        metadata event; spans are ``ph: "X"`` complete events with
        microsecond timestamps relative to the tracer's anchor.
        """
        spans = self.spans()
        tids: Dict[str, int] = {}
        events: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
            "args": {"name": "tuplewise"},
        }]
        for s in spans:
            tid = tids.get(s["thread"])
            if tid is None:
                tid = tids[s["thread"]] = len(tids) + 1
                events.append({
                    "ph": "M", "name": "thread_name", "pid": 1,
                    "tid": tid, "args": {"name": s["thread"]},
                })
        for s in spans:
            args = dict(s["attrs"] or {})
            args["trace_id"] = s["trace_id"]
            args["span_id"] = s["span_id"]
            if s["parent_id"] is not None:
                args["parent_id"] = s["parent_id"]
            events.append({
                "ph": "X",
                "name": s["name"],
                "pid": 1,
                "tid": tids[s["thread"]],
                "ts": s["t0_s"] * 1e6,
                "dur": s["dur_s"] * 1e6,
                "args": args,
            })
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "format": "tuplewise-chrome-v1",
                "wall_anchor": self.wall_anchor,
                "dropped": self.dropped,
            },
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return len(spans)


class _SpanCtx:
    """The context-manager behind ``Tracer.span`` — pushes onto the
    thread-local stack so nesting parents automatically."""

    __slots__ = ("_tracer", "_name", "_parent", "_attrs", "_span")

    def __init__(self, tracer: Tracer, name: str,
                 parent: Optional[Span], attrs: dict):
        self._tracer = tracer
        self._name = name
        self._parent = parent
        self._attrs = attrs
        self._span = None

    def __enter__(self) -> Optional[Span]:
        if not self._tracer.enabled:
            return None
        self._span = self._tracer.start(
            self._name, parent=self._parent, **self._attrs)
        self._tracer._stack().append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._span is not None:
            if exc_type is not None:
                attrs = dict(self._span.attrs or {})
                attrs["error"] = exc_type.__name__
                self._span.attrs = attrs
            st = self._tracer._stack()
            if st and st[-1] is self._span:
                st.pop()
            self._tracer.finish(self._span)
        return False
