"""Tracing, profiling and service-metrics helpers.

The counterpart of ``tuplewise_tpu.utils.profiling``:

* ``timer()``        wall-clock context manager (``t["seconds"]``).
* ``trace(logdir)``  a ``torch.profiler`` scope over the CPU and, when a
                     card is present, CUDA activities; on exit it writes
                     a Chrome trace (``trace.json``) into ``logdir``. A
                     no-op when ``logdir`` is None, so callers can thread
                     an option straight through.
* ``annotate(name)`` a named range inside an active ``torch.profiler``
                     trace, the shared no-op of ``obs.tracing`` when no
                     profiler records: the one span call of the hot
                     paths (the Monte-Carlo runner, the mesh backend,
                     the ring, the trainer).
* ``Counter`` / ``Gauge`` / ``Histogram`` / ``MetricsRegistry``: the
                     serving layer's service metrics. Plain thread-safe
                     host objects: the batcher thread records while
                     request threads read snapshots, and ``snapshot()``
                     renders everything into one JSON-able dict. Metrics
                     take optional ``labels``: a small tag dict rendered
                     into the registry key (``name{k=v}``) and carried in
                     the snapshot.
* ``device_memory_stats()`` the cards' allocator statistics.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from tuplewise_tpu_torch.obs.tracing import _NULL_SPAN

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def timer() -> Iterator[dict]:
    """``with timer() as t: ...`` then ``t["seconds"]``."""
    out = {"seconds": None}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` scope; inert when ``logdir`` is None.

    Records the CPU ops and, with a card, the CUDA kernels launched
    inside the scope, and writes a Chrome trace to
    ``<logdir>/trace.json`` on exit."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(logdir), TRACE_FILE))


_profiler_enabled = torch.autograd._profiler_enabled

#: the range class of :func:`annotate`, resolved on the first range
#: recorded (a private name of torch: importing the port never needs it)
_range = None


def annotate(name: str):
    """A named range inside an active ``torch.profiler`` trace, else the
    shared no-op span: with no profiler recording, a call site pays one
    check of the profiler's state and allocates nothing.

    The range is torch's ``_RecordFunctionFast``, not
    ``torch.profiler.record_function``: a ``record_function`` range is a
    user annotation, which the profiler copies onto the device timeline,
    where a reader of the trace counts the copy as device work. This one
    is recorded as an operation of the host timeline: it leaves no copy,
    and the kernels launched inside it link to it by correlation id, as
    to any operation."""
    if not _profiler_enabled():
        return _NULL_SPAN
    global _range
    if _range is None:
        from torch._C._profiler import _RecordFunctionFast as _range
    return _range(name)


def labeled_name(name: str, labels: Optional[dict]) -> str:
    """Registry key of a (name, labels) pair: ``name{k=v,k2=v2}`` with
    sorted keys, one canonical key per label set."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_labeled_name(key: str):
    """Inverse of :func:`labeled_name`: ``name{k=v,k2=v2}`` back to
    ``(name, labels or None)``. Label values render as ``str(value)``,
    so keep them simple (ids, short tags): no ``{``, ``}``, ``,`` or
    ``=`` inside."""
    i = key.find("{")
    if i < 0 or not key.endswith("}"):
        return key, None
    name, inner = key[:i], key[i + 1:-1]
    labels = {}
    for part in inner.split(","):
        k, sep, v = part.partition("=")
        if not sep:
            raise ValueError(f"malformed label in metric key {key!r}")
        labels[k] = v
    return name, labels


class Counter:
    """Monotonic counter: ``c.inc()`` / ``c.inc(5)``; ``c.value``."""

    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, amount: int = 1) -> None:
        if amount < 0:
            raise ValueError(f"Counter {self.name}: negative inc {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        out = {"type": "counter", "value": self.value}
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


class Gauge:
    """Point-in-time value that goes down as well as up (queue depth,
    inflight requests, tombstone occupancy): ``g.set(v)`` /
    ``g.add(dv)``; ``g.value``."""

    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += float(delta)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        out = {"type": "gauge", "value": self.value}
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


# Default buckets span the serving latency range: 10 us .. ~100 s.
_DEFAULT_BUCKETS = tuple(
    b * s for s in (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)
    for b in (1.0, 2.5, 5.0)
)

# Byte-sized histograms: powers of 4 from 256 B to 16 GiB.
BYTE_BUCKETS = tuple(256 * 4 ** i for i in range(13))


class Histogram:
    """Fixed-bucket histogram with exact-sample percentile estimates.

    Bucket counts give the cumulative view (``snapshot()``);
    ``quantile(q)`` interpolates within the retained sample window (the
    last ``max_samples`` observations), so p50/p99 stay exact for short
    replay runs while memory stays bounded for long services.
    """

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 max_samples: int = 65536,
                 labels: Optional[dict] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self.buckets: List[float] = sorted(buckets or _DEFAULT_BUCKETS)
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self._max_samples = max_samples
        self._lock = threading.Lock()
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._samples: List[float] = []   # ring buffer of recent values
        self._ring_pos = 0

    def _push(self, value: float) -> None:
        # caller holds the lock
        if len(self._samples) < self._max_samples:
            self._samples.append(value)
        else:
            self._samples[self._ring_pos] = value
            self._ring_pos = (self._ring_pos + 1) % self._max_samples

    def _account(self, value: float, n: int) -> None:
        # caller holds the lock
        self._bucket_counts[bisect.bisect_left(self.buckets, value)] += n
        self._count += n
        self._sum += value * n
        self._min = value if self._min is None else min(self._min, value)
        self._max = value if self._max is None else max(self._max, value)

    def observe(self, value: float) -> None:
        self.observe_n(value, 1)

    def observe_n(self, value: float, n: int) -> None:
        """Record ``value`` with multiplicity ``n`` under one lock
        acquisition: quantiles and sums weigh it n times, exactly as n
        ``observe`` calls would."""
        if n < 1:
            if n == 0:
                return
            raise ValueError(f"Histogram {self.name}: negative n {n}")
        value = float(value)
        with self._lock:
            self._account(value, n)
            for _ in range(min(n, self._max_samples)):
                self._push(value)

    def observe_weighted(self, value: float, n: int) -> None:
        """Record ``value`` with multiplicity ``n`` in the count, sum and
        bucket views but once in the quantile window: a per-wave value
        billed to every request of the wave, whose quantiles read per
        wave."""
        if n < 1:
            if n == 0:
                return
            raise ValueError(f"Histogram {self.name}: negative n {n}")
        value = float(value)
        with self._lock:
            self._account(value, n)
            self._push(value)

    def observe_many(self, values: Sequence[float]) -> None:
        """Record each value once, under one lock acquisition."""
        if not values:
            return
        values = [float(v) for v in values]
        with self._lock:
            for v in values:
                self._account(v, 1)
                self._push(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def mean(self) -> Optional[float]:
        with self._lock:
            return self._sum / self._count if self._count else None

    def quantile(self, q: float) -> Optional[float]:
        """Linear-interpolated quantile over the retained sample window."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        with self._lock:
            xs = sorted(self._samples)
        if not xs:
            return None
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._bucket_counts)
            count, total = self._count, self._sum
            vmin, vmax = self._min, self._max
        out = {
            "type": "histogram",
            "count": count,
            "sum": total,
            "min": vmin,
            "max": vmax,
            "mean": total / count if count else None,
            **({"labels": dict(self.labels)} if self.labels else {}),
            "buckets": {
                ("+inf" if i == len(self.buckets) else repr(self.buckets[i])):
                    c
                for i, c in enumerate(counts) if c
            },
        }
        for q, label in ((0.5, "p50"), (0.9, "p90"), (0.95, "p95"),
                         (0.99, "p99")):
            out[label] = self.quantile(q)
        return out


class MetricsRegistry:
    """Named Counter/Gauge/Histogram factory plus a one-call JSON
    snapshot. ``counter(name)`` and friends create or return, so call
    sites never coordinate registration order; a name registered under
    another type raises. One registry per engine (no process globals)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get(name, Counter, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._get(name, Gauge, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  max_samples: int = 65536,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get(name, Histogram, help, labels,
                         buckets=buckets, max_samples=max_samples)

    def _get(self, name, cls, help, labels=None, **kwargs):
        key = labeled_name(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, labels=labels, **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {key!r} already registered as "
                    f"{type(m).__name__}")
            return m

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in items}


def device_memory_stats() -> dict:
    """{device_str: memory_stats dict} for each visible card that reports
    its allocator's statistics (``torch.cuda.memory_stats``); {} where no
    card does."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[str(torch.device("cuda", i))] = dict(stats)
    return out
