"""Low-overhead sampling profiler (a copy of ``tuplewise_tpu.obs.prof``).

The wave ledger (:mod:`tuplewise_tpu_torch.obs.ledger`) says WHICH bucket
the wall-clock went to; this profiler says WHERE IN THE CODE the
host-Python bucket burns — without instrumenting anything. A daemon
thread periodically snapshots every other thread's Python stack
(``sys._current_frames``), folds it (root→leaf, thread name as the
root frame), and counts occurrences.

Design stance, mirroring the Tracer:

* **hard-off by default** — nothing samples unless a caller
  constructs and starts a profiler (``replay(prof=True)``);
  instrumented code paths hold no reference at all.
* **guarded overhead (<= 5%)** — every sampling pass measures its own
  cost; when the smoothed cost exceeds ``max_overhead`` of the
  sampling interval the interval doubles (up to 1 s). The guard makes
  "leave it on in production" a bounded decision, not a hope:
  ``overhead_fraction()`` reports the realized cost share and
  ``throttles`` how often the guard fired.
* **exports, not dashboards** — ``export_collapsed`` writes classic
  folded stacks (``a;b;c 42`` — flamegraph.pl / speedscope paste),
  ``export_speedscope`` a schema-valid speedscope "sampled" profile.

Sampling is cooperative with the GIL: a sample sees each thread at a
bytecode boundary, which is exactly the resolution Python-level
host-tax questions need (a C-level torch call or kernel launch shows up
as the Python frame that called it).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

_MAX_DEPTH = 64


def _frame_name(code) -> str:
    """``pkg/mod.py:func`` with the path trimmed to its last three
    components — stable across checkouts, long enough to classify."""
    fn = code.co_filename.replace("\\", "/")
    tail = "/".join(fn.split("/")[-3:])
    return f"{tail}:{code.co_name}"


class SamplingProfiler:
    """Thread-based folded-stack sampler with a hard overhead guard.

    Args:
      hz: target sampling rate (the guard only ever LOWERS it).
      max_overhead: cap on (sampling cost / sampling interval); the
        interval doubles whenever the smoothed cost crosses it.
      metrics: optional ``MetricsRegistry`` — exports
        ``prof_samples_total`` / ``prof_throttles_total`` counters and
        a ``prof_overhead_fraction`` gauge so the profiler's own cost
        is itself observable.

    Use as a context manager, or ``start()`` / ``stop()``.
    """

    def __init__(self, hz: float = 97.0, max_overhead: float = 0.05,
                 metrics=None):
        if hz <= 0:
            raise ValueError(f"hz must be > 0: {hz}")
        if not 0.0 < max_overhead <= 1.0:
            raise ValueError(
                f"max_overhead must be in (0, 1]: {max_overhead}")
        self.hz = hz
        self.max_overhead = max_overhead
        self._interval = 1.0 / hz
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, ...], int] = {}
        self._weights: Dict[Tuple[str, ...], float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cost_ema = 0.0
        self._cost_total = 0.0
        self._t_started: Optional[float] = None
        self._wall_total = 0.0
        self.samples = 0
        self.throttles = 0
        self._c_samples = self._c_throttles = self._g_overhead = None
        if metrics is not None:
            self._c_samples = metrics.counter("prof_samples_total")
            self._c_throttles = metrics.counter("prof_throttles_total")
            self._g_overhead = metrics.gauge("prof_overhead_fraction")

    # ------------------------------------------------------------------ #
    def _thread_names(self) -> Dict[int, str]:
        return {t.ident: t.name for t in threading.enumerate()
                if t.ident is not None}

    def sample_once(self) -> int:
        """Take one sample of every other thread; returns the number
        of stacks recorded. Public so tests (and the overhead guard's
        own cost accounting) can drive it deterministically."""
        own = threading.get_ident()
        names = self._thread_names()
        with self._lock:
            dt = self._interval
        stacks: List[Tuple[str, ...]] = []
        for tid, frame in sys._current_frames().items():
            if tid == own:
                continue
            rev: List[str] = []
            f = frame
            while f is not None and len(rev) < _MAX_DEPTH:
                rev.append(_frame_name(f.f_code))
                f = f.f_back
            rev.append(f"thread:{names.get(tid, tid)}")
            stacks.append(tuple(reversed(rev)))
        with self._lock:
            for st in stacks:
                self._counts[st] = self._counts.get(st, 0) + 1
                self._weights[st] = self._weights.get(st, 0.0) + dt
            self.samples += 1
        if self._c_samples is not None:
            self._c_samples.inc()
        return len(stacks)

    def _note_cost(self, cost: float) -> None:
        """The overhead guard: smooth the per-sample cost and double
        the interval whenever it crosses the cap. Factored out so the
        throttle law is unit-testable without a live thread."""
        throttled = False
        with self._lock:
            self._cost_total += cost
            self._cost_ema = 0.8 * self._cost_ema + 0.2 * cost
            if self._cost_ema > self.max_overhead * self._interval:
                self._interval = min(self._interval * 2.0, 1.0)
                self.throttles += 1
                throttled = True
        if throttled and self._c_throttles is not None:
            self._c_throttles.inc()
        if self._g_overhead is not None:
            self._g_overhead.set(self.overhead_fraction())

    def _run(self) -> None:
        while True:
            with self._lock:
                interval = self._interval
            if self._stop.wait(interval):
                return
            t0 = time.perf_counter()
            self.sample_once()
            self._note_cost(time.perf_counter() - t0)

    def start(self) -> "SamplingProfiler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            with self._lock:
                self._t_started = time.perf_counter()
            self._thread = threading.Thread(
                target=self._run, name="tuplewise-prof", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        with self._lock:
            if self._t_started is not None:
                self._wall_total += time.perf_counter() - self._t_started
                self._t_started = None

    def __enter__(self) -> "SamplingProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ #
    def overhead_fraction(self) -> float:
        """Realized sampling cost as a fraction of profiled wall time
        (0.0 before any sample)."""
        with self._lock:
            wall = self._wall_total
            if self._t_started is not None:
                wall += time.perf_counter() - self._t_started
            return (self._cost_total / wall) if wall > 0 else 0.0

    def folded(self) -> Dict[Tuple[str, ...], int]:
        """{stack tuple (root→leaf): sample count}."""
        with self._lock:
            return dict(self._counts)

    def export_collapsed(self, path: str) -> int:
        """Classic collapsed-stack lines (``a;b;c count``); returns
        the number of distinct stacks written."""
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for stack, n in items:
                f.write(";".join(stack) + f" {n}\n")
        return len(items)

    def export_speedscope(self, path: str,
                          name: str = "tuplewise-prof") -> int:
        """speedscope "sampled" profile (https://speedscope.app);
        returns the number of samples written."""
        with self._lock:
            items = sorted(self._counts.items(),
                           key=lambda kv: (-kv[1], kv[0]))
            weights = dict(self._weights)
        frame_ix: Dict[str, int] = {}
        frames: List[dict] = []
        samples: List[List[int]] = []
        wlist: List[float] = []
        for stack, n in items:
            ixs = []
            for fr in stack:
                i = frame_ix.get(fr)
                if i is None:
                    i = frame_ix[fr] = len(frames)
                    frames.append({"name": fr})
                ixs.append(i)
            samples.append(ixs)
            wlist.append(weights.get(stack, 0.0))
        total = sum(wlist)
        doc = {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "name": name,
            "exporter": "tuplewise-prof",
            "shared": {"frames": frames},
            "profiles": [{
                "type": "sampled",
                "name": name,
                "unit": "seconds",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": wlist,
            }],
            "activeProfileIndex": 0,
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return len(samples)


def export_profile(prof: Optional[SamplingProfiler],
                   path: Optional[str]) -> Optional[str]:
    """Write ``path`` in the format its suffix names (``*.collapsed``
    / ``*.txt`` = folded stacks, anything else = speedscope JSON);
    no-op without a profiler or path. Returns the path written."""
    if prof is None or not path:
        return None
    if path.endswith((".collapsed", ".txt")):
        prof.export_collapsed(path)
    else:
        prof.export_speedscope(path)
    return path
