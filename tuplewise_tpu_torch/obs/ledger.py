"""Host-tax wave ledger: where every microsecond of an insert goes.

The counterpart of ``tuplewise_tpu.obs.ledger``, with the same bucket
names so that reports of the two packages line up. Each insert
micro-batch ("wave") splits its wall time into buckets that do not
overlap and cover it exactly:

* ``queue_wait``     — enqueue to batcher pickup (per request);
* ``lock_wait``      — waiting on the engine's estimator lock;
* ``host_python``    — everything on the batcher thread that is neither
                       a device section nor a GC pause (the remainder);
* ``dispatch``       — from entering a device section to the return of
                       the kernel launch (the query copy to the card,
                       the allocation, the launch call);
* ``device_compute`` — from the launch's return to the return of the
                       device-to-host copy of the counts, which waits
                       for the kernel;
* ``xla_compile``    — a device section whose key this process never
                       saw before: on the card, the first build or load
                       of a kernel library (the name is kept so that
                       reports match the JAX package's);
* ``gc_pause``       — cyclic-GC pauses on the wave's thread.

Per request the bucket sums equal the measured insert latency, because
``host_python`` is the remainder. The engine opens a wave on its batcher
thread; the count dispatch wraps its device work in
:func:`device_section`, a thread-local lookup that records nothing
outside a wave.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List, Optional

from tuplewise_tpu_torch.obs.report import HOST_TAX_BUCKETS as BUCKETS

# thread-local active wave: device_section and the gc hook look it up
_ACTIVE = threading.local()

# process-wide first-seen device-section keys: the built libraries are
# process-wide, so "first call with this key" is too
_SEEN_LOCK = threading.Lock()
_SEEN: set = set()

_GC_LOCK = threading.Lock()
_GC_INSTALLED = False


def reset_seen() -> None:
    """Forget every seen key (tests: deterministic first-use billing)."""
    with _SEEN_LOCK:
        _SEEN.clear()


def _note_key(key) -> bool:
    """True exactly once per key process-wide (a first-use event)."""
    with _SEEN_LOCK:
        if key in _SEEN:
            return False
        _SEEN.add(key)
        return True


def _gc_hook(phase, info) -> None:
    """gc.callbacks hook: bill collection pauses to the active wave of
    the thread the collection ran on."""
    wave = getattr(_ACTIVE, "wave", None)
    if wave is None:
        return
    if phase == "start":
        wave._gc_t0 = time.perf_counter()
    elif wave._gc_t0 is not None:
        wave.gc_pauses.append(time.perf_counter() - wave._gc_t0)
        wave._gc_t0 = None


def _ensure_gc_hook() -> None:
    global _GC_INSTALLED
    with _GC_LOCK:
        if not _GC_INSTALLED:
            gc.callbacks.append(_gc_hook)
            _GC_INSTALLED = True


class _Wave:
    """Accumulator of one insert micro-batch, confined to the batcher
    thread that opened it."""

    __slots__ = ("dispatch_s", "compute_s", "compile_s",
                 "compile_events", "gc_pauses", "_gc_t0")

    def __init__(self):
        self.dispatch_s = 0.0
        self.compute_s = 0.0
        self.compile_s = 0.0
        self.compile_events = 0
        self.gc_pauses: List[float] = []
        self._gc_t0: Optional[float] = None


class _DeviceSection:
    """Context manager around one device dispatch::

        with device_section(("signed_pair", caps, True)) as ds:
            out = launch(...)       # returns once the kernel is queued
            ds.dispatched()
            host = out.cpu()        # waits for the kernel, copies back

    [enter, dispatched] bills ``dispatch`` (or ``xla_compile`` for a
    first-seen key); [dispatched, exit] bills ``device_compute``. No
    active wave on this thread: a no-op.
    """

    __slots__ = ("_key", "_wave", "_t0", "_t_disp")

    def __init__(self, key):
        self._key = key
        self._wave = None
        self._t0 = 0.0
        self._t_disp = None

    def __enter__(self) -> "_DeviceSection":
        self._wave = getattr(_ACTIVE, "wave", None)
        if self._wave is not None:
            self._t_disp = None
            self._t0 = time.perf_counter()
        return self

    def dispatched(self) -> None:
        if self._wave is not None:
            self._t_disp = time.perf_counter()

    def __exit__(self, exc_type, exc, tb) -> bool:
        w = self._wave
        if w is not None:
            t1 = time.perf_counter()
            td = self._t_disp if self._t_disp is not None else t1
            if _note_key(self._key):
                w.compile_s += td - self._t0
                w.compile_events += 1
            else:
                w.dispatch_s += td - self._t0
            w.compute_s += max(0.0, t1 - td)
            self._wave = None
        return False


def device_section(key) -> _DeviceSection:
    """The hook every dispatch boundary uses. ``key`` is hashable and
    names what a first call builds or loads."""
    return _DeviceSection(key)


class WaveLedger:
    """Per-engine host-tax accounting over insert waves. Always on: a
    wave costs a handful of ``perf_counter`` readings."""

    def __init__(self, metrics):
        self._h = {b: metrics.histogram(f"host_tax_{b}_s")
                   for b in BUCKETS}
        self._g_host = metrics.gauge("host_tax_host_fraction")
        self._g_dev = metrics.gauge("host_tax_device_fraction")
        self._c_compile = metrics.counter("xla_compile_events_total")
        self._c_gc = metrics.counter("gc_pauses_total")
        self._h_gc = metrics.histogram("gc_pause_s")
        self._c_waves = metrics.counter("host_tax_waves_total")
        # cumulative seconds behind the fraction gauges; written only on
        # the batcher thread
        self._host_s = 0.0
        self._device_s = 0.0
        self._total_s = 0.0
        _ensure_gc_hook()

    def begin_wave(self) -> _Wave:
        """Open a wave on this thread; pair with :meth:`finish_wave` (or
        :meth:`abort_wave` on the failure path)."""
        w = _Wave()
        _ACTIVE.wave = w
        return w

    def abort_wave(self, wave: _Wave) -> None:
        """Clear the thread-local binding without recording."""
        if getattr(_ACTIVE, "wave", None) is wave:
            _ACTIVE.wave = None

    def finish_wave(self, wave: _Wave, *, t_start: float,
                    t_end: float, queue_waits,
                    t_lock_req: Optional[float] = None,
                    t_lock: Optional[float] = None) -> Dict[str, float]:
        """Close the wave and bill its buckets. ``queue_waits``: one
        enqueue-to-pickup interval per request of the wave. Returns the
        wave's bucket values (without the per-request queue wait)."""
        if getattr(_ACTIVE, "wave", None) is wave:
            _ACTIVE.wave = None
        total = max(0.0, t_end - t_start)
        lock_wait = 0.0
        if t_lock_req is not None and t_lock is not None:
            lock_wait = max(0.0, t_lock - t_lock_req)
        gc_s = sum(wave.gc_pauses)
        direct = (lock_wait + wave.dispatch_s + wave.compute_s
                  + wave.compile_s + gc_s)
        host_py = total - direct
        if host_py < 0.0:
            # a GC pause can overlap a device section: shave the overlap
            # off the gc bucket first, then off dispatch, so the buckets
            # still sum to the measured time
            deficit = -host_py
            shaved = min(gc_s, deficit)
            gc_s -= shaved
            deficit -= shaved
            wave.dispatch_s = max(0.0, wave.dispatch_s - deficit)
            host_py = 0.0
        n = len(queue_waits)
        h = self._h
        qw_sum = sum(queue_waits)
        h["queue_wait"].observe_many(queue_waits)
        if n:
            # wave-shared buckets bill weighted: exact sums, one quantile
            # sample per wave
            h["lock_wait"].observe_weighted(lock_wait, n)
            h["host_python"].observe_weighted(host_py, n)
            h["dispatch"].observe_weighted(wave.dispatch_s, n)
            h["device_compute"].observe_weighted(wave.compute_s, n)
            h["xla_compile"].observe_weighted(wave.compile_s, n)
            h["gc_pause"].observe_weighted(gc_s, n)
        if wave.compile_events:
            self._c_compile.inc(wave.compile_events)
        if wave.gc_pauses:
            self._c_gc.inc(len(wave.gc_pauses))
            for p in wave.gc_pauses:
                self._h_gc.observe(p)
        self._c_waves.inc()
        # host = everything that is neither device compute nor first use
        self._host_s += qw_sum + n * (lock_wait + host_py
                                      + wave.dispatch_s + gc_s)
        self._device_s += n * wave.compute_s
        self._total_s += qw_sum + n * total
        if self._total_s > 0:
            self._g_host.set(self._host_s / self._total_s)
            self._g_dev.set(self._device_s / self._total_s)
        return {
            "lock_wait": lock_wait,
            "host_python": host_py,
            "dispatch": wave.dispatch_s,
            "device_compute": wave.compute_s,
            "xla_compile": wave.compile_s,
            "gc_pause": gc_s,
        }
