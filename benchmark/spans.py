"""The program's spans in a ``torch.profiler`` trace of the measured
window: each device operation put down to the program spans that
launched it, and each idle stretch of the device to the program span
that was innermost on the host at its middle.

Program spans are the host ranges the port opens
(``utils.profiling.annotate``) whose names begin with one of
``PREFIXES``, frozen here so that the yardstick cannot move with the
program. A device operation links to the host operation that launched
it by correlation id (the event's ``linked_correlation_id``, as
``torch.autograd.profiler`` links them); the spans open on that host
operation's thread at its start launched it. A thread with no program
span open there takes the spans open on the window's thread: the
autograd engine's device threads run a backward for the thread that
waits in it. Everything is on the profiler's clock, microseconds.

``split_events`` reads a finished profiler's raw events; ``reduce``
takes plain tuples, so the CPU tests drive it with made-up traces.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from benchmark import trace

PREFIXES = ("mc.", "mesh.", "ring.", "train.")

Host = Tuple[str, int, float, float, int]   # name, thread, start, end, corr
Device = Tuple[str, float, float, int]      # name, start, end, linked corr

def is_program_span(name: str) -> bool:
    return name.startswith(PREFIXES)


def _annotation_copy(ev) -> bool:
    """A device event that is the device timeline's copy of a host user
    annotation (``record_function``), which is no device work: flagged
    as a user annotation, or, where the profiler has no such flag, a
    copy of the benchmark's own spans."""
    flag = getattr(ev, "is_user_annotation", None)
    if flag is not None:
        return bool(flag())
    return ev.name().startswith(trace.SPAN_PREFIX)


def split_events(prof) -> Tuple[List[Device], List[Host]]:
    """(device operations, host operations and spans) of a finished
    ``torch.profiler.profile``, read from its raw events. Host events
    that link to another (the CUDA runtime's calls) are left out: a
    device operation links to the operation that launched it."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = ev.device_type()
        if kind == cuda:
            if not _annotation_copy(ev):
                device.append((ev.name(), *trace._span_us(ev),
                               ev.linked_correlation_id()))
        elif kind == cpu and ev.linked_correlation_id() == 0:
            s, e = trace._span_us(ev)
            host.append((ev.name(), ev.start_thread_id(), s, e,
                         ev.correlation_id()))
    return device, host


class _Timeline:
    """The program spans of one thread, nested: the names open at any
    time (outermost first) and each span's self time (its duration less
    its child spans')."""

    def __init__(self, spans: List[Tuple[str, float, float]]):
        self.spans = sorted(spans, key=lambda x: (x[1], -x[2]))
        self.times: List[float] = []
        self.stacks: List[Tuple[str, ...]] = []
        child = [0.0] * len(self.spans)
        open_: List[Tuple[float, str, int]] = []

        def mark(t):
            stack = tuple(name for _, name, _ in open_)
            if self.times and self.times[-1] == t:
                self.stacks[-1] = stack
            else:
                self.times.append(t)
                self.stacks.append(stack)

        for i, (name, s, e) in enumerate(self.spans):
            while open_ and open_[-1][0] <= s:
                mark(open_.pop()[0])
            if open_:
                child[open_[-1][2]] += e - s
            open_.append((e, name, i))
            mark(s)
        while open_:
            mark(open_.pop()[0])
        self.self_us = [e - s - c for (_, s, e), c in zip(self.spans, child)]

    def open_at(self, t: float) -> Tuple[str, ...]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.stacks[i] if i >= 0 else ()


def reduce(device: List[Device], host: List[Host]) -> dict:
    """The window's reading (the ``bench.window`` span's):

    * ``spans``: {name: {count, host_us, self_us, device_us}} of the
      program spans that began in the window; ``device_us`` sums the
      device operations launched inside the span, its child spans'
      included;
    * ``idle_us``: {name: us}, the device's idle stretches in the window
      by the innermost program span open on the window's thread at
      their middle; ``unspanned_idle_us`` those with none open;
    * ``device_us``: the device operations' time in the window, and
      ``unspanned_device_us`` the part that no program span launched
      (unlinked operations too)."""
    windows = [h for h in host if h[0] == trace.WINDOW_SPAN]
    if not windows:
        raise RuntimeError(f"the trace holds no {trace.WINDOW_SPAN!r} span")
    _, w_thread, w0, w1, _ = windows[0]

    by_thread: Dict[int, List[Tuple[str, float, float]]] = {}
    launcher: Dict[int, Tuple[int, float]] = {}
    for name, thread, s, e, corr in host:
        if is_program_span(name):
            by_thread.setdefault(thread, []).append((name, s, e))
        if corr:
            launcher[corr] = (thread, s)
    lines = {t: _Timeline(sp) for t, sp in by_thread.items()}
    main = lines.get(w_thread)

    def open_at(thread: Optional[int], t: float) -> Tuple[str, ...]:
        line = lines.get(thread)
        stack = line.open_at(t) if line is not None else ()
        if not stack and thread != w_thread and main is not None:
            stack = main.open_at(t)
        return stack

    spans: Dict[str, Dict[str, float]] = {}

    def entry(name):
        return spans.setdefault(name, {"count": 0, "host_us": 0.0,
                                       "self_us": 0.0, "device_us": 0.0})

    for line in lines.values():
        for (name, s, e), self_us in zip(line.spans, line.self_us):
            if w0 <= s < w1:
                row = entry(name)
                row["count"] += 1
                row["host_us"] += e - s
                row["self_us"] += self_us

    dev = []
    unspanned = 0.0
    for _, s, e, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        dev.append((s, e))
        thread, at = launcher.get(corr, (None, None))
        stack = open_at(thread, at) if at is not None else ()
        if not stack:
            unspanned += e - s
        for name in set(stack):
            entry(name)["device_us"] += e - s

    idle: Dict[str, float] = {}
    unspanned_idle = 0.0
    for s, e in trace.idle_gaps(dev, w0, w1):
        stack = main.open_at((s + e) / 2) if main is not None else ()
        if stack:
            idle[stack[-1]] = idle.get(stack[-1], 0.0) + (e - s)
        else:
            unspanned_idle += e - s
    return {"spans": spans, "idle_us": idle,
            "unspanned_idle_us": unspanned_idle,
            "device_us": sum(e - s for s, e in dev),
            "unspanned_device_us": unspanned}
