"""Reduction of a ``torch.profiler`` trace of the measured window.

``busy_us`` merges the device intervals into the time in which some
operation ran on the device: the interval merge of
``bench_torch_train.py`` (``busy_and_kernels``), copied here so that
the yardstick cannot move with the program. The kernel-name table
(``kernels/*.json``) maps device operations to the layers the per-layer
metrics read; a later file adds names, none is edited. A file with a
``workloads`` list applies to those cells alone and is searched before
the files without one, so it can put a kernel in another layer there.
"""

from __future__ import annotations

import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Tuple

HERE = pathlib.Path(__file__).resolve().parent
# the benchmark's own spans; the profiler also puts a copy of each on the
# device's timeline, which is no device work
SPAN_PREFIX = "bench."
WINDOW_SPAN = SPAN_PREFIX + "window"
CALL_SPAN = SPAN_PREFIX + "call"
TOP = 10

Interval = Tuple[str, float, float]          # (name, start us, end us)


def load_name_table(cell: str, folder: pathlib.Path = HERE / "kernels"
                    ) -> List[Tuple[str, re.Pattern]]:
    """The files of the folder that apply to ``cell``, merged:
    [(layer key, compiled pattern)], the files that name the cell
    first."""
    own, general = [], []
    for path in sorted(folder.glob("*.json")):
        spec = json.loads(path.read_text())
        if "workloads" in spec and cell not in spec["workloads"]:
            continue
        into = own if "workloads" in spec else general
        for key, pats in spec["layers"].items():
            into.extend((key, re.compile(p)) for p in pats)
    return own + general


def layer_of(name: str, table) -> Optional[str]:
    """The layer key of the first pattern that finds ``name``, or None."""
    for key, pat in table:
        if pat.search(name):
            return key
    return None


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    spans = sorted(intervals)
    if not spans:
        return 0.0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def idle_gaps(intervals: Iterable[Tuple[float, float]], start: float,
              end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end) that no interval covers."""
    gaps, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        gaps.append((at, end))
    return [(s, e) for s, e in gaps if e > s]


def clip(intervals: Iterable[Interval], start: float, end: float
         ) -> List[Interval]:
    return [(n, max(s, start), min(e, end)) for n, s, e in intervals
            if e > start and s < end]


def host_label(cpu: List[Interval], at: float) -> str:
    """The innermost host operation running at ``at`` (the one that began
    last among those that cover it): what the host was doing in the
    middle of an idle gap."""
    best = None
    for name, s, e in cpu:
        if s <= at < e and (best is None or s >= best[1]):
            best = (name, s)
    return "host idle" if best is None else best[0]


def _span_us(ev) -> Tuple[float, float]:
    # the profiler's raw events give nanoseconds in newer releases and
    # microseconds in older ones
    if hasattr(ev, "start_ns"):
        return ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3
    return float(ev.start_us()), float(ev.start_us() + ev.duration_us())


def split_events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, host operations and spans) of a finished
    ``torch.profiler.profile``, times in microseconds. It reads the
    profiler's raw events, not ``prof.events()``, which builds a tree of
    every host operation and takes minutes over a long window."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = ev.device_type()
        if kind == cuda:
            name = ev.name()
            if not name.startswith(SPAN_PREFIX):
                device.append((name, *_span_us(ev)))
        elif kind == cpu:
            host.append((ev.name(), *_span_us(ev)))
    return device, host


def reduce(device: List[Interval], host: List[Interval], table) -> dict:
    """Everything the readers take from a trace: the window (the
    ``bench.window`` span), the device busy time in it, device time by
    layer key and by name, and the longest idle gaps by what the host was
    doing."""
    spans = [(s, e) for n, s, e in host if n == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = spans[0]
    dev = clip(device, w0, w1)
    by_name: Dict[str, float] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    by_layer: Dict[str, float] = {}
    for name, us in by_name.items():
        key = layer_of(name, table)
        if key is not None:
            by_layer[key] = by_layer.get(key, 0.0) + us
    inner = [h for h in host if h[0] != WINDOW_SPAN]
    gaps = sorted(idle_gaps([(s, e) for _, s, e in dev], w0, w1),
                  key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_us": w1 - w0,
        "busy_us": busy_us((s, e) for _, s, e in dev),
        "layer_us": by_layer,
        "name_us": by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": [(host_label(inner, (s + e) / 2), e - s)
                      for s, e in gaps],
    }
