"""Deterministic chaos injection for the batch and serving paths (a copy
of ``tuplewise_tpu.testing.chaos``).

Repair code that only runs when hardware dies is code that never runs in
CI. This module makes failures a reproducible input: a seeded
``FaultInjector`` carries a schedule of faults keyed to named hook points
that the stack fires as it executes.

Batch-path points (fired by this package today):

    ``train_step``      — one chunk of steps in ``models/pairwise_sgd.py``
                          / ``triplet_sgd.py``;
    ``mc_chunk``        — one Monte-Carlo chunk in
                          ``harness/variance.run_variance_experiment``;
    ``mesh_mc``         — one block of reps of the mesh Monte-Carlo
                          runner (``harness/mesh_mc.py``);
    ``estimator``       — one Estimator scheme call
                          (``estimators/estimator.py``);
    ``checkpoint``      — fired right AFTER a checkpoint lands (the
                          ``sigkill`` action here is deterministic
                          preemption: die with durable state at a known
                          step);
    ``dist_init``       — multi-process bring-up
                          (``parallel/distributed.initialize``).

Serving points (the mesh forms of serving fire them; the single-device
engines take no injector yet): ``sharded_count``, ``compactor_build``,
``place_base``, ``major_merge``, ``batcher`` and ``poison`` (event
corruption applied to a stream by ``poison_batch``).

Each schedule entry names its point, the 1-based call number at which
it fires, and an action (``error`` raises, ``delay`` sleeps, ``sigkill``
SIGKILLs the whole process, the real preemption signal and not an
exception anything can catch). A mesh-facing fault may also declare the
worker ids a paired health probe should report dead (``dropped``), so
the self-healing path (``parallel.self_heal.MeshHealer``) can be driven
through a specific failure topology on a healthy mesh.

Everything is deterministic given the spec (``FaultInjector.random`` is
deterministic given its seed; its schedule is the JAX package's for the
same seed), so a chaos run is a regression test, not a flake. All hooks
are no-ops when no injector is attached: production pays one ``is
None`` check per hook point.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from tuplewise_tpu_torch.obs.tracing import check_tracer

_POINTS = ("sharded_count", "compactor_build", "batcher", "place_base",
           "major_merge", "train_step", "mc_chunk", "mesh_mc",
           "estimator", "checkpoint", "dist_init")
_ACTIONS = ("error", "delay", "sigkill")


class InjectedFault(RuntimeError):
    """A fault raised by a chaos schedule (never by real hardware)."""


class InjectedDeviceError(InjectedFault):
    """Simulated device/collective failure on the mesh path."""


def _parse_value(v) -> float:
    if isinstance(v, str):
        return float(v)            # handles "nan", "inf", "-inf"
    return float(v)


class _Fault:
    __slots__ = ("point", "on_call", "action", "seconds", "dropped",
                 "fired")

    def __init__(self, point: str, on_call: int = 1, action: str = "error",
                 seconds: float = 0.0, dropped=()):
        if point not in _POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; expected one of {_POINTS}")
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; expected {_ACTIONS}")
        if on_call < 1:
            raise ValueError(f"on_call is 1-based, got {on_call}")
        self.point = point
        self.on_call = int(on_call)
        self.action = action
        self.seconds = float(seconds)
        self.dropped = tuple(int(w) for w in dropped)
        self.fired = False


class FaultInjector:
    """Seeded, schedule-driven fault injection with named hook points.

    Spec format (dict, JSON string, or ``@path`` / ``*.json`` path)::

        {"faults": [
          {"point": "sharded_count", "on_call": 3, "action": "error",
           "dropped": [1]},
          {"point": "compactor_build", "on_call": 1, "action": "error"},
          {"point": "batcher", "on_call": 40, "action": "delay",
           "seconds": 0.01},
          {"point": "poison", "at_events": [100, 101], "value": "nan"}
        ]}

    ``fire(point)`` is what the stack calls at each hook point;
    ``poison_batch`` is applied by the stream replay to the event
    stream; ``take_dropped`` hands the most recent fault's declared
    dead-worker set to the self-healing path (in place of a real mesh
    probe). Thread-safe — hook points fire from request, batcher, and
    compactor threads concurrently.
    """

    def __init__(self, faults=(), poison_at=(), poison_value=float("nan")):
        self._lock = threading.Lock()
        self._faults: List[_Fault] = list(faults)
        self.poison_at = frozenset(int(i) for i in poison_at)
        self.poison_value = float(poison_value)
        self._calls: Dict[str, int] = {p: 0 for p in _POINTS}
        self._fired: Dict[str, int] = {}
        self._pending_dropped: Optional[Tuple[int, ...]] = None
        self.poisoned = 0
        # with a flight recorder attached, every fault that actually
        # FIRES logs a lifecycle event, so a post-mortem dump shows which
        # latency spike was chaos; an attached tracer correlates it with
        # the trace active at the injection site
        self._flight = None
        self._tracer = None

    def attach(self, flight=None, tracer=None) -> None:
        """Attach the flight recorder (``obs.flight.FlightRecorder``) and
        tracer (``obs.tracing.Tracer``) that should witness injections
        (idempotent: the most recent attachment wins)."""
        check_tracer(tracer)
        if flight is not None:
            self._flight = flight
        if tracer is not None:
            self._tracer = tracer

    # ------------------------------------------------------------------ #
    # construction                                                       #
    # ------------------------------------------------------------------ #
    @classmethod
    def from_spec(cls, spec) -> "FaultInjector":
        """Build from a dict, a JSON string, or ``@path`` / ``.json``."""
        if isinstance(spec, FaultInjector):
            return spec
        if isinstance(spec, str):
            s = spec.strip()
            if s.startswith("@"):
                with open(s[1:], "r", encoding="utf-8") as f:
                    spec = json.load(f)
            elif s.endswith(".json"):
                with open(s, "r", encoding="utf-8") as f:
                    spec = json.load(f)
            else:
                spec = json.loads(s)
        if not isinstance(spec, dict):
            raise ValueError(f"chaos spec must be a dict, got {type(spec)}")
        faults, poison_at = [], set()
        poison_value = float("nan")
        for ent in spec.get("faults", ()):
            if ent.get("point") == "poison":
                poison_at.update(int(i) for i in ent.get("at_events", ()))
                poison_value = _parse_value(ent.get("value", "nan"))
                continue
            faults.append(_Fault(
                ent["point"], on_call=ent.get("on_call", 1),
                action=ent.get("action", "error"),
                seconds=ent.get("seconds", 0.0),
                dropped=ent.get("dropped", ()),
            ))
        return cls(faults, poison_at=poison_at, poison_value=poison_value)

    @classmethod
    def random(cls, seed: int, n_events: int,
               n_poison: int = 3) -> "FaultInjector":
        """A randomized-but-reproducible schedule for soak tests: one
        compactor crash, one batcher crash, and a few poison events,
        all at seed-determined positions."""
        rng = np.random.default_rng(seed)
        faults = [
            _Fault("compactor_build", on_call=int(rng.integers(1, 4))),
            _Fault("batcher", on_call=int(rng.integers(2, 200))),
        ]
        k = min(n_poison, max(n_events - 1, 1))
        at = rng.choice(np.arange(1, n_events), size=k, replace=False)
        return cls(faults, poison_at=(int(i) for i in at))

    # ------------------------------------------------------------------ #
    # hook-point API                                                     #
    # ------------------------------------------------------------------ #
    def fire(self, point: str) -> None:
        """Advance ``point``'s call counter; execute any fault scheduled
        at this call number (raise / sleep). Called by the serving
        stack; a no-fault call is one dict increment."""
        with self._lock:
            self._calls[point] = n = self._calls.get(point, 0) + 1
            due = [f for f in self._faults
                   if f.point == point and not f.fired and f.on_call == n]
            for f in due:
                f.fired = True
                self._fired[point] = self._fired.get(point, 0) + 1
                if f.dropped:
                    self._pending_dropped = f.dropped
            delay = sum(f.seconds for f in due if f.action == "delay")
            errors = [f for f in due if f.action == "error"]
            kills = [f for f in due if f.action == "sigkill"]
        if due and self._flight is not None:
            # a fault fired outside any span gets a fresh trace id, so
            # the dump still has a correlation key
            tid = None
            if self._tracer is not None:
                tid = self._tracer.current_trace_id()
                if tid is None:
                    tid = self._tracer.new_trace_id()
            for f in due:
                self._flight.record(
                    "chaos_inject", trace_id=tid, point=point,
                    action=f.action, on_call=f.on_call,
                    dropped=list(f.dropped))
        if delay > 0:
            time.sleep(delay)
        if kills:
            # real preemption: the process dies HERE, uncatchably —
            # recovery is whatever the durable state (checkpoint/WAL)
            # plus a --resume restart can reconstruct
            os.kill(os.getpid(), signal.SIGKILL)
        if errors:
            exc = (InjectedDeviceError if point in
                   ("sharded_count", "place_base", "major_merge",
                    "mesh_mc", "train_step", "mc_chunk", "estimator")
                   else InjectedFault)
            raise exc(
                f"chaos: injected {point} fault (call #{errors[0].on_call})")

    def take_dropped(self) -> Optional[Tuple[int, ...]]:
        """The dead-worker set declared by the most recent fired fault,
        consumed once; None when the schedule declared none (the caller
        falls back to a real mesh probe)."""
        with self._lock:
            d, self._pending_dropped = self._pending_dropped, None
            return d

    def poison_batch(self, start: int,
                     scores: np.ndarray) -> Tuple[np.ndarray, int]:
        """Corrupt the scheduled events inside ``scores`` (stream
        positions ``start .. start+len``); returns (possibly-copied
        array, number poisoned)."""
        if not self.poison_at:
            return scores, 0
        hit = [i - start for i in self.poison_at
               if start <= i < start + len(scores)]
        if not hit:
            return scores, 0
        out = np.array(scores, copy=True)
        out[hit] = self.poison_value
        with self._lock:
            self.poisoned += len(hit)
        if self._flight is not None:
            self._flight.record(
                "chaos_poison", n_poisoned=len(hit),
                at_events=[start + i for i in hit])
        return out, len(hit)

    def snapshot(self) -> dict:
        """Fired/called counts per point — for exit summaries."""
        with self._lock:
            return {
                "calls": dict(self._calls),
                "fired": dict(self._fired),
                "poisoned": self.poisoned,
                "unfired": sum(1 for f in self._faults if not f.fired),
            }
