"""Declarative SLO evaluation over live metric snapshots (a copy of
``tuplewise_tpu.obs.slo``).

The serving process emits thousands of metric rows; this module says
"healthy" or "breached" of them: a spec of
**objectives** over the metrics the stack already exports (no new
instrumentation), evaluated against successive ``MetricsFlusher``
snapshots, with SRE-style multi-window burn-rate error budgets.

Spec format (dict, JSON string, or ``@path`` / ``*.json`` path —
exactly the ``--chaos-spec`` convention)::

    {"objectives": [
      {"name": "insert_p99", "type": "latency",
       "metric": "insert_latency_s", "quantile": "p99",
       "threshold_ms": 50},
      {"name": "availability", "type": "error_rate",
       "errors": ["poison_rejects", "deadline_expired_total",
                  "rejected_total", "dropped_total"],
       "total": "requests_insert_total", "objective": 0.999,
       "windows": [{"window_s": 5, "burn": 10},
                   {"window_s": 30, "burn": 2}]},
      {"name": "no_heal_exhaustion", "type": "counter_max",
       "metric": "heal_exhausted_total", "max": 0},
      {"name": "queue_saturation", "type": "saturation",
       "metric": "queue_depth_live", "capacity": "queue_size",
       "max_fraction": 0.9}
    ]}

Objective types:

* ``latency``     — a histogram quantile (over the retained sample
                    window) vs ``threshold_ms``. Instantaneous: the
                    current reading either clears the bar or not.
* ``error_rate``  — a ratio of counter DELTAS over sliding time
                    windows: ``sum(errors)`` / ``total``, each
                    differenced between the snapshot at the window's
                    start and now. The error budget is ``1 -
                    objective``; each window's **burn rate** is
                    ``error_rate / budget``; the objective breaches
                    only when EVERY window exceeds its ``burn``
                    threshold — the classic multi-window AND that makes
                    the short window catch fast burns without paging on
                    a single bad tick, and the long window catch slow
                    leaks (Google SRE workbook ch. 5).
* ``counter_max`` — a cumulative counter must stay <= ``max``
                    (default 0): heal exhaustion, watchdog restarts —
                    events whose acceptable count is a constant.
* ``saturation``  — a live gauge vs a fraction of capacity.
                    ``capacity`` is a number, or a context key
                    (e.g. ``"queue_size"``) resolved from the config
                    mapping the monitor was built with.

**Label wildcards**: a metric name may bind any
label value with ``*`` — ``insert_latency_s{tenant=*}`` evaluates the
objective against EVERY matching per-tenant series, so one spec line
covers a whole fleet. The objective breaches when any series does;
per-series breach gauges (``slo_breached{objective=...,tenant=...}``)
and a per-series breakdown in the report carry the attribution.
``error_rate`` objectives may use wildcard counter names too (matching
series are summed per window).

A breach TRANSITION (ok -> breached) records one ``slo_breach`` flight
event (trace-id correlated like every flight event) and increments
``slo_breaches_total{objective=...}``; the live state is exported as
``slo_breached{objective=...}`` / ``slo_burn_rate{objective=...}``
gauges — visible in the very metrics stream being judged, so the
flusher's JSONL doubles as the SLO timeline. ``report()`` renders the
final verdicts for exit summaries / replay records, and
``evaluate_history`` replays a metrics.jsonl post-hoc.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

_TYPES = ("latency", "error_rate", "counter_max", "saturation")

# default error-rate burn windows: tuned for service runs measured in
# seconds-to-minutes (a replay, a CI smoke, a short serve) — spec
# authors override for production horizons
_DEFAULT_WINDOWS = ({"window_s": 5.0, "burn": 10.0},
                    {"window_s": 30.0, "burn": 2.0})


class SloSpecError(ValueError):
    """The SLO spec failed validation (unknown type, missing field)."""


def _v(m: dict, name: str, default=0):
    return m.get(name, {}).get("value", default)


def _is_wild(name) -> bool:
    return isinstance(name, str) and "=*" in name


def match_series(m: dict, pattern: str) -> List[Tuple[dict, dict]]:
    """Expand a label-wildcard metric pattern against a snapshot
   : ``insert_latency_s{tenant=*}`` matches every
    ``insert_latency_s{tenant=...}`` series. Returns
    ``[(wild_labels, snapshot_entry)]`` — one per matching series,
    ``wild_labels`` holding the concrete values the ``*`` bound (the
    per-series identity the breach gauges are labeled with). Non-``*``
    labels in the pattern must match exactly."""
    from tuplewise_tpu_torch.utils.profiling import parse_labeled_name

    base, want = parse_labeled_name(pattern)
    out = []
    for key, snap in m.items():
        b, lab = parse_labeled_name(key)
        if b != base or lab is None:
            continue
        if any(lab.get(k) != v for k, v in want.items() if v != "*"):
            continue
        if any(k not in lab for k, v in want.items() if v == "*"):
            continue
        out.append(({k: lab[k] for k, v in want.items() if v == "*"},
                    snap))
    return out


def _sum_v(m: dict, name: str) -> float:
    """Counter value, summing matching series for wildcard names."""
    if _is_wild(name):
        return sum(s.get("value", 0) for _, s in match_series(m, name))
    return _v(m, name)


class _Objective:
    """One parsed objective + its rolling breach state."""

    __slots__ = ("name", "type", "metric", "quantile", "threshold_ms",
                 "errors", "total", "objective", "windows", "max",
                 "capacity", "max_fraction", "breached_now",
                 "breaches_total", "last", "worst")

    def __init__(self, ent: dict):
        self.type = ent.get("type")
        if self.type not in _TYPES:
            raise SloSpecError(
                f"unknown objective type {self.type!r}; expected one of "
                f"{_TYPES}")
        self.name = ent.get("name")
        if not self.name:
            raise SloSpecError(f"objective missing 'name': {ent}")
        self.metric = ent.get("metric")
        self.quantile = ent.get("quantile", "p99")
        self.threshold_ms = ent.get("threshold_ms")
        self.errors = tuple(ent.get("errors", ()))
        self.total = ent.get("total")
        self.objective = ent.get("objective")
        self.windows = tuple(dict(w) for w in ent.get(
            "windows", _DEFAULT_WINDOWS))
        self.max = ent.get("max", 0)
        self.capacity = ent.get("capacity")
        self.max_fraction = ent.get("max_fraction", 0.9)
        if self.type == "latency":
            if not self.metric or self.threshold_ms is None:
                raise SloSpecError(
                    f"latency objective {self.name!r} needs 'metric' "
                    f"and 'threshold_ms'")
            if self.quantile not in ("p50", "p90", "p95", "p99", "max",
                                     "mean"):
                raise SloSpecError(
                    f"latency objective {self.name!r}: unknown quantile "
                    f"{self.quantile!r}")
        elif self.type == "error_rate":
            if not self.errors or not self.total:
                raise SloSpecError(
                    f"error_rate objective {self.name!r} needs 'errors' "
                    f"and 'total'")
            if not (self.objective is not None
                    and 0.0 < float(self.objective) < 1.0):
                raise SloSpecError(
                    f"error_rate objective {self.name!r} needs "
                    f"'objective' in (0, 1), got {self.objective!r}")
            for w in self.windows:
                if w.get("window_s", 0) <= 0 or w.get("burn", 0) <= 0:
                    raise SloSpecError(
                        f"error_rate objective {self.name!r}: each "
                        f"window needs window_s > 0 and burn > 0: {w}")
        elif self.type == "counter_max":
            if not self.metric:
                raise SloSpecError(
                    f"counter_max objective {self.name!r} needs 'metric'")
        elif self.type == "saturation":
            if not self.metric or self.capacity is None:
                raise SloSpecError(
                    f"saturation objective {self.name!r} needs 'metric' "
                    f"and 'capacity'")
        # rolling state
        self.breached_now = False
        self.breaches_total = 0
        self.last: dict = {}
        self.worst: Optional[float] = None


class SloSpec:
    """Parsed, validated SLO spec — a list of objectives."""

    def __init__(self, objectives: List[_Objective]):
        if not objectives:
            raise SloSpecError("SLO spec has no objectives")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise SloSpecError(f"duplicate objective names: {names}")
        self.objectives = objectives

    @classmethod
    def from_spec(cls, spec) -> "SloSpec":
        """Build from a dict, a JSON string, or ``@path`` / ``.json``
        (the ``--chaos-spec`` convention)."""
        if isinstance(spec, SloSpec):
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
            raise SloSpecError(
                f"SLO spec must be a dict, got {type(spec)}")
        return cls([_Objective(e) for e in spec.get("objectives", ())])

    @property
    def longest_window_s(self) -> float:
        out = 0.0
        for o in self.objectives:
            if o.type == "error_rate":
                out = max(out, max(w["window_s"] for w in o.windows))
        return out

    @property
    def shortest_window_s(self) -> Optional[float]:
        out = None
        for o in self.objectives:
            if o.type == "error_rate":
                w = min(w["window_s"] for w in o.windows)
                out = w if out is None else min(out, w)
        return out


class SloMonitor:
    """Evaluates an :class:`SloSpec` against a stream of registry
    snapshots.

    Args:
      spec: anything ``SloSpec.from_spec`` accepts.
      registry: optional ``MetricsRegistry`` receiving the ``slo_*``
        gauges/counters (normally the very registry being judged).
      flight: optional ``FlightRecorder`` receiving one ``slo_breach``
        event per ok->breached transition.
      context: config mapping used to resolve symbolic capacities
        (e.g. ``{"queue_size": 1024}``).

    Wire ``observe_row`` as a ``MetricsFlusher`` observer for live
    evaluation, or call :func:`evaluate_history` on a finished
    metrics.jsonl.

    **Actuator hook**: the monitor *judges*; an actuator
    *acts*. ``add_actuator(fn)`` registers a callable invoked after
    every evaluation with one signal bundle — the snapshot, the new
    breach transitions, and every objective's current state (value,
    threshold, burn, ``breached_now``) — the sibling of the
    ``MetricsFlusher`` observer hook this monitor itself rides. The
    serving control plane (``serving.control.FleetController``)
    attaches here, so "close the loop" costs no second timer thread
    and the controller sees exactly the snapshots the SLO verdicts are
    judged on. Actuator exceptions are swallowed and counted
    (``actuator_errors`` / ``last_actuator_error``) — an actuator must
    never take down the evaluation that drives it.
    """

    def __init__(self, spec, registry=None, flight=None,
                 context: Optional[dict] = None, actuators=()):
        self.spec = SloSpec.from_spec(spec)
        self.registry = registry
        self.flight = flight
        self.context = dict(context or {})
        # snapshot ring: (ts_mono, metrics) kept long enough to cover
        # the longest burn window (+1 entry so a full window always has
        # a "before" edge)
        self._ring: List[Tuple[float, dict]] = []
        self.evaluations = 0
        self.actuators = list(actuators)
        self.actuator_errors = 0
        self.last_actuator_error: Optional[str] = None

    def add_actuator(self, fn) -> None:
        """Register an actuator callable; it receives one dict per
        evaluation: ``{"ts_mono", "metrics", "transitions",
        "objectives": {name: {..last detail.., "type", "breached_now",
        "breaches_total"}}}``."""
        self.actuators.append(fn)

    # ------------------------------------------------------------------ #
    def observe_row(self, row: dict) -> None:
        """MetricsFlusher observer entry point: one flushed row."""
        self.observe(row["metrics"], row["ts_mono"])

    def observe(self, metrics: dict, ts_mono: float) -> List[dict]:
        """Evaluate every objective against this snapshot; returns the
        list of NEW breach events (ok -> breached transitions)."""
        self._ring.append((ts_mono, metrics))
        horizon = self.spec.longest_window_s
        while len(self._ring) > 2 and \
                self._ring[1][0] <= ts_mono - horizon:
            self._ring.pop(0)
        self.evaluations += 1
        transitions = []
        for o in self.spec.objectives:
            breached, detail = self._evaluate(o, metrics, ts_mono)
            o.last = detail
            val = detail.get("value")
            if val is not None and (o.worst is None
                                    or val > o.worst):
                o.worst = val
            if breached and not o.breached_now:
                o.breaches_total += 1
                ev = dict(detail, objective=o.name, type=o.type)
                transitions.append(ev)
                if self.flight is not None:
                    self.flight.record("slo_breach", **ev)
            o.breached_now = breached
            self._export(o, detail)
        if self.actuators:
            sig = {
                "ts_mono": ts_mono,
                "metrics": metrics,
                "transitions": transitions,
                "objectives": {
                    o.name: dict(o.last, type=o.type,
                                 breached_now=o.breached_now,
                                 breaches_total=o.breaches_total)
                    for o in self.spec.objectives},
            }
            for fn in self.actuators:
                try:
                    fn(sig)
                except Exception as e:  # noqa: BLE001 — see class doc
                    self.actuator_errors += 1
                    self.last_actuator_error = repr(e)
        return transitions

    # ------------------------------------------------------------------ #
    def _evaluate(self, o: _Objective, m: dict,
                  ts: float) -> Tuple[bool, dict]:
        if o.type == "latency":
            if _is_wild(o.metric):
                return self._evaluate_wild(o, m)
            snap = m.get(o.metric, {})
            v = snap.get(o.quantile)
            v_ms = None if v is None else v * 1e3
            return (v_ms is not None and v_ms > o.threshold_ms), {
                "value": v_ms, "threshold_ms": o.threshold_ms,
                "quantile": o.quantile, "metric": o.metric}
        if o.type == "counter_max":
            if _is_wild(o.metric):
                return self._evaluate_wild(o, m)
            v = _v(m, o.metric)
            return v > o.max, {"value": v, "max": o.max,
                               "metric": o.metric}
        if o.type == "saturation":
            cap = o.capacity
            if isinstance(cap, str):
                cap = self.context.get(cap)
            if not cap:
                return False, {"value": None, "capacity": o.capacity,
                               "note": "capacity unresolved"}
            if _is_wild(o.metric):
                return self._evaluate_wild(o, m, capacity=float(cap))
            frac = _v(m, o.metric) / float(cap)
            return frac > o.max_fraction, {
                "value": frac, "max_fraction": o.max_fraction,
                "capacity": cap, "metric": o.metric}
        # error_rate: counter deltas over each sliding window
        # (wildcard error/total names sum their matching series, so one
        # spec line covers a whole labeled fleet)
        budget = 1.0 - float(o.objective)
        burns = {}
        all_exceed = True
        for w in o.windows:
            then = self._at(ts - w["window_s"])
            if then is None:
                # not enough history to fill this window yet: compare
                # against the oldest snapshot we have (a conservative
                # shorter window), never against nothing
                then = self._ring[0][1] if self._ring else m
            derr = sum(_sum_v(m, e) - _sum_v(then, e) for e in o.errors)
            dtot = _sum_v(m, o.total) - _sum_v(then, o.total)
            rate = (derr / dtot) if dtot > 0 else 0.0
            burn = rate / budget if budget > 0 else float("inf")
            burns[f"{w['window_s']:g}s"] = {
                "error_rate": rate, "burn_rate": burn,
                "burn_threshold": w["burn"], "errors": derr,
                "total": dtot}
            if burn <= w["burn"]:
                all_exceed = False
        worst = max((b["burn_rate"] for b in burns.values()),
                    default=0.0)
        return all_exceed, {"value": worst, "budget": budget,
                            "windows": burns}

    def _evaluate_wild(self, o: _Objective, m: dict,
                       capacity: Optional[float] = None
                       ) -> Tuple[bool, dict]:
        """Label-wildcard evaluation: one spec
        line fans out over every matching labeled series (e.g. every
        tenant). The objective breaches when ANY series breaches; the
        detail carries the per-series breakdown the per-series breach
        gauges and reports are built from."""
        series = {}
        worst = None
        any_breached = False
        for wild, snap in match_series(m, o.metric):
            if o.type == "latency":
                v = snap.get(o.quantile)
                val = None if v is None else v * 1e3
                breached = val is not None and val > o.threshold_ms
            elif o.type == "counter_max":
                val = snap.get("value", 0)
                breached = val > o.max
            else:   # saturation
                val = snap.get("value", 0) / capacity
                breached = val > o.max_fraction
            key = ",".join(f"{k}={wild[k]}" for k in sorted(wild))
            series[key] = {"value": val, "breached": breached,
                           "labels": wild}
            if val is not None and (worst is None or val > worst):
                worst = val
            any_breached = any_breached or breached
        detail = {"value": worst, "metric": o.metric,
                  "series": series,
                  "series_breached": sum(
                      1 for s in series.values() if s["breached"])}
        if o.type == "latency":
            detail["threshold_ms"] = o.threshold_ms
            detail["quantile"] = o.quantile
        elif o.type == "counter_max":
            detail["max"] = o.max
        else:
            detail["max_fraction"] = o.max_fraction
            detail["capacity"] = capacity
        return any_breached, detail

    def _at(self, ts: float) -> Optional[dict]:
        """The newest snapshot taken at or before ``ts`` (None when
        history does not reach back that far)."""
        best = None
        for t, m in self._ring:
            if t <= ts:
                best = m
            else:
                break
        return best

    def _export(self, o: _Objective, detail: dict) -> None:
        if self.registry is None:
            return
        labels = {"objective": o.name}
        self.registry.gauge("slo_breached", labels=labels).set(
            1.0 if o.breached_now else 0.0)
        if o.type == "error_rate":
            self.registry.gauge("slo_burn_rate", labels=labels).set(
                detail.get("value") or 0.0)
        # per-series breach gauges for wildcard objectives:
        # `slo_breached{objective=...,tenant=...}` — the fleet surface
        # a dashboard/doctor groups by tenant
        for s in detail.get("series", {}).values():
            self.registry.gauge(
                "slo_breached",
                labels=dict(labels, **s["labels"])).set(
                1.0 if s["breached"] else 0.0)
        c = self.registry.counter("slo_breaches_total", labels=labels)
        c.inc(o.breaches_total - c.value)

    # ------------------------------------------------------------------ #
    def report(self) -> dict:
        """Final verdicts: per-objective state + the overall bit an
        exit summary / CI gate reads first."""
        objectives = {}
        for o in self.spec.objectives:
            objectives[o.name] = {
                "type": o.type,
                "breached_now": o.breached_now,
                "breaches_total": o.breaches_total,
                "worst": o.worst,
                "last": o.last,
            }
        any_ever = any(o.breaches_total for o in self.spec.objectives)
        any_now = any(o.breached_now for o in self.spec.objectives)
        return {
            "evaluations": self.evaluations,
            "healthy": not any_ever,
            "breached_now": any_now,
            "breached_ever": any_ever,
            "objectives": objectives,
        }


def evaluate_history(spec, rows: List[dict], registry=None,
                     flight=None, context=None) -> dict:
    """Replay a metrics.jsonl history (list of flusher rows, in order)
    through a fresh monitor and return its report: the post-hoc
    evaluation of a finished run's artifacts."""
    mon = SloMonitor(spec, registry=registry, flight=flight,
                     context=context)
    for row in rows:
        if "metrics" in row and "ts_mono" in row:
            mon.observe_row(row)
    return mon.report()


# the spec applied when a doctor run is given no SLO spec: the invariants
# every serving config shares. Terminal failures must not happen, and the
# process must not be shedding load wholesale. Latency is
# config-dependent, so the default judges none.
DEFAULT_DOCTOR_SPEC = {"objectives": [
    {"name": "no_heal_exhaustion", "type": "counter_max",
     "metric": "heal_exhausted_total", "max": 0},
    {"name": "availability", "type": "error_rate",
     "errors": ["rejected_total", "dropped_total",
                "deadline_expired_total"],
     "total": "requests_insert_total", "objective": 0.99,
     "windows": [{"window_s": 1.0, "burn": 10.0},
                 {"window_s": 10.0, "burn": 5.0}]},
]}
