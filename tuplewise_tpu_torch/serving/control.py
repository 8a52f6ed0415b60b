"""SLO-driven control plane: the fleet defends its own SLOs.

The counterpart of ``tuplewise_tpu.serving.control``. A
:class:`FleetController` rides the SLO engine's burn-rate and saturation
signals (the actuator hook of ``obs.slo.SloMonitor``) and actuates
through machinery the serving stack already has:

====================  =================================================
knob                  actuation (existing machinery)
====================  =================================================
``shed``              throttle the tenants flooding the queue with a
                      typed ``serving.tenancy.TenantThrottledError``
                      (and a ``retry_after_s`` hint) before the breach:
                      ``MultiTenantEngine.throttle_tenant``;
                      auto-expiring, so release is structural
``flush``             widen the batcher flush window and micro-batch cap
                      under backlog pressure (power-of-two steps), narrow
                      them under latency-only pressure: a replaced
                      ``engine.config``, read by the batcher each round
``weights``           boost the DRR quantum of tenants whose observed
                      ``insert_latency_s{tenant=}`` p99 runs far above
                      the fleet median (they are being starved):
                      ``MultiTenantEngine.set_tenant_weight``
``mesh``              grow the mesh under sustained pressure, shrink
                      back on long calm: ``MeshHealer.resize`` and pack
                      re-placement (``TenantFleetIndex.resize_shards``);
                      counts are width-invariant, so results stay
                      bit-identical through every resize
``promote``           promote whales from traffic *slope* (projected to
                      cross ``whale_threshold`` within the lookahead)
                      instead of waiting for size:
                      ``TenantFleetIndex.promote``
====================  =================================================

Every actuation is:

* **hysteretic**: pressure must hold ``up_ticks`` consecutive evaluations
  before a step, calm must hold ``down_ticks`` before a revert;
* **rate-limited**: at most one step per knob per ``cooldown_s``;
* **budgeted**: at most ``*_budget`` pressured steps per knob per run
  (reverts don't consume budget, so a budget-exhausted knob can still
  come home);
* **reversible**: every knob steps back toward its baseline on calm
  (throttles also auto-expire);
* **attributable**: one ``actuation`` flight event per step carrying the
  triggering signal (objective, value, threshold, or the calm verdict
  for reverts), which ``obs.doctor`` correlates.

Shed and throttle affect admission, never applied state: per-tenant
wins2 equals that of T independent indexes fed the same *admitted*
events through any actuation schedule.

Spec format (dict, JSON string, or ``@path`` / ``*.json``, the
``--chaos-spec`` convention), every field optional::

    {"knobs": ["shed", "flush", "mesh"],
     "warn_fraction": 0.7, "release_fraction": 0.4,
     "cooldown_s": 0.25, "up_ticks": 2, "down_ticks": 6,
     "throttle_s": 0.5, "shed_budget": 64,
     "mesh_max_shards": 4, "mesh_budget": 4,
     "promote_lookahead_s": 2.0}

With no controller (no spec, or ``enabled: false``) the engines behave
as without this module: no actuator is attached, their override maps stay
empty, and every ``.get(tid, default)`` resolves to the static config.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Dict, List, Optional, Tuple


class ControllerSpecError(ValueError):
    """The controller spec failed validation (unknown field/knob)."""


_KNOBS = ("shed", "flush", "weights", "mesh", "promote")


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs of the control plane itself (thresholds, budgets,
    hysteresis). Defaults are tuned for service runs measured in
    seconds-to-minutes (a replay, a CI smoke, a short serve); spec
    authors scale the cooldowns/windows for production horizons."""

    enabled: bool = True
    knobs: Tuple[str, ...] = _KNOBS
    # pressure classification: an objective is PRESSURED when its
    # value crosses warn_fraction of its threshold (or its error
    # budget burns faster than warn_burn), CALM when it falls back
    # under release_fraction — the gap is the hysteresis band
    warn_fraction: float = 0.7
    release_fraction: float = 0.4
    warn_burn: float = 1.0
    up_ticks: int = 2
    down_ticks: int = 6
    cooldown_s: float = 0.25
    # shed
    shed_budget: int = 64
    throttle_s: float = 0.5
    shed_min_share: float = 0.2
    max_throttled_fraction: float = 0.5
    # flush / q-bucket targets
    flush_budget: int = 16
    flush_step: float = 2.0
    flush_max_scale: float = 8.0
    batch_max_scale: float = 4.0
    # DRR weight rebalance
    weight_budget: int = 32
    weight_boost: int = 4
    slow_factor: float = 3.0
    # mesh resize
    mesh_budget: int = 4
    mesh_max_shards: Optional[int] = None
    mesh_up_ticks: int = 4
    mesh_down_ticks: int = 12
    # slope-based whale promotion
    promote_budget: int = 8
    promote_lookahead_s: float = 2.0

    def __post_init__(self):
        for k in self.knobs:
            if k not in _KNOBS:
                raise ControllerSpecError(
                    f"unknown knob {k!r}; expected a subset of {_KNOBS}")
        if not 0.0 < self.release_fraction < self.warn_fraction <= 1.0:
            raise ControllerSpecError(
                "need 0 < release_fraction < warn_fraction <= 1, got "
                f"{self.release_fraction} / {self.warn_fraction}")
        if self.up_ticks < 1 or self.down_ticks < 1:
            raise ControllerSpecError(
                f"up_ticks/down_ticks must be >= 1: "
                f"{self.up_ticks}/{self.down_ticks}")
        if self.cooldown_s < 0:
            raise ControllerSpecError(
                f"cooldown_s must be >= 0: {self.cooldown_s}")
        if self.flush_step <= 1.0:
            raise ControllerSpecError(
                f"flush_step must be > 1: {self.flush_step}")
        if not 0.0 < self.shed_min_share <= 1.0:
            raise ControllerSpecError(
                f"shed_min_share must be in (0, 1]: "
                f"{self.shed_min_share}")
        if self.throttle_s <= 0:
            raise ControllerSpecError(
                f"throttle_s must be > 0: {self.throttle_s}")

    @classmethod
    def from_spec(cls, spec) -> "ControllerConfig":
        """Build from a dict, a JSON string, or ``@path`` / ``.json``
        (the ``--chaos-spec`` convention). None = defaults."""
        if spec is None:
            return cls()
        if isinstance(spec, ControllerConfig):
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
            raise ControllerSpecError(
                f"controller spec must be a dict, got {type(spec)}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(spec) - fields
        if unknown:
            raise ControllerSpecError(
                f"unknown controller spec fields: {sorted(unknown)}")
        if "knobs" in spec:
            spec = dict(spec, knobs=tuple(spec["knobs"]))
        return cls(**spec)


class _Knob:
    """Hysteresis + rate limit + budget for ONE knob.

    ``tick(want, now)`` is called once per SLO evaluation with the
    direction the signals ask for (+1 step up, -1 step down, 0 calm,
    None neutral) and returns the step actually taken: pressured
    steps need ``up_ticks`` consecutive same-direction ticks, a
    cooldown gap, remaining budget, and level headroom; calm reverts
    need ``down_ticks`` consecutive calm ticks and step toward level
    0 without consuming budget. Anything else returns 0 — the no-flap
    guarantee is structural, not behavioral."""

    __slots__ = ("name", "cooldown_s", "budget", "up_ticks",
                 "down_ticks", "max_level", "min_level", "level",
                 "used", "_up", "_down", "_calm", "_last")

    def __init__(self, name: str, cooldown_s: float, budget: int,
                 up_ticks: int, down_ticks: int, max_level: int = 1,
                 min_level: int = 0):
        self.name = name
        self.cooldown_s = cooldown_s
        self.budget = budget
        self.up_ticks = up_ticks
        self.down_ticks = down_ticks
        self.max_level = max_level
        self.min_level = min_level
        self.level = 0
        self.used = 0
        self._up = self._down = self._calm = 0
        self._last = -math.inf

    def tick(self, want: Optional[int], now: float) -> int:
        if want is None:                 # neutral: reset all streaks
            self._up = self._down = self._calm = 0
            return 0
        if want > 0:
            self._up += 1
            self._down = self._calm = 0
        elif want < 0:
            self._down += 1
            self._up = self._calm = 0
        else:
            self._calm += 1
            self._up = self._down = 0
        if now - self._last < self.cooldown_s:
            return 0
        step = 0
        if want > 0 and self._up >= self.up_ticks \
                and self.level < self.max_level \
                and self.used < self.budget:
            step = 1
            self.used += 1
        elif want < 0 and self._down >= self.up_ticks \
                and self.level > self.min_level \
                and self.used < self.budget:
            step = -1
            self.used += 1
        elif want == 0 and self._calm >= self.down_ticks \
                and self.level != 0:
            step = -1 if self.level > 0 else 1   # home, budget-free
        if step:
            self.level += step
            self._last = now
            self._up = self._down = self._calm = 0
        return step

    def reset_home(self, now: float) -> None:
        """Snap the level to baseline (used by knobs whose revert is
        all-at-once: clear every throttle, restore every weight)."""
        self.level = 0
        self._last = now
        self._up = self._down = self._calm = 0

    def state(self) -> dict:
        return {"level": self.level, "used": self.used,
                "budget": self.budget}


class FleetController:
    """Closes the SLO loop over a serving engine.

    Args:
      engine: a ``MultiTenantEngine`` (every knob) or a
        ``MicroBatchEngine`` (the ``flush`` knob; tenant/mesh knobs
        no-op without a fleet).
      spec: anything :meth:`ControllerConfig.from_spec` accepts.
      metrics / flight: default to the engine's own.

    Wire-up: ``controller.attach(slo_monitor)`` registers
    :meth:`on_signals` as an actuator — the controller then runs on
    the flusher thread, acting on exactly the snapshots the SLO
    verdicts judge. Every actuation records one ``actuation`` flight
    event with the triggering signal and increments
    ``controller_actuations_total`` (global + ``{knob=}``).
    """

    def __init__(self, engine, spec=None, metrics=None, flight=None):
        self.config = ControllerConfig.from_spec(spec)
        self.engine = engine
        self.fleet = getattr(engine, "fleet", None)
        self.metrics = metrics if metrics is not None else engine.metrics
        self.flight = flight if flight is not None else engine.flight
        self.monitor = None
        c = self.config
        self._base_flush = engine.config.flush_timeout_s
        self._base_batch = engine.config.max_batch
        base_shards = (self.fleet.shards
                       if self.fleet is not None else None) or 0
        self._base_shards = base_shards
        mesh_max = c.mesh_max_shards
        if mesh_max is None and base_shards:
            pool = (len(self.fleet._healer._pool)
                    if self.fleet._healer is not None else base_shards)
            mesh_max = pool
        mesh_levels = (max(0, int(math.log2(mesh_max / base_shards)))
                       if base_shards and mesh_max else 0)
        flush_levels = max(1, int(round(
            math.log(c.flush_max_scale, c.flush_step))))
        self._knobs: Dict[str, _Knob] = {
            "shed": _Knob("shed", c.cooldown_s, c.shed_budget,
                          c.up_ticks, max(1, c.down_ticks // 2),
                          max_level=c.shed_budget),
            "flush": _Knob("flush", c.cooldown_s, c.flush_budget,
                           c.up_ticks, c.down_ticks,
                           max_level=flush_levels, min_level=-2),
            "weights": _Knob("weights", c.cooldown_s, c.weight_budget,
                             c.up_ticks, c.down_ticks,
                             max_level=c.weight_budget),
            "mesh": _Knob("mesh", c.cooldown_s, c.mesh_budget,
                          c.mesh_up_ticks, c.mesh_down_ticks,
                          max_level=mesh_levels),
            "promote": _Knob("promote", c.cooldown_s, c.promote_budget,
                             1, c.down_ticks,
                             max_level=c.promote_budget),
        }
        m = self.metrics
        self._c_act = m.counter("controller_actuations_total")
        self._c_revert = m.counter("controller_reverts_total")
        self._g_flush = m.gauge("controller_flush_scale")
        self._g_flush.set(1.0)
        self._g_batch = m.gauge("controller_max_batch")
        self._g_batch.set(self._base_batch)
        self._g_throttled = m.gauge("controller_throttled_tenants")
        self._g_mesh = m.gauge("controller_mesh_level")
        # per-tenant traffic slopes from the labeled insert histograms
        self._prev_counts: Optional[Tuple[float, Dict[str, int]]] = None
        self._rates: Dict[str, float] = {}
        self._boosted: Dict[str, int] = {}
        self.actuations: List[dict] = []

    # ------------------------------------------------------------------ #
    def attach(self, monitor) -> "FleetController":
        """Register on an ``SloMonitor``'s actuator hook."""
        self.monitor = monitor
        monitor.add_actuator(self.on_signals)
        return self

    # ------------------------------------------------------------------ #
    # signal classification                                              #
    # ------------------------------------------------------------------ #
    def _classify(self, name: str, det: dict):
        """(pressure, calm, value, threshold) for one objective's
        current detail — the warn/release hysteresis band around the
        SLO's own threshold."""
        c = self.config
        typ = det.get("type")
        breached = bool(det.get("breached_now"))
        v = det.get("value")
        if typ == "error_rate":
            burn = v or 0.0
            pressure = breached or burn >= c.warn_burn
            calm = (not breached
                    and burn <= c.warn_burn * c.release_fraction)
            return pressure, calm, burn, c.warn_burn
        if typ == "latency":
            thr = det.get("threshold_ms")
        elif typ == "saturation":
            thr = det.get("max_fraction", 0.9)
        else:   # counter_max: binary — no warn band below the count
            return breached, not breached, v, det.get("max")
        if v is None or not thr:
            return breached, not breached, v, thr
        frac = v / thr
        pressure = breached or frac >= c.warn_fraction
        calm = (not breached) and frac <= c.release_fraction
        return pressure, calm, v, thr

    @staticmethod
    def _is_backlog(typ: str) -> bool:
        """Backlog-shaped pressure (queue filling, budget burning)
        wants MORE throughput; pure latency pressure wants SMALLER
        batches. The flush knob steers by this split."""
        return typ in ("saturation", "error_rate", "counter_max")

    def _tenant_rates(self, metrics: dict, now: float) -> None:
        """Per-tenant insert rates (events/s) from consecutive
        snapshots of the labeled ``tenant_events_total{tenant=}``
        counters — the traffic-slope signal shed ordering and whale
        promotion use. Falls back to the ``insert_latency_s`` request
        counts for registries without the event counters."""
        from tuplewise_tpu_torch.utils.profiling import parse_labeled_name

        counts: Dict[str, int] = {}
        fallback: Dict[str, int] = {}
        for key, snap in metrics.items():
            base, lab = parse_labeled_name(key)
            if not lab or "tenant" not in lab:
                continue
            if base == "tenant_events_total":
                counts[lab["tenant"]] = snap.get("value", 0)
            elif base == "insert_latency_s":
                fallback[lab["tenant"]] = snap.get("count", 0)
        if not counts:
            counts = fallback
        if self._prev_counts is not None:
            pt, pc = self._prev_counts
            dt = now - pt
            if dt > 0:
                self._rates = {
                    t: max(0.0, (n - pc.get(t, 0)) / dt)
                    for t, n in counts.items()}
        self._prev_counts = (now, counts)

    # ------------------------------------------------------------------ #
    # the actuator                                                       #
    # ------------------------------------------------------------------ #
    def on_signals(self, sig: dict) -> None:
        """SloMonitor actuator entry point: one evaluated snapshot."""
        if not self.config.enabled:
            return
        now = sig["ts_mono"]
        metrics = sig["metrics"]
        self._tenant_rates(metrics, now)
        backlog: List[Tuple[str, float, float]] = []
        latency: List[Tuple[str, float, float]] = []
        all_calm = True
        for name, det in sig["objectives"].items():
            pressure, calm, v, thr = self._classify(name, det)
            if not calm:
                all_calm = False
            if pressure:
                bucket = (backlog if self._is_backlog(det.get("type"))
                          else latency)
                bucket.append((name, v, thr))
        knobs = self.config.knobs
        if "shed" in knobs:
            self._knob_shed(backlog, all_calm, now)
        if "flush" in knobs:
            self._knob_flush(backlog, latency, all_calm, now)
        if "weights" in knobs and self.fleet is not None:
            self._knob_weights(metrics, all_calm, now)
        if "mesh" in knobs and self.fleet is not None:
            self._knob_mesh(backlog, latency, all_calm, now)
        if "promote" in knobs and self.fleet is not None:
            self._knob_promote(now)

    # ------------------------------------------------------------------ #
    def _record(self, knob: str, action: str, signal: dict,
                **fields) -> None:
        """One actuation: flight event (the attribution record doctor
        correlates), counters, and the in-memory log records read."""
        ev = dict(knob=knob, action=action, signal=signal, **fields)
        self.flight.record("actuation", **ev)
        self._c_act.inc()
        self.metrics.counter("controller_actuations_total",
                             labels={"knob": knob}).inc()
        if action.startswith(("restore", "release", "narrow_restore")):
            self._c_revert.inc()
        self.actuations.append(dict(ev, t_mono=time.perf_counter()))

    @staticmethod
    def _worst(pressured: List[Tuple[str, float, float]]) -> dict:
        name, v, thr = max(
            pressured,
            key=lambda e: (e[1] / e[2]) if e[1] and e[2] else 0.0)
        return {"reason": "pressure", "objective": name, "value": v,
                "threshold": thr}

    @staticmethod
    def _calm_signal(knob: str) -> dict:
        return {"reason": "calm", "objective": None,
                "detail": f"{knob}: all objectives under the release "
                          "fraction"}

    # ------------------------------------------------------------------ #
    # knobs                                                              #
    # ------------------------------------------------------------------ #
    def _knob_shed(self, backlog, all_calm, now) -> None:
        eng = self.engine
        if not hasattr(eng, "throttle_tenant"):
            return
        k = self._knobs["shed"]
        want = 1 if backlog else (0 if all_calm else None)
        step = k.tick(want, now)
        if step > 0:
            targets = self._shed_targets()
            if not targets:
                k.level -= 1    # nothing attributable to shed: undo
                k.used -= 1
                return
            for tid in targets:
                eng.throttle_tenant(tid,
                                    retry_after_s=self.config.throttle_s)
            self._g_throttled.set(len(eng.throttled_tenants()))
            self._record("shed", "throttle", self._worst(backlog),
                         tenants=targets,
                         retry_after_s=self.config.throttle_s)
        elif step < 0:
            n = eng.clear_throttles()
            k.reset_home(now)
            self._g_throttled.set(0)
            if n:
                self._record("shed", "release",
                             self._calm_signal("shed"), released=n)

    def _shed_targets(self) -> List[str]:
        """The tenants to throttle: whoever owns an outsized share of
        the pending queue right now — the direct culprit signal (a
        high EVENT rate alone is not grounds for shedding: a polite
        bulk inserter with one resolved request at a time never
        floods the queue). Ties broken by traffic slope, never more
        than ``max_throttled_fraction`` of the live tenants, and a
        near-empty queue yields no targets at all."""
        eng = self.engine
        pending = (eng.pending_by_tenant()
                   if hasattr(eng, "pending_by_tenant") else {})
        total = sum(pending.values())
        if total < 4:   # nothing queue-shaped to attribute
            return []
        targets = [
            tid for tid, n in sorted(
                pending.items(),
                key=lambda kv: (-kv[1], -self._rates.get(kv[0], 0.0)))
            if n / total >= self.config.shed_min_share]
        live = (self.fleet.n_tenants if self.fleet is not None
                else len(pending)) or 1
        cap = max(1, int(live * self.config.max_throttled_fraction))
        return targets[:cap]

    def _knob_flush(self, backlog, latency, all_calm, now) -> None:
        k = self._knobs["flush"]
        if backlog:
            want = 1
        elif latency:
            want = -1
        elif all_calm:
            want = 0
        else:
            want = None
        step = k.tick(want, now)
        if not step:
            return
        c = self.config
        scale = c.flush_step ** k.level
        scale = min(max(scale, 1.0 / c.flush_max_scale),
                    c.flush_max_scale)
        # micro-batch cap moves in powers of two, as the count layer's
        # power-of-two query buckets do
        batch = int(self._base_batch * min(2.0 ** max(0, k.level),
                                           c.batch_max_scale))
        self.engine.config = dataclasses.replace(
            self.engine.config,
            flush_timeout_s=self._base_flush * scale,
            max_batch=max(1, batch))
        self._g_flush.set(scale)
        self._g_batch.set(batch)
        if want == 1 and step > 0:
            signal, action = self._worst(backlog), "widen"
        elif want == -1 and step < 0:
            signal, action = self._worst(latency), "narrow"
        else:
            signal = self._calm_signal("flush")
            action = "restore"
        self._record("flush", action, signal, level=k.level,
                     flush_timeout_s=self._base_flush * scale,
                     max_batch=batch)

    def _knob_weights(self, metrics, all_calm, now) -> None:
        """Boost the DRR quantum of tenants whose observed insert p99
        runs ``slow_factor`` past the fleet median — they are being
        starved by the round-robin, not flooding it."""
        from tuplewise_tpu_torch.utils.profiling import parse_labeled_name

        eng = self.engine
        if not hasattr(eng, "set_tenant_weight"):
            return
        p99: Dict[str, float] = {}
        for key, snap in metrics.items():
            base, lab = parse_labeled_name(key)
            if base == "insert_latency_s" and lab \
                    and "tenant" in lab and lab["tenant"] != "__other__":
                v = snap.get("p99")
                if v is not None:
                    p99[lab["tenant"]] = v
        slow: Dict[str, float] = {}
        if len(p99) >= 4:
            med = sorted(p99.values())[len(p99) // 2]
            if med > 0:
                slow = {t: v for t, v in p99.items()
                        if v > self.config.slow_factor * med}
        k = self._knobs["weights"]
        step = k.tick(1 if slow else 0, now)
        if step > 0:
            base_w = eng.tenancy.weight
            boosted = {}
            for tid in slow:
                if self._boosted.get(tid) is None:
                    w = base_w * self.config.weight_boost
                    eng.set_tenant_weight(tid, w)
                    self._boosted[tid] = w
                    boosted[tid] = w
            restored = [t for t in self._boosted if t not in slow]
            for tid in restored:
                eng.set_tenant_weight(tid, None)
                del self._boosted[tid]
            if not boosted and not restored:
                k.level -= 1    # nothing to rebalance: undo the step
                k.used -= 1
                return
            med = sorted(p99.values())[len(p99) // 2]
            self._record(
                "weights", "boost",
                {"reason": "pressure",
                 "metric": "insert_latency_s{tenant=*}",
                 "value": max(slow.values()) * 1e3,
                 "threshold": self.config.slow_factor * med * 1e3},
                weights=boosted, restored=restored)
        elif step < 0:
            n = len(self._boosted)
            for tid in list(self._boosted):
                eng.set_tenant_weight(tid, None)
            self._boosted.clear()
            k.reset_home(now)
            if n:
                self._record("weights", "restore",
                             self._calm_signal("weights"), restored=n)

    def _knob_mesh(self, backlog, latency, all_calm, now) -> None:
        fleet = self.fleet
        if fleet.shards is None or fleet._healer is None:
            return
        k = self._knobs["mesh"]
        pressured = backlog + latency
        want = 1 if pressured else (0 if all_calm else None)
        step = k.tick(want, now)
        if not step:
            return
        target = int(self._base_shards * (2 ** max(0, k.level)))
        if not fleet.resize_shards(target):
            # pool can't supply it (or no-op): undo the step
            k.level -= step
            if step > 0:
                k.used -= 1
            return
        self._g_mesh.set(k.level)
        if step > 0:
            self._record("mesh", "grow", self._worst(pressured),
                         shards=target, level=k.level)
        else:
            self._record("mesh", "shrink", self._calm_signal("mesh"),
                         shards=target, level=k.level)

    def _knob_promote(self, now) -> None:
        """Preemptive whale promotion from traffic slope: a tenant
        whose projected event count crosses ``whale_threshold`` within
        the lookahead is promoted NOW, before its per-compaction splice
        cost drags the fleet. Promotion is statistically invisible (a
        whale's counts equal the pack's), so acting early is free."""
        fleet = self.fleet
        thr = fleet.whale_threshold
        if not thr or not self._rates:
            return
        k = self._knobs["promote"]
        cand = None
        for tid, rate in sorted(self._rates.items(),
                                key=lambda kv: -kv[1])[:8]:
            if tid == "__other__" or rate <= 0:
                continue
            if fleet.is_whale(tid):
                continue
            st = fleet.tenant_state(tid)
            if st is None:
                continue
            projected = st["n_events"] \
                + rate * self.config.promote_lookahead_s
            if st["n_events"] < thr <= projected:
                cand = (tid, rate, st["n_events"], projected)
                break
        step = k.tick(1 if cand is not None else None, now)
        if step > 0 and cand is not None:
            tid, rate, n_events, projected = cand
            if fleet.promote(tid):
                self._record(
                    "promote", "promote_whale",
                    {"reason": "slope", "metric": "tenant_insert_rate",
                     "tenant": tid, "value": rate,
                     "threshold": thr, "n_events": n_events,
                     "projected_events": projected,
                     "lookahead_s": self.config.promote_lookahead_s},
                    tenant=tid)
            else:
                k.level -= 1
                k.used -= 1

    # ------------------------------------------------------------------ #
    def state(self) -> dict:
        """The controller block records/exit summaries embed."""
        return {
            "enabled": self.config.enabled,
            "knobs": {n: k.state() for n, k in self._knobs.items()
                      if n in self.config.knobs},
            "actuations_total": self._c_act.value,
            "reverts_total": self._c_revert.value,
            "throttled_now": (self.engine.throttled_tenants()
                              if hasattr(self.engine,
                                         "throttled_tenants") else []),
            "boosted_weights": dict(self._boosted),
        }
