"""The port's control plane (``serving/control.py``) against the JAX
package's: the controller spec, the knob discipline (hysteresis, cooldown,
budget), typed throttles and per-tenant overrides, the deadline reaper,
each knob pumped deterministically, the flash-crowd, tenant-ramp and
device-loss scenarios (the controlled fleet keeps the SLO an uncontrolled
twin breaches), the doctor's actuation attribution and both replays with
a controller. Mirrors tests/test_control.py of the JAX package
(``TestMeshResize`` is in test_torch_fleet_mesh.py).

Parity with the JAX package: ``ControllerConfig.from_spec`` gives equal
fields; ``_Knob.tick`` gives equal step sequences on the same random
schedules; ``FleetController.on_signals`` fed the same signal bundles in
front of a stub engine makes the same calls and the same ``actuation``
flight events; per-tenant wins2 over the admitted events equals the JAX
index's on the same admitted stream, bit for bit."""

import dataclasses
import json
import time

import numpy as np
import pytest

from tuplewise_tpu.obs.doctor import diagnose as jax_diagnose
from tuplewise_tpu.obs.flight import FlightRecorder as JaxFlight
from tuplewise_tpu.serving import ExactAucIndex as JaxIndex
from tuplewise_tpu.serving.control import (
    ControllerConfig as JaxControllerConfig,
    FleetController as JaxController,
    _Knob as JaxKnob,
)
from tuplewise_tpu.utils.profiling import MetricsRegistry as JaxRegistry
from tuplewise_tpu_torch.obs.doctor import diagnose
from tuplewise_tpu_torch.obs.flight import FlightRecorder
from tuplewise_tpu_torch.obs.slo import SloMonitor
from tuplewise_tpu_torch.serving import (
    BackpressureError,
    ControllerConfig,
    DeadlineExceededError,
    ExactAucIndex,
    FleetController,
    MicroBatchEngine,
    MultiTenantEngine,
    ServingConfig,
    TenancyConfig,
    TenantThrottledError,
    make_stream,
    make_tenant_stream,
    replay,
    replay_fleet,
)
from tuplewise_tpu_torch.serving.control import ControllerSpecError, _Knob
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry

SAT_SPEC = {"objectives": [
    {"name": "queue_sat", "type": "saturation",
     "metric": "queue_depth_live", "capacity": "queue_size",
     "max_fraction": 0.8},
    {"name": "no_hard_rejects", "type": "counter_max",
     "metric": "rejected_total", "max": 0},
]}

FAST_CTL = {"cooldown_s": 0.0, "up_ticks": 1, "down_ticks": 2}


def _cfg(**kw):
    return ServingConfig(device="cpu", **kw)


def _observe(mon, eng, ts):
    mon.observe(eng.metrics.snapshot(), ts)


def _jax_wins2(batches):
    """The JAX index's wins2 over the concatenated (scores, labels)
    batches: float32, as the port's fleet stores them."""
    idx = JaxIndex(engine="jax")
    idx.insert_batch(np.concatenate([s for s, _ in batches]),
                     np.concatenate([lab for _, lab in batches]))
    return idx._wins2


# --------------------------------------------------------------------- #
# spec + knob discipline                                                 #
# --------------------------------------------------------------------- #

class TestControllerSpec:
    def test_defaults_and_json_roundtrip(self):
        cfg = ControllerConfig.from_spec(None)
        assert cfg.enabled and set(cfg.knobs) == {
            "shed", "flush", "weights", "mesh", "promote"}
        cfg2 = ControllerConfig.from_spec(
            json.dumps({"knobs": ["shed"], "cooldown_s": 1.5}))
        assert cfg2.knobs == ("shed",) and cfg2.cooldown_s == 1.5

    def test_unknown_field_rejected(self):
        with pytest.raises(ControllerSpecError):
            ControllerConfig.from_spec({"coolness": 11})
        with pytest.raises(ControllerSpecError):
            ControllerConfig.from_spec({"knobs": ["turbo"]})
        with pytest.raises(ControllerSpecError):
            ControllerConfig.from_spec({"release_fraction": 0.9})
        assert issubclass(ControllerSpecError, ValueError)

    def test_at_file(self, tmp_path):
        p = tmp_path / "ctl.json"
        p.write_text(json.dumps({"throttle_s": 0.25}))
        assert ControllerConfig.from_spec(
            "@" + str(p)).throttle_s == 0.25
        assert ControllerConfig.from_spec(str(p)).throttle_s == 0.25

    @pytest.mark.parametrize("spec", [
        None, {}, {"knobs": ["shed", "mesh"], "cooldown_s": 0.5},
        {"warn_fraction": 0.9, "release_fraction": 0.1, "up_ticks": 3,
         "down_ticks": 9, "throttle_s": 2.0, "mesh_max_shards": 8},
        '{"enabled": false, "flush_step": 4.0, "flush_max_scale": 16.0}',
        {"weight_boost": 2, "slow_factor": 5.0, "promote_budget": 1,
         "promote_lookahead_s": 0.5, "shed_min_share": 1.0},
    ])
    def test_fields_equal_the_jax_package(self, spec):
        got = dataclasses.asdict(ControllerConfig.from_spec(spec))
        want = dataclasses.asdict(JaxControllerConfig.from_spec(spec))
        assert got == want


class TestKnobDiscipline:
    def test_hysteresis_needs_consecutive_pressure(self):
        k = _Knob("x", cooldown_s=0.0, budget=100, up_ticks=3,
                  down_ticks=2, max_level=5)
        t = 0.0
        # interrupted streaks never actuate
        for want in (1, 1, 0, 1, 1, None, 1, 1):
            assert k.tick(want, t) == 0
            t += 1.0
        assert k.tick(1, t) == 1     # third consecutive
        assert k.level == 1

    def test_cooldown_rate_limits(self):
        k = _Knob("x", cooldown_s=1.0, budget=100, up_ticks=1,
                  down_ticks=1, max_level=100)
        steps = sum(abs(k.tick(1, 0.1 * i)) for i in range(100))
        # 9.9 simulated seconds / 1 s cooldown -> at most 10 steps
        assert steps <= 10

    def test_budget_bounds_pressured_steps_but_not_homecoming(self):
        k = _Knob("x", cooldown_s=0.0, budget=3, up_ticks=1,
                  down_ticks=1, max_level=100)
        t = 0.0
        ups = 0
        for _ in range(50):
            ups += max(0, k.tick(1, t))
            t += 1.0
        assert ups == 3 and k.used == 3
        downs = 0
        for _ in range(50):
            downs += -min(0, k.tick(0, t))
            t += 1.0
        assert downs == 3 and k.level == 0   # reverts ran budget-free

    def test_randomized_schedule_no_flap(self):
        rng = np.random.default_rng(7)
        k = _Knob("x", cooldown_s=0.5, budget=1000, up_ticks=2,
                  down_ticks=4, max_level=4, min_level=-2)
        t = 0.0
        moves = []
        for _ in range(500):
            want = int(rng.integers(-1, 2))
            s = k.tick(want, t)
            if s:
                moves.append(t)
            t += 0.05
        # rate limit: never two actuations inside one cooldown window
        assert all(b - a >= 0.5 for a, b in zip(moves, moves[1:]))
        assert len(moves) <= 25 / 0.5 + 1
        assert -2 <= k.level <= 4

    @pytest.mark.parametrize("seed", range(6))
    def test_tick_sequences_equal_the_jax_package(self, seed):
        rng = np.random.default_rng(seed)
        kw = dict(cooldown_s=float(rng.choice([0.0, 0.1, 0.5])),
                  budget=int(rng.integers(1, 20)),
                  up_ticks=int(rng.integers(1, 4)),
                  down_ticks=int(rng.integers(1, 6)),
                  max_level=int(rng.integers(1, 6)),
                  min_level=-int(rng.integers(0, 3)))
        ours, theirs = _Knob("x", **kw), JaxKnob("x", **kw)
        t = 0.0
        for i in range(400):
            want = [None, -1, 0, 1][int(rng.integers(0, 4))]
            assert ours.tick(want, t) == theirs.tick(want, t), i
            assert ours.state() == theirs.state()
            if i % 97 == 96:
                ours.reset_home(t)
                theirs.reset_home(t)
            t += float(rng.choice([0.01, 0.05, 0.3]))


# --------------------------------------------------------------------- #
# typed throttling + per-tenant overrides                                #
# --------------------------------------------------------------------- #

class TestThrottle:
    def test_throttle_is_typed_expiring_and_counted(self):
        with MultiTenantEngine(_cfg(flush_timeout_s=0.001),
                               TenancyConfig()) as eng:
            eng.throttle_tenant("hot", retry_after_s=0.2)
            with pytest.raises(TenantThrottledError) as ei:
                eng.insert("hot", 1.0, 1)
            assert ei.value.tenant == "hot"
            assert 0 < ei.value.retry_after_s <= 0.2
            # other tenants unaffected
            assert eng.insert("calm", 1.0, 1).result(10.0) == 1
            time.sleep(0.25)
            assert eng.insert("hot", 1.0, 1).result(10.0) == 1
            m = eng.metrics.snapshot()
            assert m["tenant_throttled_total"]["value"] == 1
            assert m["tenant_throttled_total{tenant=hot}"]["value"] == 1
            kinds = [e["kind"] for e in eng.flight.events()]
            assert "tenant_throttled" in kinds

    def test_weight_and_quota_overrides(self):
        with MultiTenantEngine(
                _cfg(flush_timeout_s=0.2, max_batch=64),
                TenancyConfig(tenant_quota=4, weight=2)) as eng:
            eng.set_tenant_quota("big", 64)
            # the default quota would reject the 5th queued request;
            # the override admits far more
            futs = [eng.insert("big", float(i), i % 2)
                    for i in range(32)]
            for f in futs:
                f.result(10.0)
            eng.set_tenant_weight("big", 16)
            assert eng._tenant_weights["big"] == 16
            eng.set_tenant_weight("big", None)
            assert "big" not in eng._tenant_weights

    def test_controller_off_is_todays_behavior(self):
        """No controller: no throttles, no overrides, no controller
        metrics or flight kinds; wins2 equals independent indexes' and
        the JAX index's."""
        scores, labels = (np.random.default_rng(3).standard_normal(200),
                          np.random.default_rng(4).random(200) < 0.5)
        with MultiTenantEngine(_cfg(flush_timeout_s=0.001),
                               TenancyConfig()) as eng:
            singles, batches = {}, {}
            for i in range(0, 200, 10):
                tid = f"t{(i // 10) % 4}"
                s = scores[i:i + 10].astype(np.float32)
                eng.insert(tid, s, labels[i:i + 10]).result(10.0)
                singles.setdefault(tid, ExactAucIndex(
                    device="cpu")).insert_batch(s, labels[i:i + 10])
                batches.setdefault(tid, []).append((s, labels[i:i + 10]))
            eng.flush()
            assert not eng._throttles and not eng._tenant_weights \
                and not eng._tenant_quotas
            m = eng.metrics.snapshot()
            assert "controller_actuations_total" not in m
            assert m["tenant_throttled_total"]["value"] == 0
            assert not eng.flight.events("actuation")
            for tid, idx in singles.items():
                assert eng.fleet.wins2(tid) == idx._wins2 \
                    == _jax_wins2(batches[tid])


# --------------------------------------------------------------------- #
# deadline reaper                                                        #
# --------------------------------------------------------------------- #

class TestDeadlineReaper:
    def test_wedged_batcher_expires_queued_requests(self):
        """Dispatch-time expiry never runs while the batcher is wedged
        mid-apply: the reaper fails the waiting request typed long before
        the wedge clears."""
        eng = MicroBatchEngine(_cfg(
            deadline_s=0.1, flush_timeout_s=0.001, max_batch=1))
        orig = eng.index.insert_batch

        def wedge(s, lab):
            time.sleep(1.2)
            return orig(s, lab)

        eng.index.insert_batch = wedge
        try:
            eng.insert(1.0, 1)          # dispatched, wedges the batcher
            time.sleep(0.05)
            t0 = time.perf_counter()
            f2 = eng.insert(2.0, 0)     # waits in the queue
            with pytest.raises(DeadlineExceededError):
                f2.result(timeout=0.8)
            waited = time.perf_counter() - t0
            assert waited < 0.8, waited
            assert eng.metrics.snapshot()[
                "deadline_expired_total"]["value"] >= 1
            assert any(e["kind"] == "deadline_expired"
                       for e in eng.flight.events())
        finally:
            eng.index.insert_batch = orig
            eng.close()

    def test_expiry_is_counted_once(self):
        """Reaper and dispatch both see a stale request: exactly one of
        them wins and the counter moves once a request."""
        eng = MicroBatchEngine(_cfg(
            deadline_s=0.05, flush_timeout_s=0.001, max_batch=1))
        orig = eng.index.insert_batch

        def wedge(s, lab):
            time.sleep(0.4)
            return orig(s, lab)

        eng.index.insert_batch = wedge
        try:
            eng.insert(1.0, 1)
            time.sleep(0.02)
            futs = [eng.insert(float(i), i % 2) for i in range(4)]
            for f in futs:
                with pytest.raises(DeadlineExceededError):
                    f.result(timeout=1.0)
            time.sleep(0.5)     # the wedge clears, the batcher drains
            assert eng.metrics.snapshot()[
                "deadline_expired_total"]["value"] == 4
        finally:
            eng.index.insert_batch = orig
            eng.close()

    def test_fleet_reaper_frees_quota(self):
        eng = MultiTenantEngine(
            _cfg(deadline_s=0.08, flush_timeout_s=0.001),
            TenancyConfig(tenant_quota=2))
        orig = eng.fleet.apply_inserts

        def wedge(items):
            time.sleep(0.6)
            return orig(items)

        eng.fleet.apply_inserts = wedge
        try:
            f0 = eng.insert("a", 1.0, 1)    # wedges the batcher
            time.sleep(0.02)
            f1 = eng.insert("b", 1.0, 1)
            f2 = eng.insert("b", 2.0, 0)    # quota full for b
            for f in (f1, f2):
                with pytest.raises(DeadlineExceededError):
                    f.result(timeout=1.0)
            # the reaper removed them: b's quota slots are free again;
            # un-wedge before the new request's own deadline can expire
            eng.fleet.apply_inserts = orig
            f0.result(timeout=5.0)
            f3 = eng.insert("b", 3.0, 1)
            assert f3.result(timeout=5.0) == 1
            assert eng.metrics.snapshot()[
                "deadline_expired_total"]["value"] == 2
        finally:
            eng.fleet.apply_inserts = orig
            eng.close()


# --------------------------------------------------------------------- #
# controller knobs end to end (deterministic pumping)                    #
# --------------------------------------------------------------------- #

class TestControllerKnobs:
    def test_flush_widen_and_restore(self):
        with MultiTenantEngine(
                _cfg(queue_size=64, flush_timeout_s=0.001, max_batch=32),
                TenancyConfig()) as eng:
            mon = SloMonitor(SAT_SPEC, registry=eng.metrics,
                             flight=eng.flight,
                             context=dataclasses.asdict(eng.config))
            ctl = FleetController(
                eng, dict(FAST_CTL, knobs=["flush"])).attach(mon)
            t = 0.0
            eng.metrics.gauge("queue_depth_live").set(50)   # 0.78 sat
            _observe(mon, eng, t)
            assert eng.config.flush_timeout_s == 0.002
            assert eng.config.max_batch == 64
            eng.metrics.gauge("queue_depth_live").set(0)
            for i in range(3):
                _observe(mon, eng, t + 0.1 * (i + 1))
            assert eng.config.flush_timeout_s == 0.001
            assert eng.config.max_batch == 32
            acts = eng.flight.events("actuation")
            assert [a["action"] for a in acts] == ["widen", "restore"]
            assert all(a["signal"] for a in acts)
            assert ctl.state()["knobs"]["flush"]["level"] == 0
            m = eng.metrics.snapshot()
            assert m["controller_actuations_total"]["value"] == 2
            assert m["controller_actuations_total{knob=flush}"]["value"] == 2
            assert m["controller_reverts_total"]["value"] == 1

    def test_every_actuation_has_a_nonnull_signal(self):
        """Randomized signal schedule: bounded actuations per window,
        every actuation flight-evented with a non-null signal."""
        rng = np.random.default_rng(11)
        with MultiTenantEngine(
                _cfg(queue_size=64, flush_timeout_s=0.001),
                TenancyConfig()) as eng:
            mon = SloMonitor(SAT_SPEC, registry=eng.metrics,
                             flight=eng.flight,
                             context=dataclasses.asdict(eng.config))
            FleetController(
                eng, {"cooldown_s": 0.05, "up_ticks": 2,
                      "down_ticks": 3}).attach(mon)
            t = 0.0
            for _ in range(300):
                eng.metrics.gauge("queue_depth_live").set(
                    int(rng.integers(0, 64)))
                _observe(mon, eng, t)
                t += 0.01
            acts = eng.flight.events("actuation")
            assert all(isinstance(a["signal"], dict) and a["signal"]
                       for a in acts)
            per_knob = {}
            for a in acts:
                per_knob[a["knob"]] = per_knob.get(a["knob"], 0) + 1
            assert all(n <= 3 / 0.05 + 1 for n in per_knob.values()), \
                per_knob
            assert mon.actuator_errors == 0

    def test_slope_promotion_fires_before_threshold(self):
        with MultiTenantEngine(
                _cfg(flush_timeout_s=0.001),
                TenancyConfig(whale_threshold=2000)) as eng:
            ctl = FleetController(
                eng, dict(FAST_CTL, knobs=["promote"],
                          promote_lookahead_s=2.0))
            rng = np.random.default_rng(2)
            s = rng.standard_normal(300).astype(np.float32)
            lab = rng.random(300) < 0.5
            eng.insert("hot", s, lab).result(10.0)
            eng.flush()

            def sig(t):
                return {"ts_mono": t, "metrics": eng.metrics.snapshot(),
                        "transitions": [], "objectives": {}}

            ctl.on_signals(sig(0.0))
            s2 = rng.standard_normal(400).astype(np.float32)
            l2 = rng.random(400) < 0.5
            eng.insert("hot", s2, l2).result(10.0)
            eng.flush()
            # rate = 400 events / 0.1 s -> projected 700 + 8000 > 2000
            ctl.on_signals(sig(0.1))
            assert eng.fleet.is_whale("hot")
            acts = eng.flight.events("actuation")
            assert any(a["action"] == "promote_whale"
                       and a["signal"]["tenant"] == "hot"
                       and a["signal"]["value"] > 0 for a in acts)
            # promotion is statistically invisible
            assert eng.fleet.wins2("hot") == _jax_wins2([(s, lab),
                                                         (s2, l2)])

    def test_weights_boost_and_restore(self):
        with MultiTenantEngine(
                _cfg(flush_timeout_s=0.001),
                TenancyConfig(weight=2)) as eng:
            ctl = FleetController(
                eng, dict(FAST_CTL, knobs=["weights"], slow_factor=2.0))
            m = eng.metrics
            for tid in ["a", "b", "c", "d", "slowpoke"]:
                h = m.histogram("insert_latency_s",
                                labels={"tenant": tid})
                v = 0.5 if tid == "slowpoke" else 0.01
                for _ in range(10):
                    h.observe(v)

            def sig(t):
                return {"ts_mono": t, "metrics": m.snapshot(),
                        "transitions": [], "objectives": {}}

            ctl.on_signals(sig(0.0))
            assert eng._tenant_weights.get("slowpoke") == 2 * 4
            # calm: slowpoke's p99 falls back under the factor once fast
            # samples dominate its retained window -> restore
            h = m.histogram("insert_latency_s",
                            labels={"tenant": "slowpoke"})
            for _ in range(3000):
                h.observe(0.01)
            for t in range(1, 4):
                ctl.on_signals(sig(0.1 * t))
            assert "slowpoke" not in eng._tenant_weights
            acts = eng.flight.events("actuation")
            assert [a["action"] for a in acts] == ["boost", "restore"]


# --------------------------------------------------------------------- #
# scenarios                                                              #
# --------------------------------------------------------------------- #

def _run_flash_crowd(controlled, tenants=16, rounds=6, burst=80,
                     shards=None, chaos=None, whale="t0",
                     mesh_knob=False):
    """One flash-crowd run: each round a large innocent insert wedges the
    batcher while ``whale`` bursts ``burst`` single-event inserts; the
    SLO monitor is pumped every 10 submits. Returns (slo report, the
    fleet's per-tenant wins2, the JAX index's wins2 over the ADMITTED
    events, metrics snapshot, flight events)."""
    rng = np.random.default_rng(17)
    cfg = _cfg(queue_size=64, policy="reject", flush_timeout_s=0.001,
               max_batch=32, mesh_shards=shards)
    knobs = ["shed", "flush"] + (["mesh"] if mesh_knob else [])
    injector = None
    if chaos is not None:
        from tuplewise_tpu_torch.testing.chaos import FaultInjector

        injector = FaultInjector.from_spec(chaos)
    admitted = {}

    def feed_single(tid, s, lab):
        admitted.setdefault(tid, []).append((s, lab))

    def draw(k):
        return (rng.standard_normal(k).astype(np.float32),
                rng.random(k) < 0.5)

    with MultiTenantEngine(cfg, TenancyConfig(
            max_tenants=tenants + 8, tenant_quota=4096),
            chaos=injector) as eng:
        mon = SloMonitor(SAT_SPEC, registry=eng.metrics,
                         flight=eng.flight,
                         context=dataclasses.asdict(cfg))
        if controlled:
            FleetController(
                eng, dict(FAST_CTL, knobs=knobs,
                          mesh_up_ticks=1, mesh_down_ticks=64,
                          throttle_s=0.05)).attach(mon)
        for _ in range(rounds):
            # innocents: small batches, resolved in bounded windows
            futs = []

            def _drain():
                for tid_, s_, l_, f_ in futs:
                    f_.result(30.0)
                    feed_single(tid_, s_, l_)
                futs.clear()

            for k in range(1, tenants):
                s, lab = draw(8)
                futs.append((f"t{k}", s, lab, eng.insert(f"t{k}", s, lab)))
                if len(futs) >= 32:
                    _drain()
            _drain()
            # the wedge: one big innocent insert occupies the batcher
            ws, wl = draw(30_000)
            wedge_fut = eng.insert(f"t{tenants - 1}", ws, wl)
            feed_single(f"t{tenants - 1}", ws, wl)
            # the flash crowd: the whale bursts while the batcher is busy
            for i in range(burst):
                s, lab = draw(1)
                try:
                    eng.insert(whale, s, lab)
                    feed_single(whale, s, lab)
                except TenantThrottledError:
                    pass    # a controlled shed: out of the oracle too
                except BackpressureError:
                    pass    # the uncontrolled twin's hard rejects
                # every 10 submits: the queue cannot jump from below the
                # warn band (0.7*0.8*64 = 36) past the breach line
                # (0.8*64 = 51) between two observations
                if (i + 1) % 10 == 0:
                    _observe(mon, eng, time.perf_counter())
            wedge_fut.result(60.0)
            eng.flush()
            _observe(mon, eng, time.perf_counter())
            time.sleep(0.06)    # throttles expire between rounds
        eng.flush()
        slo = mon.report()
        m = eng.metrics.snapshot()
        fleet_wins = {t: eng.fleet.wins2(t) for t in eng.fleet.tenants()}
        flight = eng.flight.events()
    oracle_wins = {tid: _jax_wins2(b) for tid, b in admitted.items()}
    return slo, fleet_wins, oracle_wins, m, flight


class TestScenarios:
    def test_flash_crowd_controlled_vs_uncontrolled(self):
        """The controlled fleet keeps the SLO verdict healthy and sheds
        only the flooding tenant (typed, no hard rejects); the
        uncontrolled twin breaches. Per-tenant wins2 equals the JAX
        index's over the admitted events through every actuation."""
        slo, fleet_wins, oracle_wins, m, flight = _run_flash_crowd(
            controlled=True)
        assert slo["healthy"], slo
        assert m["rejected_total"]["value"] == 0
        assert m["tenant_rejected_total"]["value"] == 0
        assert m["tenant_throttled_total"]["value"] > 0
        assert fleet_wins == oracle_wins
        acts = [e for e in flight if e["kind"] == "actuation"]
        assert acts and all(a["signal"] for a in acts)
        throttled = [a for a in acts if a["action"] == "throttle"]
        assert throttled
        assert all(set(a["tenants"]) == {"t0"} for a in throttled)

        slo_u, fleet_u, oracle_u, _, _ = _run_flash_crowd(
            controlled=False)
        assert not slo_u["healthy"], "uncontrolled twin must breach"
        assert fleet_u == oracle_u   # parity holds while breaching

    def test_tenant_ramp_controlled_vs_uncontrolled(self):
        """Onboarding ramp: each arriving tenant bursts; the controller
        throttles the arrival spike so the shared queue never saturates
        and nobody gets a hard reject."""
        for controlled in (True, False):
            rng = np.random.default_rng(23)
            cfg = _cfg(queue_size=64, policy="reject",
                       flush_timeout_s=0.001, max_batch=8)
            admitted = {}
            with MultiTenantEngine(cfg, TenancyConfig(
                    max_tenants=128, tenant_quota=4096)) as eng:
                mon = SloMonitor(SAT_SPEC, registry=eng.metrics,
                                 flight=eng.flight,
                                 context=dataclasses.asdict(cfg))
                if controlled:
                    FleetController(
                        eng, dict(FAST_CTL, knobs=["shed", "flush"],
                                  throttle_s=0.05)).attach(mon)
                for arrival in range(8):
                    ws = rng.standard_normal(30_000).astype(np.float32)
                    wl = rng.random(30_000) < 0.5
                    wedge = eng.insert("base", ws, wl)
                    admitted.setdefault("base", []).append((ws, wl))
                    # the batcher claims the wedge alone before the burst
                    time.sleep(0.005)
                    tid = f"new{arrival}"
                    for i in range(60):
                        s = rng.standard_normal(1).astype(np.float32)
                        lab = rng.random(1) < 0.5
                        try:
                            eng.insert(tid, s, lab)
                            admitted.setdefault(tid, []).append((s, lab))
                        except TenantThrottledError:
                            pass
                        except BackpressureError:
                            pass    # the uncontrolled twin's rejects
                        if (i + 1) % 10 == 0:
                            _observe(mon, eng, time.perf_counter())
                    wedge.result(60.0)
                    eng.flush()
                    _observe(mon, eng, time.perf_counter())
                    time.sleep(0.06)
                slo = mon.report()
                m = eng.metrics.snapshot()
                wins = {t: eng.fleet.wins2(t) for t in eng.fleet.tenants()}
            assert wins == {tid: _jax_wins2(b)
                            for tid, b in admitted.items()}
            if controlled:
                assert slo["healthy"], slo
                assert m["rejected_total"]["value"] == 0
                assert m["tenant_throttled_total"]["value"] > 0
            else:
                assert not slo["healthy"], "uncontrolled ramp must breach"

    def test_device_loss_heals_then_controller_regrows(self):
        """A worker lost at S = 2: the fleet heals (shrinks), then the
        controller grows the mesh back under pressure; wins2 stays equal
        to the JAX index's throughout."""
        chaos = {"faults": [{"point": "sharded_count", "on_call": 3,
                             "action": "error", "dropped": [1]}]}
        slo, fleet_wins, oracle_wins, m, flight = _run_flash_crowd(
            controlled=True, tenants=8, rounds=4, shards=2,
            chaos=chaos, mesh_knob=True)
        assert slo["healthy"], slo
        assert fleet_wins == oracle_wins
        kinds = [e["kind"] for e in flight]
        assert "heal" in kinds
        grows = [e for e in flight if e["kind"] == "actuation"
                 and e["knob"] == "mesh" and e["action"] == "grow"]
        assert grows and all(a["signal"] for a in grows)
        assert m["mesh_width"]["value"] > 1


# --------------------------------------------------------------------- #
# doctor attribution                                                     #
# --------------------------------------------------------------------- #

class TestDoctorActuations:
    def _artifacts(self, tmp_path, events, rows_after=True):
        fr = FlightRecorder()
        for kind, fields in events:
            fr.record(kind, **fields)
        fpath = str(tmp_path / "flight.jsonl")
        fr.dump_to(fpath)
        mpath = str(tmp_path / "metrics.jsonl")
        ts = time.perf_counter() + (100.0 if rows_after else -100.0)
        with open(mpath, "w") as f:
            for i in range(2):
                f.write(json.dumps({
                    "seq": i + 1, "ts_wall": time.time(),
                    "ts_mono": ts + i, "metrics": {}}) + "\n")
        return mpath, fpath

    @staticmethod
    def _both(mp, fp):
        rep = diagnose(metrics_path=mp, flight_path=fp)
        want = jax_diagnose(metrics_path=mp, flight_path=fp)
        assert json.dumps(rep, sort_keys=True) == json.dumps(
            want, sort_keys=True)
        return rep

    def test_attributed_actuations_keep_verdict(self, tmp_path):
        mp, fp = self._artifacts(tmp_path, [
            ("actuation", dict(knob="shed", action="throttle",
                               signal={"objective": "queue_sat",
                                       "value": 0.7,
                                       "threshold": 0.8})),
            ("actuation", dict(knob="flush", action="widen",
                               signal={"objective": "queue_sat",
                                       "value": 0.75,
                                       "threshold": 0.8})),
        ])
        rep = self._both(mp, fp)
        assert rep["actuations"]["total"] == 2
        assert rep["actuations"]["attributed"] == 2
        assert rep["verdict"] == "healthy"
        assert rep["verdict_line"]["actuations_attributed"] == 2

    def test_missing_signal_downgrades(self, tmp_path):
        mp, fp = self._artifacts(tmp_path, [
            ("actuation", dict(knob="shed", action="throttle",
                               signal=None)),
        ])
        rep = self._both(mp, fp)
        assert rep["actuations"]["unattributed"] == 1
        assert rep["verdict"].startswith("degraded")
        assert "unattributed_actuation" in rep["verdict"]
        assert not rep["verdict_line"]["healthy"]

    def test_missing_effect_window_downgrades(self, tmp_path):
        mp, fp = self._artifacts(tmp_path, [
            ("actuation", dict(knob="mesh", action="grow",
                               signal={"objective": "x", "value": 1,
                                       "threshold": 2})),
        ], rows_after=False)
        rep = self._both(mp, fp)
        assert rep["actuations"]["unattributed"] == 1
        assert "unattributed_actuation" in rep["verdict"]

    def test_no_controller_no_actuation_block(self, tmp_path):
        mp, fp = self._artifacts(tmp_path, [
            ("compaction", dict(tier="minor")),
        ])
        rep = self._both(mp, fp)
        assert "actuations" not in rep
        assert rep["verdict_line"]["actuations"] == 0


# --------------------------------------------------------------------- #
# replay integration                                                     #
# --------------------------------------------------------------------- #

class TestReplayIntegration:
    def test_replay_fleet_with_controller(self):
        scores, labels, tenants = make_tenant_stream(
            1500, 8, skew=1.2, seed=3)
        rec = replay_fleet(
            scores, labels, tenants, chunk=8, max_inflight=64,
            config=_cfg(flush_timeout_s=0.001),
            tenancy=TenancyConfig(max_tenants=16, tenant_quota=4096),
            slo_spec=SAT_SPEC,
            controller_spec={"knobs": ["shed", "flush"]})
        assert "controller" in rec
        assert rec["controller"]["enabled"]
        assert set(rec["controller"]["knobs"]) == {"shed", "flush"}
        assert "events_tenant_throttled" in rec
        assert "tenant_throttled_total" in rec["admission"]
        assert rec["report"]["controller"]["actuations_total"] >= 0
        assert rec["tenant_auc_max_abs_err"] < 1e-6

    def test_replay_with_controller_and_keys_without(self):
        scores, labels = make_stream(600, seed=2)
        rec = replay(scores, labels, config=_cfg(), slo_spec=SAT_SPEC,
                     controller_spec={"knobs": ["flush"]})
        assert rec["controller"]["knobs"] == {
            "flush": {"level": 0, "used": 0, "budget": 16}}
        assert "controller" in rec["report"]
        plain = replay(scores, labels, config=_cfg(), slo_spec=SAT_SPEC)
        # a run without a controller keeps its exact key set
        assert "controller" not in plain and \
            "controller" not in plain["report"]
        assert set(rec) - set(plain) == {"controller"}
        assert rec["auc_exact"] == plain["auc_exact"]

    def test_controller_needs_slo(self):
        scores, labels, tenants = make_tenant_stream(50, 2, seed=0)
        with pytest.raises(ValueError, match="needs slo_spec"):
            replay_fleet(scores, labels, tenants, config=_cfg(),
                         controller_spec={})
        s, lab = make_stream(50)
        with pytest.raises(ValueError, match="needs slo_spec"):
            replay(s, lab, config=_cfg(), controller_spec={})


# --------------------------------------------------------------------- #
# the actuator hook, and on_signals parity with the JAX package          #
# --------------------------------------------------------------------- #

class _StubFleet:
    def __init__(self, rng, shards):
        self.rng = rng
        self.shards = shards
        self._healer = (None if shards is None
                        else type("H", (), {"_pool": list(range(8))})())
        self.n_tenants = 12
        self.whale_threshold = 500
        self.whales = set()

    def is_whale(self, tid):
        return tid in self.whales

    def tenant_state(self, tid):
        return {"tenant": tid, "n_events": int(self.rng.integers(0, 600))}

    def promote(self, tid):
        ok = bool(self.rng.random() < 0.8)
        if ok:
            self.whales.add(tid)
        return ok

    def resize_shards(self, shards):
        ok = bool(self.rng.random() < 0.7) and shards != self.shards
        if ok:
            self.shards = shards
        return ok


class _StubEngine:
    """Records every call the controller makes; answers from a seeded
    generator, so two stubs of one seed answer alike."""

    @dataclasses.dataclass(frozen=True)
    class Config:
        flush_timeout_s: float = 0.002
        max_batch: int = 64

    def __init__(self, seed, registry, flight, shards=2):
        self.rng = np.random.default_rng(seed)
        self.calls = []
        self.config = self.Config()
        self.metrics = registry
        self.flight = flight
        self.fleet = _StubFleet(np.random.default_rng(seed + 1), shards)
        self.tenancy = type("T", (), {"weight": 4})()
        self._throttled = set()

    def throttle_tenant(self, tid, retry_after_s=0.5):
        self.calls.append(("throttle_tenant", tid, retry_after_s))
        self._throttled.add(tid)

    def clear_throttles(self, tid=None):
        n = len(self._throttled)
        self._throttled.clear()
        self.calls.append(("clear_throttles", n))
        return n

    def throttled_tenants(self):
        return sorted(self._throttled)

    def set_tenant_weight(self, tid, weight):
        self.calls.append(("set_tenant_weight", tid, weight))

    def pending_by_tenant(self):
        n = int(self.rng.integers(0, 8))
        return {f"t{k}": int(self.rng.integers(0, 12)) for k in range(n)}


def _signals(rng, n, tenants=10):
    """A random schedule of SloMonitor signal bundles: objectives of every
    type near and across their thresholds, tenant-labeled insert p99s
    and event counters."""
    out, t, events = [], 0.0, np.zeros(tenants)
    for _ in range(n):
        t += float(rng.choice([0.01, 0.1, 0.3]))
        events += rng.integers(0, 400, size=tenants)
        metrics = {}
        for k in range(tenants):
            metrics[f"insert_latency_s{{tenant=t{k}}}"] = {
                "type": "histogram", "count": int(events[k]),
                "p99": float(rng.choice([0.01, 0.02, 0.3]))}
            metrics[f"tenant_events_total{{tenant=t{k}}}"] = {
                "type": "counter", "value": int(events[k])}
        sat = float(rng.random())
        lat = float(rng.choice([5.0, 30.0, 60.0]))
        burn = float(rng.choice([0.0, 0.3, 2.0]))
        out.append({"ts_mono": t, "metrics": metrics, "transitions": [],
                    "objectives": {
                        "sat": {"type": "saturation", "value": sat,
                                "max_fraction": 0.8,
                                "breached_now": sat > 0.8},
                        "lat": {"type": "latency", "value": lat,
                                "threshold_ms": 50.0,
                                "breached_now": lat > 50.0},
                        "avail": {"type": "error_rate", "value": burn,
                                  "breached_now": burn > 1.5},
                        "cap": {"type": "counter_max",
                                "value": int(rng.integers(0, 2)),
                                "max": 0,
                                "breached_now": bool(rng.random() < 0.1)},
                    }})
    return out


def _actuations(flight):
    return [{k: v for k, v in e.items()
             if k not in ("seq", "t_wall", "t_mono", "trace_id")}
            for e in flight.events("actuation")]


class TestActuatorHook:
    def test_actuator_receives_objective_state(self):
        seen = []
        mon = SloMonitor(SAT_SPEC, context={"queue_size": 100},
                         actuators=[seen.append])
        mon.observe({"queue_depth_live": {"value": 90}}, 1.0)
        assert len(seen) == 1
        sig = seen[0]
        assert sig["ts_mono"] == 1.0
        assert sig["objectives"]["queue_sat"]["breached_now"]
        assert sig["objectives"]["queue_sat"]["value"] == 0.9

    def test_actuator_errors_are_swallowed_and_counted(self):
        def boom(sig):
            raise RuntimeError("actuator bug")

        mon = SloMonitor(SAT_SPEC, context={"queue_size": 100})
        mon.add_actuator(boom)
        mon.observe({}, 1.0)    # must not raise
        assert mon.actuator_errors == 1
        assert "actuator bug" in mon.last_actuator_error

    @pytest.mark.parametrize("seed,shards,spec", [
        (0, 2, {"cooldown_s": 0.05, "up_ticks": 1, "down_ticks": 2,
                "mesh_up_ticks": 1, "mesh_down_ticks": 3}),
        (1, None, {"cooldown_s": 0.0, "up_ticks": 2, "down_ticks": 3,
                   "slow_factor": 2.0}),
        (2, 1, {"cooldown_s": 0.2, "mesh_max_shards": 4,
                "mesh_up_ticks": 2, "promote_lookahead_s": 0.5}),
        (3, 2, {}),
    ])
    def test_on_signals_calls_and_events_equal_the_jax_package(
            self, seed, shards, spec):
        bundles = _signals(np.random.default_rng(100 + seed), 200)
        runs = []
        for Controller, Registry, Flight in (
                (FleetController, MetricsRegistry, FlightRecorder),
                (JaxController, JaxRegistry, JaxFlight)):
            eng = _StubEngine(seed, Registry(), Flight(), shards=shards)
            ctl = Controller(eng, spec)
            for sig in bundles:
                ctl.on_signals(sig)
            runs.append((eng.calls, _actuations(eng.flight), ctl.state(),
                         eng.config, eng.metrics.snapshot()))
        ours, theirs = runs
        assert ours[0] == theirs[0] and ours[0], "no engine call made"
        assert ours[1] == theirs[1] and ours[1], "no actuation made"
        assert ours[2] == theirs[2]
        assert ours[3] == theirs[3]
        assert ({k: v for k, v in ours[4].items() if "controller" in k}
                == {k: v for k, v in theirs[4].items() if "controller" in k})


class TestBlockPolicy:
    def test_blocked_submit_outlives_a_retired_tenant_queue(self):
        """A submitter blocked on a full fleet queue appends to its
        tenant's live queue, even when the batcher drained and retired
        that queue meanwhile (``ROADMAP.md`` Queue 3): every
        request resolves. The JAX engine appends to the retired deque
        and its replay then times out."""
        scores, labels, tenants = make_tenant_stream(2500, 12, seed=0)
        rec = replay_fleet(
            scores, labels, tenants, chunk=4,
            config=_cfg(policy="block", queue_size=16,
                        flush_timeout_s=0.001),
            tenancy=TenancyConfig(tenant_quota=4096))
        assert rec["events_applied"] == 2500
        assert rec["requests_dropped"] == 0
        assert rec["tenant_auc_max_abs_err"] < 1e-6
