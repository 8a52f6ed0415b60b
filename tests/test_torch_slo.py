"""The port's SLO engine on the JAX package's cases (``tests/test_slo.py``;
the doctor's default spec is held in test_torch_doctor.py): spec
parsing, objective evaluation, multi-window burn rates, breach
transitions (flight events and gauges), label wildcards, reports."""

import json

import pytest

from tuplewise_tpu_torch.obs.flight import FlightRecorder
from tuplewise_tpu_torch.obs.slo import (
    SloMonitor, SloSpec, SloSpecError, evaluate_history,
)
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry


def _m(counters=None, hists=None, gauges=None):
    """A snapshot-shaped metrics dict from plain numbers."""
    out = {}
    for k, v in (counters or {}).items():
        out[k] = {"type": "counter", "value": v}
    for k, v in (gauges or {}).items():
        out[k] = {"type": "gauge", "value": v}
    for k, q in (hists or {}).items():
        out[k] = dict({"type": "histogram", "count": 1}, **q)
    return out


LAT = {"objectives": [
    {"name": "p99", "type": "latency", "metric": "insert_latency_s",
     "quantile": "p99", "threshold_ms": 10.0}]}


class TestSpecParsing:
    def test_dict_json_and_file_forms(self, tmp_path):
        spec = SloSpec.from_spec(LAT)
        assert spec.objectives[0].name == "p99"
        spec = SloSpec.from_spec(json.dumps(LAT))
        assert spec.objectives[0].threshold_ms == 10.0
        p = tmp_path / "slo.json"
        p.write_text(json.dumps(LAT))
        assert SloSpec.from_spec(str(p)).objectives[0].name == "p99"
        assert SloSpec.from_spec(f"@{p}").objectives[0].name == "p99"

    def test_idempotent_on_parsed_spec(self):
        spec = SloSpec.from_spec(LAT)
        assert SloSpec.from_spec(spec) is spec

    @pytest.mark.parametrize("bad", [
        {"objectives": []},
        {"objectives": [{"name": "x", "type": "nope"}]},
        {"objectives": [{"type": "latency", "metric": "m",
                         "threshold_ms": 1}]},          # no name
        {"objectives": [{"name": "x", "type": "latency",
                         "metric": "m"}]},              # no threshold
        {"objectives": [{"name": "x", "type": "latency", "metric": "m",
                         "threshold_ms": 1, "quantile": "p42"}]},
        {"objectives": [{"name": "x", "type": "error_rate",
                         "errors": ["e"], "total": "t"}]},  # no objective
        {"objectives": [{"name": "x", "type": "error_rate",
                         "errors": ["e"], "total": "t",
                         "objective": 0.99,
                         "windows": [{"window_s": 0, "burn": 1}]}]},
        {"objectives": [{"name": "x", "type": "counter_max"}]},
        {"objectives": [{"name": "x", "type": "saturation",
                         "metric": "g"}]},              # no capacity
        {"objectives": [LAT["objectives"][0], LAT["objectives"][0]]},
    ])
    def test_invalid_specs_raise(self, bad):
        with pytest.raises(SloSpecError):
            SloSpec.from_spec(bad)

    def test_window_extents(self):
        spec = SloSpec.from_spec({"objectives": [
            {"name": "a", "type": "error_rate", "errors": ["e"],
             "total": "t", "objective": 0.9,
             "windows": [{"window_s": 2, "burn": 5},
                         {"window_s": 30, "burn": 1}]}]})
        assert spec.longest_window_s == 30
        assert spec.shortest_window_s == 2


class TestLatencyObjective:
    def test_breach_transition_and_recovery(self):
        reg = MetricsRegistry()
        fl = FlightRecorder()
        mon = SloMonitor(LAT, registry=reg, flight=fl)
        assert mon.observe(_m(hists={"insert_latency_s": {"p99": 0.005}}),
                           0.0) == []
        tr = mon.observe(_m(hists={"insert_latency_s": {"p99": 0.050}}),
                         1.0)
        assert len(tr) == 1 and tr[0]["objective"] == "p99"
        # staying breached is NOT a new transition
        assert mon.observe(
            _m(hists={"insert_latency_s": {"p99": 0.060}}), 2.0) == []
        assert mon.observe(
            _m(hists={"insert_latency_s": {"p99": 0.002}}), 3.0) == []
        # exactly one flight event, gauges track live state
        assert len(fl.events("slo_breach")) == 1
        snap = reg.snapshot()
        assert snap["slo_breached{objective=p99}"]["value"] == 0.0
        assert snap["slo_breaches_total{objective=p99}"]["value"] == 1
        rep = mon.report()
        assert rep["breached_ever"] and not rep["breached_now"]
        assert not rep["healthy"]
        assert rep["objectives"]["p99"]["breaches_total"] == 1

    def test_missing_metric_is_not_a_breach(self):
        mon = SloMonitor(LAT)
        assert mon.observe(_m(), 0.0) == []
        assert mon.report()["healthy"]


ERR = {"objectives": [
    {"name": "avail", "type": "error_rate",
     "errors": ["rejected_total", "dropped_total"],
     "total": "requests_insert_total", "objective": 0.9,
     "windows": [{"window_s": 10, "burn": 2.0},
                 {"window_s": 60, "burn": 1.0}]}]}


def _err_snap(total, errs):
    return _m(counters={"requests_insert_total": total,
                        "rejected_total": errs, "dropped_total": 0})


class TestErrorRateBurn:
    def test_all_windows_must_exceed(self):
        mon = SloMonitor(ERR)
        # budget = 0.1. A fast burn confined to the short window: long
        # window rate stays low -> no breach (multi-window AND)
        mon.observe(_err_snap(0, 0), 0.0)
        for i in range(1, 7):
            mon.observe(_err_snap(i * 1000, 0), i * 10.0)
        # short window: 50% errors (burn 5 > 2); long window includes
        # 6000 clean requests -> rate 500/7000 ~ 0.071, burn 0.71 < 1
        tr = mon.observe(_err_snap(7000, 500), 70.0)
        assert tr == []
        assert not mon.report()["breached_ever"]

    def test_sustained_burn_breaches(self):
        mon = SloMonitor(ERR)
        mon.observe(_err_snap(0, 0), 0.0)
        fired = []
        # 30% error rate sustained across both windows (burn 3 > both)
        for i in range(1, 9):
            fired += mon.observe(_err_snap(i * 1000, i * 300), i * 10.0)
        assert len(fired) == 1
        rep = mon.report()["objectives"]["avail"]
        assert rep["breaches_total"] == 1
        wins = rep["last"]["windows"]
        assert set(wins) == {"10s", "60s"}
        assert wins["60s"]["burn_rate"] == pytest.approx(3.0)

    def test_zero_traffic_is_healthy(self):
        mon = SloMonitor(ERR)
        for i in range(8):
            assert mon.observe(_err_snap(0, 0), i * 10.0) == []

    def test_short_history_uses_oldest_snapshot(self):
        # with only 2 snapshots, both windows difference against the
        # first — a conservative shorter window, never a crash
        mon = SloMonitor(ERR)
        mon.observe(_err_snap(0, 0), 0.0)
        tr = mon.observe(_err_snap(100, 50), 1.0)
        assert len(tr) == 1      # 50% errors, burn 5 in both windows


class TestCounterAndSaturation:
    def test_counter_max(self):
        spec = {"objectives": [{"name": "heal", "type": "counter_max",
                                "metric": "heal_exhausted_total"}]}
        mon = SloMonitor(spec)
        assert mon.observe(_m(counters={"heal_exhausted_total": 0}),
                           0.0) == []
        tr = mon.observe(_m(counters={"heal_exhausted_total": 1}), 1.0)
        assert len(tr) == 1
        # a cumulative counter cannot recover
        assert mon.report()["breached_now"]

    def test_saturation_with_symbolic_capacity(self):
        spec = {"objectives": [{"name": "q", "type": "saturation",
                                "metric": "queue_depth_live",
                                "capacity": "queue_size",
                                "max_fraction": 0.9}]}
        mon = SloMonitor(spec, context={"queue_size": 100})
        assert mon.observe(_m(gauges={"queue_depth_live": 80}),
                           0.0) == []
        assert len(mon.observe(_m(gauges={"queue_depth_live": 95}),
                               1.0)) == 1
        assert mon.observe(_m(gauges={"queue_depth_live": 10}),
                           2.0) == []
        assert not mon.report()["breached_now"]

    def test_unresolved_capacity_never_breaches(self):
        spec = {"objectives": [{"name": "q", "type": "saturation",
                                "metric": "queue_depth_live",
                                "capacity": "nope"}]}
        mon = SloMonitor(spec)
        assert mon.observe(_m(gauges={"queue_depth_live": 1e9}),
                           0.0) == []


class TestHistory:
    def test_evaluate_history_rows(self):
        rows = [{"ts_mono": float(i),
                 "metrics": _err_snap(i * 100, i * 30)}
                for i in range(10)]
        rep = evaluate_history(ERR, rows)
        assert rep["evaluations"] == 10
        assert rep["breached_ever"]


class TestLabelWildcards:
    """ ``metric{label=*}`` objectives fan out over
    every matching labeled series — one spec line covers a fleet."""

    def _tenant_registry(self):
        reg = MetricsRegistry()
        for t, lat in (("a", 0.001), ("b", 0.2), ("c", 0.003)):
            h = reg.histogram("insert_latency_s", labels={"tenant": t})
            for _ in range(8):
                h.observe(lat)
        return reg

    def test_latency_wildcard_breaches_on_any_series(self):
        reg = self._tenant_registry()
        mon = SloMonitor({"objectives": [
            {"name": "tp99", "type": "latency",
             "metric": "insert_latency_s{tenant=*}",
             "quantile": "p99", "threshold_ms": 50}]}, registry=reg)
        transitions = mon.observe(reg.snapshot(), 1.0)
        assert len(transitions) == 1
        rep = mon.report()
        series = rep["objectives"]["tp99"]["last"]["series"]
        assert series["tenant=b"]["breached"]
        assert not series["tenant=a"]["breached"]
        assert rep["objectives"]["tp99"]["last"]["series_breached"] == 1

    def test_per_series_breach_gauges_exported(self):
        reg = self._tenant_registry()
        mon = SloMonitor({"objectives": [
            {"name": "tp99", "type": "latency",
             "metric": "insert_latency_s{tenant=*}",
             "quantile": "p99", "threshold_ms": 50}]}, registry=reg)
        mon.observe(reg.snapshot(), 1.0)
        snap = reg.snapshot()
        assert snap["slo_breached{objective=tp99,tenant=b}"][
            "value"] == 1.0
        assert snap["slo_breached{objective=tp99,tenant=a}"][
            "value"] == 0.0
        assert snap["slo_breached{objective=tp99}"]["value"] == 1.0

    def test_counter_max_wildcard(self):
        m = _m(counters={"tenant_rejected_total{tenant=x}": 0,
                         "tenant_rejected_total{tenant=y}": 3})
        mon = SloMonitor({"objectives": [
            {"name": "rej", "type": "counter_max",
             "metric": "tenant_rejected_total{tenant=*}", "max": 0}]})
        mon.observe(m, 0.0)
        last = mon.report()["objectives"]["rej"]["last"]
        assert last["series"]["tenant=y"]["breached"]
        assert not last["series"]["tenant=x"]["breached"]

    def test_wildcard_no_matches_is_healthy(self):
        mon = SloMonitor({"objectives": [
            {"name": "tp99", "type": "latency",
             "metric": "insert_latency_s{tenant=*}",
             "quantile": "p99", "threshold_ms": 50}]})
        assert mon.observe(_m(), 0.0) == []
        assert mon.report()["healthy"]

    def test_error_rate_wildcard_sums_series(self):
        def snap(err_x, err_y, total):
            return _m(counters={
                "tenant_rejected_total{tenant=x}": err_x,
                "tenant_rejected_total{tenant=y}": err_y,
                "requests_insert_total": total})
        spec = {"objectives": [
            {"name": "avail", "type": "error_rate",
             "errors": ["tenant_rejected_total{tenant=*}"],
             "total": "requests_insert_total", "objective": 0.9,
             "windows": [{"window_s": 1.0, "burn": 1.0}]}]}
        mon = SloMonitor(spec)
        mon.observe(snap(0, 0, 100), 0.0)
        mon.observe(snap(30, 30, 200), 2.0)   # 60 errors / 100 events
        rep = mon.report()
        assert rep["objectives"]["avail"]["breaches_total"] == 1

    def test_match_series_exact_labels_respected(self):
        from tuplewise_tpu_torch.obs.slo import match_series

        m = _m(counters={"c{region=eu,tenant=a}": 1,
                         "c{region=us,tenant=b}": 2, "c": 3})
        got = match_series(m, "c{region=eu,tenant=*}")
        assert len(got) == 1
        assert got[0][0] == {"tenant": "a"}


SAT_SPEC = {"objectives": [{"name": "queue_sat", "type": "saturation",
                            "metric": "queue_depth_live",
                            "capacity": "queue_size",
                            "max_fraction": 0.8}]}


class TestActuatorHook:
    """The actuator hook a control plane rides (the mirror of
    ``tests/test_control.py::TestActuatorHook``; the controller on it is
    held in test_torch_control.py)."""

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
