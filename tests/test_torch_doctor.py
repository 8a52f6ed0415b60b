"""The port's doctor (``obs/doctor.py``) against the JAX package's, on one
set of artifacts written by the port: a chaos replay (every injected
fault correlated once, the verdict ``recovered``), a clean replay, a
fleet replay under the controller, the degraded paths and the host-tax
verdicts. On each, ``diagnose``, ``verdict_line`` and
``tenant_breakdown`` of both packages return equal JSON, and so do the
CLI's last line and exit code. Mirrors tests/test_doctor.py of the JAX
package (and test_slo.py's default-spec case)."""

import contextlib
import io
import json
import os

import pytest

from tuplewise_tpu.harness.cli import main as jax_cli
from tuplewise_tpu.obs import doctor as jd
from tuplewise_tpu.obs.slo import DEFAULT_DOCTOR_SPEC as JAX_DEFAULT_SPEC
from tuplewise_tpu_torch.harness.cli import main as cli
from tuplewise_tpu_torch.obs.doctor import (
    correlate_actuations, correlate_faults, diagnose, load_metrics_rows,
    load_spans, tenant_breakdown, top_self_spans, verdict_line,
)
from tuplewise_tpu_torch.obs.slo import DEFAULT_DOCTOR_SPEC, evaluate_history

CHAOS = {"faults": [
    {"point": "compactor_build", "on_call": 1, "action": "error"},
    {"point": "batcher", "on_call": 3, "action": "error"},
    {"point": "poison", "at_events": [150, 900], "value": "nan"},
]}

FLEET_SLO = {"objectives": [
    {"name": "queue_sat", "type": "saturation",
     "metric": "queue_depth_live", "capacity": "queue_size",
     "max_fraction": 0.8},
    {"name": "tenant_p99", "type": "latency",
     "metric": "insert_latency_s{tenant=*}", "quantile": "p99",
     "threshold_ms": 1000},
]}


def _same(got, want):
    assert json.dumps(got, sort_keys=True) == json.dumps(
        want, sort_keys=True)


def _both(**kw):
    """The port's diagnose, held equal to the JAX package's."""
    rep = diagnose(**kw)
    _same(rep, jd.diagnose(**kw))
    return rep


@pytest.fixture(scope="module")
def chaos_run(tmp_path_factory):
    """One chaos-injected replay of the port, its artifacts on disk."""
    d = str(tmp_path_factory.mktemp("chaos_run"))
    from tuplewise_tpu_torch.obs.tracing import Tracer
    from tuplewise_tpu_torch.serving import ServingConfig
    from tuplewise_tpu_torch.serving.replay import make_stream, replay

    scores, labels = make_stream(3000, pos_frac=0.5, separation=1.0,
                                 seed=0)
    cfg = ServingConfig(device="cpu", policy="block", compact_every=256,
                        bg_compact=True)
    tracer = Tracer(capacity=1 << 16)
    rec = replay(scores, labels, config=cfg, max_inflight=256,
                 chaos=CHAOS, tracer=tracer,
                 metrics_out=os.path.join(d, "metrics.jsonl"),
                 metrics_every_s=0.1,
                 flight_out=os.path.join(d, "flight.jsonl"))
    tracer.export_jsonl(os.path.join(d, "spans.jsonl"))
    return d, rec


@pytest.fixture(scope="module")
def clean_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("clean_run"))
    from tuplewise_tpu_torch.serving import ServingConfig
    from tuplewise_tpu_torch.serving.replay import make_stream, replay

    scores, labels = make_stream(1200, seed=1)
    cfg = ServingConfig(device="cpu", policy="block", compact_every=512)
    replay(scores, labels, config=cfg, max_inflight=128,
           metrics_out=os.path.join(d, "metrics.jsonl"),
           metrics_every_s=0.1,
           flight_out=os.path.join(d, "flight.jsonl"))
    return d


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """The port's CLI replay of a fleet under the controller, its
    artifacts in one directory."""
    d = str(tmp_path_factory.mktemp("fleet_run"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(["replay", "--device", "cpu", "--tenants", "12",
                  "--n-events", "2500", "--chunk", "4", "--policy",
                  "block", "--queue-size", "64", "--flush-timeout-ms",
                  "1", "--tenant-quota", "4096",
                  "--slo-spec", json.dumps(FLEET_SLO),
                  "--controller-spec", json.dumps(
                      {"cooldown_s": 0.0, "up_ticks": 1}),
                  "--metrics-out", os.path.join(d, "metrics.jsonl"),
                  "--metrics-every", "0.05",
                  "--flight-out", os.path.join(d, "flight.jsonl")])
    assert rc == 0
    return d, json.loads(buf.getvalue().strip().splitlines()[-1])


class TestChaosDiagnosis:
    def test_every_injected_fault_exactly_once_correlated(self,
                                                          chaos_run):
        d, _ = chaos_run
        rep = _both(run_dir=d)
        faults = rep["faults"]
        # the schedule injects 2 faults + 2 poison events -> 4 entries
        assert len(faults) == 4
        by_point = {}
        for f in faults:
            by_point.setdefault(f["point"], []).append(f)
        assert sorted(by_point) == ["batcher", "compactor_build",
                                    "poison"]
        assert {f["at_event"] for f in by_point["poison"]} == {150, 900}
        for f in faults:
            assert f["resolved"], f
        assert by_point["batcher"][0]["resolution"] == "batcher_restart"
        assert by_point["compactor_build"][0]["resolution"] in (
            "compaction_resumed", "compactor_restarted")
        # the compactor fault's trace id resolves to the build span
        assert by_point["compactor_build"][0]["trace_span"] == \
            "compactor.build"
        for f in by_point["poison"]:
            assert f["resolution"] == "poison_rejected"

    def test_verdict_recovered_and_machine_line(self, chaos_run):
        d, _ = chaos_run
        rep = _both(run_dir=d)
        assert rep["verdict"] == "recovered"
        line = rep["verdict_line"]
        _same(line, jd.verdict_line(rep))
        assert line["healthy"] is True
        assert line["doctor_verdict"] == "recovered"
        assert line["faults"] == line["faults_resolved"] == 4

    def test_report_carries_slo_health_spans_counters(self, chaos_run):
        d, _ = chaos_run
        rep = _both(run_dir=d)
        assert rep["slo"] is not None and rep["slo"]["healthy"]
        assert rep["health"]["estimate_ci_width"] is not None
        names = {s["name"] for s in rep["top_self_spans"]}
        assert any(n.startswith("insert.") for n in names)
        assert "recovery_counters" in rep
        assert rep["run"]["events_total"] > 0
        assert rep["run"]["config_digest"]
        # the port counts no kernel fallback
        assert rep.get("kernel", {}).get("count_kernel_fallbacks", 0) == 0

    def test_explicit_paths_override_dir_probe(self, chaos_run):
        d, _ = chaos_run
        rep = _both(metrics_path=os.path.join(d, "metrics.jsonl"),
                    flight_path=os.path.join(d, "flight.jsonl"))
        assert rep["verdict"] == "recovered"
        assert rep["top_self_spans"] == []

    def test_loaders_equal_the_jax_package(self, chaos_run):
        d, _ = chaos_run
        m, s = os.path.join(d, "metrics.jsonl"), os.path.join(d, "spans.jsonl")
        _same(load_metrics_rows(m), jd.load_metrics_rows(m))
        _same(load_spans(s), jd.load_spans(s))
        _same(top_self_spans(load_spans(s), 7),
              jd.top_self_spans(jd.load_spans(s), 7))


class TestCleanDiagnosis:
    def test_clean_run_is_healthy(self, clean_run):
        rep = _both(run_dir=clean_run)
        assert rep["verdict"] == "healthy"
        assert rep["faults"] == []
        assert rep["verdict_line"]["healthy"] is True
        assert "tenants" not in rep


class TestFleetDiagnosis:
    def test_tenant_breakdown_and_actuations(self, fleet_run):
        d, rec = fleet_run
        rows = load_metrics_rows(os.path.join(d, "metrics.jsonl"))
        tb = tenant_breakdown(rows)
        _same(tb, jd.tenant_breakdown(rows))
        assert tb and all("insert_p99_ms" in v for v in tb.values())
        rep = _both(run_dir=d)
        assert rep["tenants"] == tb
        assert rec["controller"]["enabled"]
        acts = rep.get("actuations")
        if acts is not None:
            assert acts["total"] == rec["controller"]["actuations_total"]
        flight = json.loads(open(os.path.join(d, "flight.jsonl")).readline())
        assert flight["format"] == "tuplewise-flight-v1"


class TestDegradedPaths:
    def _artifacts(self, tmp_path, flight_events, metrics_rows=None):
        fdump = tmp_path / "flight.jsonl"
        with open(fdump, "w") as f:
            f.write(json.dumps({"format": "tuplewise-flight-v1",
                                "n_events": len(flight_events),
                                "dropped": 0}) + "\n")
            for e in flight_events:
                f.write(json.dumps(e) + "\n")
        if metrics_rows is not None:
            mpath = tmp_path / "metrics.jsonl"
            with open(mpath, "w") as f:
                for r in metrics_rows:
                    f.write(json.dumps(r) + "\n")
        return str(tmp_path)

    def test_unresolved_fault_degrades(self, tmp_path):
        d = self._artifacts(tmp_path, [
            {"kind": "chaos_inject", "seq": 1, "t_wall": 0.0,
             "t_mono": 0.0, "trace_id": 7, "point": "batcher",
             "action": "error", "on_call": 1}])
        rep = _both(run_dir=d)
        assert rep["verdict"].startswith("degraded")
        assert "unresolved" in rep["verdict"]
        assert rep["verdict_line"]["healthy"] is False

    def test_heal_exhaustion_degrades(self, tmp_path):
        d = self._artifacts(tmp_path, [
            {"kind": "heal_exhausted", "seq": 1, "t_wall": 0.0,
             "t_mono": 0.0, "trace_id": None, "error": "x"}])
        rep = _both(run_dir=d)
        assert "heal_exhausted" in rep["verdict"]

    def test_slo_breach_in_history_degrades(self, tmp_path):
        rows = [{"seq": i + 1, "ts_wall": float(i), "ts_mono": float(i),
                 "platform": "cpu", "config_digest": "d",
                 "metrics": {
                     "requests_insert_total":
                         {"type": "counter", "value": 100 * (i + 1)},
                     "rejected_total":
                         {"type": "counter", "value": 60 * (i + 1)},
                 }} for i in range(12)]
        d = self._artifacts(tmp_path, [], metrics_rows=rows)
        rep = _both(run_dir=d)
        assert "slo_breached" in rep["verdict"]
        assert rep["verdict_line"]["slo_breaches"] > 0

    def test_torn_metrics_tail_tolerated(self, tmp_path):
        mpath = tmp_path / "metrics.jsonl"
        row = {"seq": 1, "ts_wall": 0.0, "ts_mono": 0.0, "metrics": {}}
        with open(mpath, "w") as f:
            f.write(json.dumps(row) + "\n")
            f.write('{"seq": 2, "ts_wall": 0.1, "truncat')
        assert load_metrics_rows(str(mpath)) == [row] == \
            jd.load_metrics_rows(str(mpath))

    def test_no_artifacts_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            diagnose(run_dir=str(tmp_path))


def _ht_metrics(compile_events=0, batches=100, gc_p99_s=0.0,
                gc_pauses=0, insert_p99_s=0.010, fallbacks=0,
                full_replaces=0):
    """A final-snapshot metrics dict with a self-consistent host-tax
    ledger (bucket sums tile insert_latency_s.sum exactly)."""
    measured = 2.0
    buckets = {"queue_wait": 0.5, "lock_wait": 0.1,
               "host_python": 1.0, "dispatch": 0.2,
               "device_compute": 0.1, "xla_compile": 0.05,
               "gc_pause": 0.05}
    m = {
        "host_tax_waves_total": {"type": "counter", "value": 50},
        "batches_total": {"type": "counter", "value": batches},
        "xla_compile_events_total": {"type": "counter",
                                     "value": compile_events},
        "gc_pauses_total": {"type": "counter", "value": gc_pauses},
        "gc_pause_s": {"type": "histogram", "count": gc_pauses,
                       "sum": gc_p99_s * gc_pauses, "p99": gc_p99_s},
        "tail_exemplars_total": {"type": "counter", "value": 0},
        "insert_latency_s": {"type": "histogram", "count": 100,
                             "sum": measured, "p99": insert_p99_s},
        "host_tax_host_fraction": {"type": "gauge", "value": 0.85},
        "host_tax_device_fraction": {"type": "gauge", "value": 0.10},
        "count_kernel_calls_total": {"type": "counter", "value": 10},
        "count_kernel_fallbacks_total": {"type": "counter",
                                         "value": fallbacks},
        "pack_replaces_total": {"type": "counter", "value": 0},
        "pack_full_replaces_total": {"type": "counter",
                                     "value": full_replaces},
    }
    for b, s in buckets.items():
        m[f"host_tax_{b}_s"] = {"type": "histogram", "count": 100,
                                "sum": s, "p99": s / 100}
    return m


def _rows(metrics, n=3):
    return [{"seq": i + 1, "ts_wall": float(i), "ts_mono": float(i),
             "platform": "cpu", "config_digest": "d",
             "metrics": metrics} for i in range(n)]


class TestHostTaxVerdicts:
    def _diagnose(self, tmp_path, metrics, context=None):
        mpath = tmp_path / "metrics.jsonl"
        with open(mpath, "w") as f:
            for r in _rows(metrics):
                f.write(json.dumps(r) + "\n")
        return _both(metrics_path=str(mpath), context=context)

    def test_healthy_run_carries_host_tax_block(self, tmp_path):
        rep = self._diagnose(tmp_path, _ht_metrics())
        assert rep["verdict"] == "healthy"
        ht = rep["host_tax"]
        assert ht["coverage"] == pytest.approx(1.0)
        assert ht["host_fraction"] == 0.85
        assert ht["compile_churn"] is False
        assert ht["gc_in_p99"] is False

    def test_compile_churn_degrades(self, tmp_path):
        rep = self._diagnose(tmp_path, _ht_metrics(compile_events=200))
        assert "compile_on_request_thread" in rep["verdict"]
        assert rep["host_tax"]["compile_churn"] is True
        assert rep["verdict_line"]["healthy"] is False

    def test_gc_in_p99_degrades(self, tmp_path):
        rep = self._diagnose(tmp_path, _ht_metrics(
            gc_p99_s=0.008, gc_pauses=40, insert_p99_s=0.010))
        assert "gc_in_p99" in rep["verdict"]
        assert rep["host_tax"]["gc_in_p99"] is True

    def test_rare_gc_does_not_degrade(self, tmp_path):
        rep = self._diagnose(tmp_path, _ht_metrics(
            gc_p99_s=0.008, gc_pauses=3, insert_p99_s=0.010))
        assert rep["verdict"] == "healthy"

    def test_kernel_fallback_counter_is_judged_as_the_reference(
            self, tmp_path):
        # the port never counts a fallback; an artifact that does is
        # judged degraded, as the reference judges it
        rep = self._diagnose(tmp_path, _ht_metrics(fallbacks=2,
                                                   full_replaces=5))
        assert "count_kernel_fallback" in rep["verdict"]
        assert rep["kernel"]["count_kernel_fallbacks"] == 2
        assert rep["kernel"]["pack_full_replaces"] == 5

    def test_pre_ledger_artifacts_omit_block(self, tmp_path):
        m = {"insert_latency_s": {"type": "histogram", "count": 10,
                                  "sum": 1.0, "p99": 0.01}}
        rep = self._diagnose(tmp_path, m)
        assert "host_tax" not in rep
        assert rep["verdict"] == "healthy"

    def test_context_overrides_thresholds(self, tmp_path):
        rep = self._diagnose(tmp_path, _ht_metrics(compile_events=50),
                             context={"compile_churn_per_1k_batches": 100.0})
        assert "compile_on_request_thread" in rep["verdict"]

    def test_delay_fault_resolves_as_latency_absorbed(self):
        evs = [{"kind": "chaos_inject", "seq": 1, "t_wall": 0.0,
                "point": "batcher", "action": "delay", "trace_id": 3},
               {"kind": "tail_exemplar", "seq": 2, "t_wall": 0.1,
                "trace_id": 4, "lat_ms": 80.0, "buckets": {}}]
        faults = correlate_faults(evs, [], [])
        _same(faults, jd.correlate_faults(evs, [], []))
        assert len(faults) == 1
        f = faults[0]
        assert f["resolved"] and f["resolution"] == "latency_absorbed"
        assert f["evidence"] == {"tail_exemplars": 1}


class TestUnits:
    def test_top_self_spans_subtracts_children(self):
        spans = [
            {"trace_id": 1, "span_id": 1, "parent_id": None,
             "name": "root", "t0_s": 0.0, "dur_s": 1.0},
            {"trace_id": 1, "span_id": 2, "parent_id": 1,
             "name": "child", "t0_s": 0.1, "dur_s": 0.7},
        ]
        top = top_self_spans(spans, 5)
        _same(top, jd.top_self_spans(spans, 5))
        by = {s["name"]: s for s in top}
        assert by["child"]["self_s"] == pytest.approx(0.7)
        assert by["root"]["self_s"] == pytest.approx(0.3)
        assert top[0]["name"] == "child"

    def test_correlate_ignores_unknown_points_gracefully(self):
        evs = [{"kind": "chaos_inject", "seq": 1, "t_wall": 0.0,
                "point": "train_step", "action": "error",
                "trace_id": None},
               {"kind": "heal", "seq": 2, "t_wall": 0.1,
                "trace_id": None, "mesh_width": 2}]
        faults = correlate_faults(evs, [], [])
        _same(faults, jd.correlate_faults(evs, [], []))
        assert len(faults) == 1
        assert faults[0]["resolved"] and faults[0]["resolution"] == \
            "healed"

    def test_correlate_actuations_grace_equals_the_jax_package(self):
        rows = [{"ts_mono": float(t), "metrics": {}} for t in (0, 1, 2)]
        evs = [{"kind": "actuation", "seq": i, "t_wall": 0.0,
                "t_mono": t, "knob": "shed", "action": "throttle",
                "signal": sig}
               for i, (t, sig) in enumerate([
                   (0.5, {"objective": "q", "value": 1.0}),
                   (2.9, {"objective": None, "value": None}),
                   (3.5, {"objective": "q", "value": 2.0}), (1.0, {})])]
        got = correlate_actuations(evs, rows)
        _same(got, jd.correlate_actuations(evs, rows))
        assert got["attributed"] == 1 and got["total"] == 4

    def test_default_doctor_spec_parses_and_passes_clean(self):
        assert DEFAULT_DOCTOR_SPEC == JAX_DEFAULT_SPEC
        rows = [{"ts_mono": float(i), "metrics": {
            k: {"type": "counter", "value": v} for k, v in {
                "requests_insert_total": i * 50, "rejected_total": 0,
                "dropped_total": 0, "deadline_expired_total": 0,
                "heal_exhausted_total": 0}.items()}} for i in range(5)]
        assert evaluate_history(DEFAULT_DOCTOR_SPEC, rows)["healthy"]

    def test_verdict_line_of_a_bare_report(self):
        rep = {"verdict": "degraded:slo_breached", "faults": [],
               "health": {"drift_alerts": 0}}
        _same(verdict_line(rep), jd.verdict_line(rep))


def _last_line(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines()


class TestCli:
    def test_doctor_cli_last_line_is_machine_verdict(self, chaos_run,
                                                     tmp_path):
        d, _ = chaos_run
        out_path = str(tmp_path / "report.json")
        rc, lines = _last_line(cli, ["doctor", "--dir", d, "--out",
                                     out_path, "--device", "cpu"])
        jrc, jlines = _last_line(jax_cli, ["doctor", "--dir", d])
        assert rc == jrc == 0
        assert lines[-1] == jlines[-1]
        line = json.loads(lines[-1])
        assert line["doctor_verdict"] == "recovered"
        assert line["healthy"] is True
        with open(out_path) as f:
            assert json.load(f)["verdict"] == "recovered"

    def test_doctor_cli_quiet_and_degraded_exit(self, tmp_path):
        fdump = tmp_path / "flight.jsonl"
        with open(fdump, "w") as f:
            f.write(json.dumps({"format": "tuplewise-flight-v1",
                                "n_events": 1, "dropped": 0}) + "\n")
            f.write(json.dumps(
                {"kind": "chaos_inject", "seq": 1, "t_wall": 0.0,
                 "point": "batcher", "action": "error",
                 "trace_id": 1}) + "\n")
        rc, lines = _last_line(cli, ["doctor", "--flight", str(fdump),
                                     "--quiet", "--device", "cpu"])
        jrc, jlines = _last_line(jax_cli, ["doctor", "--flight",
                                           str(fdump), "--quiet"])
        assert rc == jrc == 2
        assert lines == jlines and len(lines) == 1
        assert json.loads(lines[0])["healthy"] is False

    def test_doctor_cli_of_a_controlled_fleet(self, fleet_run):
        d, _ = fleet_run
        rc, lines = _last_line(cli, ["doctor", "--dir", d, "--device",
                                     "cpu"])
        jrc, jlines = _last_line(jax_cli, ["doctor", "--dir", d])
        assert rc == jrc and lines[-1] == jlines[-1]
        line = json.loads(lines[-1])
        assert line["actuations_attributed"] == line["actuations"]
