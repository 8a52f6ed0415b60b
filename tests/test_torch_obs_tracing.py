"""The port's span tracer and live metrics export, on the JAX package's
cases.

The mirror of ``tests/test_obs.py``'s ``TestTracer``, ``TestMetricsFlusher``
and ``TestFlusherRotationAndObservers`` against
``tuplewise_tpu_torch.obs``, plus the tracer's guard, its flight-recorder
correlation and the export formats held against the JAX tracer's.
"""

import json
import os
import threading
import time

import pytest

from tuplewise_tpu.obs import Tracer as JaxTracer
from tuplewise_tpu.obs.metrics_export import config_digest as jax_digest
from tuplewise_tpu_torch.obs import (
    FlightRecorder, MetricsFlusher, Tracer, config_digest,
)
from tuplewise_tpu_torch.obs.tracing import check_tracer, maybe_span
from tuplewise_tpu_torch.serving import ServingConfig
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry


class TestTracer:
    def test_nesting_parents_same_thread(self):
        tr = Tracer()
        with tr.span("outer") as o:
            assert tr.current() is o
            with tr.span("inner") as i:
                assert i.parent_id == o.span_id
                assert i.trace_id == o.trace_id
        spans = tr.spans()
        assert [s["name"] for s in spans] == ["inner", "outer"]
        assert spans[1]["parent_id"] is None

    def test_separate_roots_get_separate_traces(self):
        tr = Tracer()
        with tr.span("a"):
            pass
        with tr.span("b"):
            pass
        a, b = tr.spans()
        assert a["trace_id"] != b["trace_id"]

    def test_explicit_cross_thread_parent(self):
        tr = Tracer()
        root = tr.start("request")
        out = {}

        def worker():
            with tr.span("apply", parent=root) as sp:
                out["tid"] = sp.trace_id
                out["pid"] = sp.parent_id

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        tr.finish(root)
        assert out["tid"] == root.trace_id
        assert out["pid"] == root.span_id

    def test_record_span_retroactive(self):
        tr = Tracer()
        root = tr.start("r")
        t0 = time.perf_counter()
        t1 = t0 + 0.25
        tr.record_span("wait", t0, t1, parent=root)
        tr.finish(root)
        wait = [s for s in tr.spans() if s["name"] == "wait"][0]
        assert wait["dur_s"] == pytest.approx(0.25)
        assert wait["parent_id"] == root.span_id

    def test_monotonic_durations_nonnegative(self):
        tr = Tracer()
        for _ in range(50):
            with tr.span("x"):
                pass
        assert all(s["dur_s"] >= 0 for s in tr.spans())

    def test_ring_bounds_memory(self):
        tr = Tracer(capacity=8)
        for i in range(20):
            with tr.span(f"s{i}"):
                pass
        assert len(tr) == 8
        assert tr.dropped == 12
        # ring order restored: oldest retained first
        assert [s["name"] for s in tr.spans()] == [
            f"s{i}" for i in range(12, 20)]

    def test_disabled_tracer_allocates_nothing(self):
        tr = Tracer(enabled=False)
        with tr.span("x") as sp:
            assert sp is None
        assert tr.start("y") is None
        assert len(tr) == 0

    def test_maybe_span_none_is_noop(self):
        with maybe_span(None, "anything") as sp:
            assert sp is None

    def test_error_marks_span(self):
        tr = Tracer()
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("x")
        s = tr.spans()[0]
        assert s["attrs"]["error"] == "ValueError"

    def test_export_jsonl_roundtrip(self, tmp_path):
        tr = Tracer()
        with tr.span("a", k=1):
            with tr.span("b"):
                pass
        p = str(tmp_path / "spans.jsonl")
        assert tr.export_jsonl(p) == 2
        lines = [json.loads(x) for x in open(p)]
        assert lines[0]["meta"]["format"] == "tuplewise-spans-v1"
        names = {r["name"] for r in lines[1:]}
        assert names == {"a", "b"}

    def test_export_chrome_schema(self, tmp_path):
        tr = Tracer()
        with tr.span("a"):
            pass
        p = str(tmp_path / "trace.json")
        tr.export_chrome(p)
        doc = json.load(open(p))
        evs = doc["traceEvents"]
        x = [e for e in evs if e["ph"] == "X"]
        m = [e for e in evs if e["ph"] == "M"]
        assert len(x) == 1 and x[0]["name"] == "a"
        assert x[0]["ts"] >= 0 and x[0]["dur"] >= 0
        assert any(e["name"] == "thread_name" for e in m)
        assert any(e["name"] == "process_name" for e in m)

    def test_thread_safety_concurrent_spans(self):
        tr = Tracer()

        def worker(i):
            for _ in range(200):
                with tr.span(f"w{i}"):
                    with tr.span(f"w{i}.child"):
                        pass

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        spans = tr.spans()
        assert len(spans) == 8 * 200 * 2
        # every child's parent is the matching worker's root, never a
        # span from another thread
        by_id = {s["span_id"]: s for s in spans}
        for s in spans:
            if s["parent_id"] is not None:
                parent = by_id[s["parent_id"]]
                assert s["name"] == parent["name"] + ".child"
                assert s["trace_id"] == parent["trace_id"]


class TestMetricsFlusher:
    def test_start_stop_writes_at_least_two_rows(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("c").inc(3)
        p = str(tmp_path / "m.jsonl")
        fl = MetricsFlusher(reg, p, every_s=10.0,
                            meta={"stage": "test"}, config={"a": 1})
        fl.start()
        fl.stop()
        rows = [json.loads(x) for x in open(p)]
        assert len(rows) >= 2
        for r in rows:
            assert r["stage"] == "test"
            assert r["platform"]
            assert r["config_digest"] == config_digest({"a": 1})
            assert r["ts_wall"] > 0 and r["ts_mono"] > 0
            assert r["metrics"]["c"]["value"] == 3
        assert rows[-1]["seq"] > rows[0]["seq"]

    def test_periodic_rows(self, tmp_path):
        reg = MetricsRegistry()
        p = str(tmp_path / "m.jsonl")
        with MetricsFlusher(reg, p, every_s=0.05):
            time.sleep(0.3)
        rows = [json.loads(x) for x in open(p)]
        assert len(rows) >= 4   # start + a few ticks + stop

    def test_flush_error_kept_not_raised(self, tmp_path):
        reg = MetricsRegistry()
        fl = MetricsFlusher(reg, str(tmp_path), every_s=1.0)  # a dir!
        fl.flush()
        assert fl.last_flush_error is not None

    def test_config_digest_stable_and_distinct(self):
        a = config_digest({"x": 1, "y": 2})
        assert a == config_digest({"y": 2, "x": 1})
        assert a != config_digest({"x": 1, "y": 3})
        assert config_digest(ServingConfig()) \
            == config_digest(ServingConfig())
        assert config_digest(ServingConfig()) \
            != config_digest(ServingConfig(budget=7))


class TestFlusherRotationAndObservers:
    """ max-bytes rotation + the observer hook the
    SLO monitor rides."""

    def test_max_bytes_rolls_to_dot_one(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("c").inc()
        p = str(tmp_path / "m.jsonl")
        fl = MetricsFlusher(reg, p, every_s=10.0, max_bytes=256)
        n = 40
        for _ in range(n):
            fl.flush()
        fl.stop()
        assert fl.rotations >= 2
        roll = p + ".1"
        assert os.path.exists(roll) and os.path.exists(p)
        # both generations hold only WHOLE rows, seqs stay monotonic
        rows = [json.loads(x) for x in open(roll)] \
            + [json.loads(x) for x in open(p)]
        seqs = [r["seq"] for r in rows]
        assert seqs == sorted(seqs)
        assert seqs[-1] == n + 1    # n flushes + stop()'s final row
        # bounded: live file + one roll, each near the cap
        assert os.path.getsize(p) <= 256 + 512
        assert os.path.getsize(roll) <= 256 + 512

    def test_rotation_validation(self):
        with pytest.raises(ValueError, match="max_bytes"):
            MetricsFlusher(MetricsRegistry(), "x.jsonl", max_bytes=0)

    def test_observers_see_every_row(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("c").inc(7)
        rows = []
        p = str(tmp_path / "m.jsonl")
        fl = MetricsFlusher(reg, p, every_s=10.0,
                            observers=[rows.append])
        fl.start()
        fl.stop()
        assert len(rows) >= 2
        assert rows[0]["metrics"]["c"]["value"] == 7
        disk = [json.loads(x) for x in open(p)]
        assert [r["seq"] for r in rows] == [r["seq"] for r in disk]

    def test_observer_only_flusher_without_path(self):
        reg = MetricsRegistry()
        seen = []
        fl = MetricsFlusher(reg, None, every_s=10.0,
                            observers=[seen.append])
        fl.start()
        fl.stop()
        assert len(seen) >= 2
        assert fl.last_flush_error is None

    def test_observer_exception_never_kills_flusher(self, tmp_path):
        reg = MetricsRegistry()

        def bad(row):
            raise RuntimeError("observer bug")

        p = str(tmp_path / "m.jsonl")
        fl = MetricsFlusher(reg, p, every_s=10.0, observers=[bad])
        fl.flush()
        fl.flush()
        fl.stop()
        assert fl.last_flush_error is not None
        assert len([x for x in open(p)]) == 3

    def test_stop_bounded_by_wedged_observer(self, tmp_path):
        """ stop() must NOT inherit a wedged
        observer's hang: observers run under the flush lock, so the
        old final-flush-then-close path deadlocked shutdown behind
        whatever the observer was stuck on. Now stop() joins with a
        timeout, counts flusher_late_flushes_total, and the in-flight
        flush closes the file when it finally completes."""
        import threading
        import time as _time

        reg = MetricsRegistry()
        entered = threading.Event()
        release = threading.Event()

        def wedged(row):
            if row["seq"] >= 2:      # the first flush is start()'s
                entered.set()
                release.wait(20.0)   # wedged until the test releases

        p = str(tmp_path / "m.jsonl")
        fl = MetricsFlusher(reg, p, every_s=0.02,
                            observers=[wedged])
        fl.start()
        assert entered.wait(10.0)
        t0 = _time.perf_counter()
        fl.stop(timeout=0.2)         # must return promptly, not hang
        stop_s = _time.perf_counter() - t0
        assert stop_s < 5.0
        snap = reg.snapshot()
        assert snap["flusher_late_flushes_total"]["value"] == 1
        assert "wedged" in (fl.last_flush_error or "")
        # release the observer: the in-flight flush completes, closes
        # the file, and the thread exits
        release.set()
        deadline = _time.perf_counter() + 10.0
        while fl._f is not None and _time.perf_counter() < deadline:
            _time.sleep(0.01)
        assert fl._f is None
        rows = [json.loads(x) for x in open(p) if x.strip()]
        assert rows and rows[-1]["seq"] >= 2

    def test_stop_without_wedge_counts_nothing(self, tmp_path):
        reg = MetricsRegistry()
        p = str(tmp_path / "m.jsonl")
        fl = MetricsFlusher(reg, p, every_s=10.0)
        fl.start()
        fl.stop()
        assert reg.snapshot()[
            "flusher_late_flushes_total"]["value"] == 0
        assert fl._f is None


class TestPortOnly:
    def test_check_tracer_accepts_a_tracer_only(self):
        check_tracer(None)
        check_tracer(Tracer())
        for bad in (object(), JaxTracer(), "tracer"):
            with pytest.raises(TypeError, match="Tracer"):
                check_tracer(bad)

    def test_flight_events_carry_the_active_trace(self):
        tr = Tracer()
        fr = FlightRecorder(tracer=tr)
        with tr.span("op") as sp:
            fr.record("inside")
        fr.record("outside")
        assert [e["trace_id"] for e in fr.events()] == [sp.trace_id, None]

    def test_exports_have_the_reference_schema(self, tmp_path):
        """The same spans in both tracers export the same JSONL keys and
        the same Chrome event keys."""
        def fill(tr):
            with tr.span("a", k=1):
                with tr.span("b"):
                    pass
            return tr

        out = {}
        for name, tr in (("port", fill(Tracer())), ("jax", fill(JaxTracer()))):
            tr.export_jsonl(str(tmp_path / f"{name}.jsonl"))
            tr.export_chrome(str(tmp_path / f"{name}.json"))
            lines = [json.loads(x) for x in
                     open(tmp_path / f"{name}.jsonl")]
            doc = json.load(open(tmp_path / f"{name}.json"))
            out[name] = (sorted(lines[0]["meta"]),
                         [sorted(r) for r in lines[1:]],
                         [r["name"] for r in lines[1:]],
                         sorted(doc), sorted(doc["metadata"]),
                         [sorted(e) for e in doc["traceEvents"]])
        assert out["port"] == out["jax"]

    def test_config_digest_equals_the_reference(self):
        cfg = {"kernel": "auc", "window": 10, "count_kernel": False}
        assert config_digest(cfg) == jax_digest(cfg)
