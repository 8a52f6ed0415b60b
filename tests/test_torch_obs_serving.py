"""Observability of the port's serving path on the JAX package's cases.

The mirror of ``tests/test_obs_serving.py``'s ``TestTracedServing`` and
``TestFlightInServing`` and of
``tests/test_chaos_serving.py::TestChaosFlightCorrelation``: span
integrity under a concurrent batcher, compactor and submitters, stage
spans tiling each insert, the Chrome export, the disabled-tracing guard,
the flight dump next to the snapshots, and every chaos injection in the
dump with a trace id that resolves into the span trace. The span-parity
case runs a traced replay in each package over one stream, one request
a batch, and compares each request's span tree (names and nesting;
durations are not compared).
"""

import json
import threading

import pytest

from tuplewise_tpu.obs import Tracer as JaxTracer
from tuplewise_tpu.serving import ServingConfig as JaxConfig
from tuplewise_tpu.serving.replay import replay as jax_replay
from tuplewise_tpu_torch.obs import FlightRecorder, Tracer
from tuplewise_tpu_torch.serving import MicroBatchEngine, ServingConfig
from tuplewise_tpu_torch.serving.replay import make_stream, replay


def _stream(n, seed=0):
    return make_stream(n, pos_frac=0.5, separation=1.0, seed=seed)


def _cfg(**kw):
    return ServingConfig(device="cpu", **kw)


class TestTracedServing:
    def test_span_integrity_under_concurrency(self):
        """Batcher + background compactor + multiple submitter threads
        all record concurrently; every parent id must resolve inside
        the same trace and insert stage spans must tile their root."""
        scores, labels = _stream(3000)
        tracer = Tracer(capacity=1 << 16)
        cfg = _cfg(policy="block", compact_every=128,
                            bg_compact=True, flush_timeout_s=0.001)
        with MicroBatchEngine(cfg, tracer=tracer) as eng:
            def submit(lo, hi):
                for i in range(lo, hi):
                    eng.insert(scores[i], labels[i]).result(30.0)

            threads = [threading.Thread(target=submit,
                                        args=(i * 750, (i + 1) * 750))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            eng.index.wait_idle()
        spans = tracer.spans()
        assert tracer.dropped == 0
        by_id = {s["span_id"]: s for s in spans}
        roots = {}
        for s in spans:
            if s["parent_id"] is None:
                roots.setdefault(s["trace_id"], []).append(s)
            else:
                parent = by_id[s["parent_id"]]      # must resolve
                assert parent["trace_id"] == s["trace_id"]
        # one root per trace — a child never leaks into another trace
        assert all(len(r) == 1 for r in roots.values())
        # compactor activity traced on its own thread, its own traces
        compactor = [s for s in spans
                     if s["thread"] == "tuplewise-compactor"]
        assert any(s["name"] == "compactor.build" for s in compactor)
        insert_threads = {s["thread"] for s in spans
                          if s["name"] == "request.insert"}
        assert len(insert_threads) >= 2     # concurrent submitters

    def test_stage_spans_tile_each_insert(self):
        scores, labels = _stream(1200)
        tracer = Tracer()
        rec = replay(scores, labels,
                     config=_cfg(policy="block",
                                          compact_every=256),
                     max_inflight=64, tracer=tracer)
        spans = tracer.spans()
        child_sum = {}
        for s in spans:
            if s["parent_id"] is not None:
                child_sum[s["parent_id"]] = \
                    child_sum.get(s["parent_id"], 0.0) + s["dur_s"]
        roots = [s for s in spans if s["name"] == "request.insert"]
        assert len(roots) == 1200
        for r in roots:
            if r["dur_s"] > 0:
                assert child_sum.get(r["span_id"], 0.0) \
                    >= 0.95 * r["dur_s"]
        # ... and the histogram-side attribution agrees exactly
        assert rec["stage_attribution"]["coverage"] \
            == pytest.approx(1.0, abs=1e-6)

    def test_chrome_export_schema(self, tmp_path):
        scores, labels = _stream(400)
        out = str(tmp_path / "trace.json")
        rec = replay(scores, labels,
                     config=_cfg(policy="block"),
                     max_inflight=64, trace_out=out)
        assert rec["trace_out"] == out and rec["trace_spans"] > 0
        doc = json.load(open(out))
        assert isinstance(doc["traceEvents"], list)
        x = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert x, "no complete events"
        for e in x:
            assert {"name", "pid", "tid", "ts", "dur"} <= set(e)
            assert e["dur"] >= 0
            assert "trace_id" in e["args"] and "span_id" in e["args"]
        # thread metadata present for every tid used
        tids = {e["tid"] for e in x}
        named = {e["tid"] for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "thread_name"}
        assert tids <= named

    def test_disabled_tracing_is_default_and_structural_noop(self):
        scores, labels = _stream(300)
        cfg = _cfg(policy="block", compact_every=128)
        with MicroBatchEngine(cfg) as eng:
            assert eng.tracer is None
            assert eng.index.tracer is None
            fut = eng.insert(scores, labels)
            assert fut.result(30.0) == 300
            eng.flush()
            stats = eng.stats()
        # stage histograms still attribute latency with tracing off
        m = stats["metrics"]
        assert m["insert_stage_queue_wait_s"]["count"] == 1
        total = m["insert_latency_s"]["sum"]
        attributed = sum(
            m[f"insert_stage_{s}_s"]["sum"]
            for s in ("queue_wait", "coalesce", "wal_append",
                      "index_insert", "stream_extend", "snapshot",
                      "resolve"))
        assert attributed == pytest.approx(total, rel=1e-9)


class TestFlightInServing:
    def test_flight_dump_lands_next_to_snapshots(self, tmp_path):
        snapdir = str(tmp_path / "snap")
        scores, labels = _stream(900, seed=4)
        cfg = _cfg(policy="block", compact_every=128,
                            snapshot_dir=snapdir, snapshot_every=256)
        with MicroBatchEngine(cfg) as eng:
            for i in range(0, 900, 45):
                eng.insert(scores[i:i + 45], labels[i:i + 45])
            eng.flush()
        dump = FlightRecorder.load_dump(
            str(tmp_path / "snap" / "flight.jsonl"))
        kinds = {e["kind"] for e in dump["events"]}
        assert "wal_seal" in kinds
        assert "snapshot_landed" in kinds
        assert "engine_closed" in kinds
        seqs = [e["seq"] for e in dump["events"]]
        assert seqs == sorted(seqs)

    def test_lifecycle_events_recorded(self):
        scores, labels = _stream(600, seed=5)
        cfg = _cfg(policy="block", compact_every=128)
        with MicroBatchEngine(cfg) as eng:
            eng.insert(scores, labels).result(30.0)
            with pytest.raises(Exception):
                eng.insert([float("nan")], [1]).result(30.0)
            eng.flush()
            counts = eng.flight.counts()
        assert counts.get("poison_reject") == 1
        assert counts.get("compaction", 0) >= 1

    def test_metrics_flusher_through_replay(self, tmp_path):
        p = str(tmp_path / "metrics.jsonl")
        scores, labels = _stream(500, seed=6)
        rec = replay(scores, labels,
                     config=_cfg(policy="block"),
                     max_inflight=64, metrics_out=p,
                     metrics_every_s=0.05)
        assert rec["metrics_out"] == p
        rows = [json.loads(x) for x in open(p)]
        assert len(rows) >= 2
        assert rows[-1]["metrics"]["events_total"]["value"] == 500
        # live gauges are present in the stream
        assert "queue_depth_live" in rows[-1]["metrics"]
        assert "mesh_width" in rows[-1]["metrics"]


class TestChaosFlightCorrelation:
    def test_every_injected_fault_in_dump_with_trace_id(self, tmp_path):
        """Each chaos trigger appears once in the flight dump, with a
        trace id that resolves into the exported span trace. The port
        makes one fused count a micro-batch (``ROADMAP.md`` Queue 3), so
        the count fault is scheduled at call 5, not the reference's 30,
        to land inside the run."""
        scores, labels = _stream(2500, seed=21)
        spec = {"faults": [
            {"point": "compactor_build", "on_call": 1, "action": "error"},
            {"point": "batcher", "on_call": 9, "action": "error"},
            {"point": "sharded_count", "on_call": 5, "action": "error",
             "dropped": [1]},
            {"point": "poison", "at_events": [40, 1800], "value": "nan"},
        ]}
        tracer = Tracer(capacity=1 << 16)
        flight_out = str(tmp_path / "flight.jsonl")
        cfg = _cfg(policy="block", compact_every=128, bg_compact=True,
                   mesh_shards=2, flush_timeout_s=0.001)
        rec = replay(scores, labels, config=cfg, max_inflight=128,
                     chaos=spec, tracer=tracer, flight_out=flight_out)
        evs = FlightRecorder.load_dump(flight_out)["events"]
        injected = [e for e in evs if e["kind"] == "chaos_inject"]
        fired = rec["faults"]["chaos"]["fired"]
        assert set(fired) == {"compactor_build", "batcher",
                              "sharded_count"}
        assert sorted(e["point"] for e in injected) \
            == sorted(p for p, n in fired.items() for _ in range(n))
        spans_by_trace = {}
        for s in tracer.spans():
            spans_by_trace.setdefault(s["trace_id"], []).append(s)
        for e in injected:
            assert e["trace_id"] is not None, e
        by_point = {e["point"]: e for e in injected}
        cb = by_point["compactor_build"]
        assert any(s["name"] == "compactor.build"
                   for s in spans_by_trace[cb["trace_id"]])
        sc = by_point["sharded_count"]
        assert "index.sharded_count" in {
            s["name"] for s in spans_by_trace[sc["trace_id"]]}
        heals = [e for e in evs if e["kind"] == "heal"]
        assert len(heals) == rec["report"]["reshard_events"] >= 1
        assert heals[0]["mesh_width"] == 1     # shrank to the survivor
        comps = [e for e in evs
                 if e["kind"] in ("compaction", "major_merge")]
        assert len(comps) == rec["report"]["compactions_total"]
        assert len([e for e in evs if e["kind"] == "chaos_poison"]) >= 1
        assert len([e for e in evs if e["kind"] == "poison_reject"]) == 2
        assert rec["auc_abs_err"] == 0.0


def _request_trees(spans):
    """Per request (in trace-id order), the nested (name, children) tree
    of its trace, children sorted by name."""
    kids = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)

    def tree(s):
        return (s["name"], sorted(tree(c) for c in kids.get(s["span_id"],
                                                            ())))

    roots = sorted((s for s in kids[None]
                    if s["name"].startswith("request.")),
                   key=lambda s: s["trace_id"])
    return [tree(r) for r in roots]


class TestSpanParity:
    @pytest.mark.parametrize("window", [None, 300])
    def test_request_span_trees_equal_the_reference(self, window):
        scores, labels = _stream(700, seed=8)
        kw = dict(policy="block", compact_every=64, window=window)
        tr, jtr = Tracer(capacity=1 << 16), JaxTracer(capacity=1 << 16)
        replay(scores, labels, config=_cfg(engine="torch", **kw), chunk=5,
               max_inflight=1, score_every=7, tracer=tr)
        jax_replay(scores, labels, config=JaxConfig(engine="jax", **kw),
                   chunk=5, max_inflight=1, score_every=7, tracer=jtr)
        got, want = _request_trees(tr.spans()), _request_trees(jtr.spans())
        assert len(got) == 140 + 20
        assert got == want
        names = {n for t in got for n in json.dumps(t).split('"')}
        assert {"insert.apply", "insert.wal_append", "score.apply",
                "compaction.sync"} <= names
