"""Observability smoke of the port (the counterpart of the JAX package's
``scripts/obs_smoke.py``): the acceptance harness of the tracing,
metrics, flight-recorder, SLO, host-tax and profiler stack.

A traced replay of a chaos schedule must produce, in one run:

(a) a perfetto-loadable Chrome trace whose per-stage spans sum to
    >= 95 % of each measured insert latency;
(b) a ``metrics.jsonl`` with >= MIN_SNAPSHOTS periodic whole-registry
    snapshots, each stamped with wall and monotonic timestamps, platform
    and config digest;
(c) a flight-recorder dump in which every injected fault and every
    compaction / major-merge / heal event appears exactly once, with a
    trace id on each injected fault;
(d) a host-tax ledger whose bucket sums tile the measured insert latency
    exactly (coverage == 1.0), >= MIN_EXEMPLARS tail exemplars captured
    under the injected latency chaos (a scheduled batcher ``delay``
    stalls queued requests past ``tail_exemplar_ms``), and a schema-valid
    speedscope and collapsed-stack profiler export;

while the span-JSONL export stays digestible by the sibling
``trace_summary.py`` (which also digests the collapsed stacks into the
host-tax table). Any breach exits nonzero; the summary row (stage
"obs_smoke") lands in ``<results>/obs_smoke.jsonl`` and the artifacts in
``--results-dir`` (default ``<results>``), where the port's doctor
(``python -m tuplewise_tpu_torch.harness.cli doctor``) reads them.

Usage: python scripts_torch/obs_smoke.py [--n-events 4000] [--out PATH]
           [--results-dir DIR] [--device cpu]
(``--device``: the torch device, default the card; without a card and
without it, exit 2. ``main(argv, results=DIR)`` writes into DIR, default
``results/torch/``.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RESULTS = os.path.join(REPO, "results", "torch")

from tuplewise_tpu_torch.harness.drivers import (  # noqa: E402
    card_of, driver_device,
)
from tuplewise_tpu_torch.obs.flight import FlightRecorder  # noqa: E402
from tuplewise_tpu_torch.obs.prof import SamplingProfiler  # noqa: E402
from tuplewise_tpu_torch.obs.tracing import Tracer  # noqa: E402
from tuplewise_tpu_torch.serving import (  # noqa: E402
    ServingConfig, make_stream, replay,
)
from tuplewise_tpu_torch.utils.device import add_device_flag  # noqa: E402

# the batcher 'delay' is the injected latency chaos: a 60 ms stall
# between batches ages every queued request past the 25 ms exemplar
# threshold, so tail exemplars land in the flight ring (the doctor
# resolves a delay fault as latency_absorbed)
TAIL_EXEMPLAR_MS = 25.0
CHAOS = {"faults": [
    {"point": "compactor_build", "on_call": 1, "action": "error"},
    {"point": "batcher", "on_call": 5, "action": "delay",
     "seconds": 0.06},
    {"point": "batcher", "on_call": 15, "action": "error"},
    {"point": "poison", "at_events": [150, 900], "value": "nan"},
]}
# the wall-clock outcomes: periodic snapshots at METRICS_EVERY_S, and the
# tail exemplars the delay causes
METRICS_EVERY_S = 0.2
MIN_SNAPSHOTS = 2
MIN_EXEMPLARS = 1

# live SLO objectives: generous bounds a healthy smoke always clears; the
# smoke asserts the evaluation ran (gauges and a healthy verdict)
SLO = {"objectives": [
    {"name": "insert_p99", "type": "latency",
     "metric": "insert_latency_s", "quantile": "p99",
     "threshold_ms": 2000.0},
    {"name": "availability", "type": "error_rate",
     "errors": ["rejected_total", "dropped_total",
                "deadline_expired_total"],
     "total": "requests_insert_total", "objective": 0.99,
     "windows": [{"window_s": 0.5, "burn": 20.0},
                 {"window_s": 2.0, "burn": 5.0}]},
    {"name": "no_heal_exhaustion", "type": "counter_max",
     "metric": "heal_exhausted_total", "max": 0},
    {"name": "queue_saturation", "type": "saturation",
     "metric": "queue_depth_live", "capacity": "queue_size",
     "max_fraction": 0.99},
]}


def trace_summary():
    """The sibling ``trace_summary.py``, loaded from this directory."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "trace_summary.py")
    spec = importlib.util.spec_from_file_location("_trace_summary", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fail(msg: str) -> int:
    print(f"OBS SMOKE FAIL: {msg}", file=sys.stderr)
    return 1


def _check_chrome(path: str) -> int:
    """Chrome trace-event schema: the contract perfetto loads."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return _fail("trace has no traceEvents list")
    n_x = 0
    for e in evs:
        if not isinstance(e, dict) or "ph" not in e:
            return _fail(f"malformed trace event: {e!r}")
        if e["ph"] == "X":
            n_x += 1
            for k in ("name", "pid", "tid", "ts", "dur"):
                if k not in e:
                    return _fail(f"X event missing {k!r}: {e!r}")
            if not (isinstance(e["ts"], (int, float))
                    and isinstance(e["dur"], (int, float))
                    and e["dur"] >= 0):
                return _fail(f"X event bad ts/dur: {e!r}")
        elif e["ph"] == "M":
            if "name" not in e or "args" not in e:
                return _fail(f"M event missing name/args: {e!r}")
    if n_x == 0:
        return _fail("trace has no complete (X) events")
    print(f"  chrome trace OK: {n_x} X events", file=sys.stderr)
    return 0


def _check_stage_sums(spans_path: str) -> int:
    """Per-insert attribution: child stage spans sum to >= 95 % of each
    request.insert root span's duration."""
    spans = trace_summary().load_spans(spans_path)
    children = {}
    for s in spans:
        if s.get("parent_id") is not None:
            children.setdefault(s["parent_id"], 0.0)
            children[s["parent_id"]] += s["dur_s"]
    roots = [s for s in spans if s["name"] == "request.insert"
             and s["parent_id"] is None]
    if not roots:
        return _fail("no request.insert root spans in the trace")
    bad = 0
    for r in roots:
        if r["dur_s"] <= 0:
            continue
        cov = children.get(r["span_id"], 0.0) / r["dur_s"]
        if cov < 0.95:
            bad += 1
    if bad:
        return _fail(f"{bad}/{len(roots)} insert traces have stage "
                     f"spans summing to < 95% of the measured latency")
    print(f"  stage sums OK: {len(roots)} insert traces all >= 95%",
          file=sys.stderr)
    return 0


def _check_metrics(path: str) -> int:
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if len(rows) < max(MIN_SNAPSHOTS, 1):
        return _fail(f"metrics.jsonl has {len(rows)} snapshots "
                     f"(< {MIN_SNAPSHOTS})")
    for r in rows:
        for k in ("seq", "ts_wall", "ts_mono", "platform",
                  "config_digest", "metrics"):
            if k not in r:
                return _fail(f"metrics row missing {k!r}")
    if rows[-1]["metrics"].get("events_total", {}).get("value", 0) < 1:
        return _fail("final metrics snapshot shows no applied events")
    print(f"  metrics OK: {len(rows)} snapshots", file=sys.stderr)
    return 0


def _check_slo(rec: dict, metrics_path: str) -> int:
    """Live SLO evaluation: the verdict block exists, every objective was
    judged, nothing breached, and the slo_* gauges landed in the metrics
    stream itself."""
    slo = rec.get("slo")
    if not slo:
        return _fail("record has no slo block despite slo_spec")
    if set(slo["objectives"]) != {o["name"] for o in SLO["objectives"]}:
        return _fail(f"slo objectives mismatch: {sorted(slo['objectives'])}")
    if slo["evaluations"] < 2:
        return _fail(f"slo evaluated only {slo['evaluations']} times")
    if not slo["healthy"]:
        return _fail(f"healthy smoke breached SLOs: {slo['objectives']}")
    with open(metrics_path, "r", encoding="utf-8") as f:
        last = None
        for line in f:
            if line.strip():
                last = line
    m = json.loads(last)["metrics"]
    gauges = [k for k in m if k.startswith("slo_breached{")]
    if len(gauges) != len(SLO["objectives"]):
        return _fail(f"expected {len(SLO['objectives'])} slo_breached "
                     f"gauges in metrics.jsonl, found {gauges}")
    if any(m[g]["value"] != 0.0 for g in gauges):
        return _fail("slo_breached gauge stuck nonzero on healthy run")
    print(f"  slo OK: {len(slo['objectives'])} objectives x "
          f"{slo['evaluations']} evaluations, healthy", file=sys.stderr)
    return 0


def _check_host_tax(rec: dict, flight_path: str) -> int:
    """Ledger tiling (coverage == 1.0 up to float rounding), a sane
    fraction split, and >= MIN_EXEMPLARS tail exemplars (each with its
    bucket ledger) under the injected latency chaos."""
    ht = rec.get("host_tax")
    if not ht:
        return _fail("record has no host_tax block")
    cov = ht.get("coverage")
    if cov is None or abs(cov - 1.0) > 1e-6:
        return _fail(f"ledger coverage {cov!r} != 1.0: an interval "
                     "escaped the bucket tiling")
    fracs = (ht.get("host_fraction"), ht.get("device_fraction"))
    if any(f is None or not 0.0 <= f <= 1.0 for f in fracs):
        return _fail(f"host/device fractions out of range: {fracs}")
    if not ht.get("waves"):
        return _fail("ledger recorded no waves")
    exemplars = [e for e in FlightRecorder.load_dump(
        flight_path)["events"] if e["kind"] == "tail_exemplar"]
    if len(exemplars) < MIN_EXEMPLARS:
        return _fail(f"{len(exemplars)} tail_exemplars under the injected "
                     f"60ms delay (threshold {TAIL_EXEMPLAR_MS}ms)")
    for e in exemplars:
        if e.get("lat_ms", 0) < TAIL_EXEMPLAR_MS:
            return _fail(f"exemplar below threshold: {e}")
        b = e.get("buckets")
        if not b or "queue_wait" not in b or "host_python" not in b:
            return _fail(f"exemplar missing its bucket ledger: {e}")
    print(f"  host tax OK: coverage={cov:.9f} host="
          f"{fracs[0]:.3f} device={fracs[1]:.3f} "
          f"exemplars={len(exemplars)}", file=sys.stderr)
    return 0


def _check_speedscope(path: str) -> int:
    """The profiler's speedscope export is schema-valid: shared frame
    table, one sampled profile, index-consistent samples, weights aligned
    1:1."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if "speedscope" not in doc.get("$schema", ""):
        return _fail(f"speedscope $schema missing: {doc.get('$schema')}")
    frames = doc.get("shared", {}).get("frames")
    if not isinstance(frames, list) or not frames \
            or not all(isinstance(fr, dict) and "name" in fr
                       for fr in frames):
        return _fail("speedscope shared.frames malformed")
    profs = doc.get("profiles")
    if not isinstance(profs, list) or not profs:
        return _fail("speedscope has no profiles")
    p = profs[0]
    if p.get("type") != "sampled" or p.get("unit") != "seconds":
        return _fail(f"speedscope profile wrong type/unit: {p.get('type')}"
                     f"/{p.get('unit')}")
    samples, weights = p.get("samples"), p.get("weights")
    if not isinstance(samples, list) or not samples \
            or len(samples) != len(weights):
        return _fail("speedscope samples/weights misaligned")
    nf = len(frames)
    for s in samples:
        if not s or any(not isinstance(i, int) or not 0 <= i < nf
                        for i in s):
            return _fail(f"speedscope sample indexes out of range: {s}")
    if abs(sum(weights) - p.get("endValue", -1)) > 1e-6:
        return _fail("speedscope endValue != sum(weights)")
    print(f"  speedscope OK: {len(samples)} samples over {nf} frames",
          file=sys.stderr)
    return 0


def _check_flight(path: str, rec: dict) -> int:
    dump = FlightRecorder.load_dump(path)
    evs = dump["events"]
    kinds = {}
    for e in evs:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    # every injected fault appears exactly once, with a trace id
    injected = [e for e in evs if e["kind"] == "chaos_inject"]
    scheduled = [f for f in CHAOS["faults"] if f["point"] != "poison"]
    if len(injected) != len(scheduled):
        return _fail(f"{len(injected)} chaos_inject events for "
                     f"{len(scheduled)} scheduled faults")
    seen_points = sorted(e["point"] for e in injected)
    if seen_points != sorted(f["point"] for f in scheduled):
        return _fail(f"chaos points mismatch: {seen_points}")
    for e in injected:
        if e.get("trace_id") is None:
            return _fail(f"chaos_inject without a trace id: {e}")
    # every compaction / major merge / heal appears exactly once: the
    # flight counts equal the metric counters
    m = rec["report"]
    pairs = (("compaction-ish", kinds.get("compaction", 0)
              + kinds.get("major_merge", 0), m["compactions_total"]),
             ("major_merge", kinds.get("major_merge", 0),
              m["major_merges_total"]),
             ("heal", kinds.get("heal", 0), m["reshard_events"]))
    for name, n_flight, n_metric in pairs:
        if n_flight != n_metric:
            return _fail(f"{name}: {n_flight} flight events vs "
                         f"{n_metric} counted")
    # sequence numbers are strictly increasing (ring integrity)
    seqs = [e["seq"] for e in evs]
    if seqs != sorted(seqs) or len(set(seqs)) != len(seqs):
        return _fail("flight sequence numbers not strictly increasing")
    print(f"  flight OK: {kinds}", file=sys.stderr)
    return 0


def main(argv=None, *, results: str | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-events", type=int, default=4_000)
    ap.add_argument("--out", type=str, default=None,
                    help="the summary row's file (default <results>/"
                         "obs_smoke.jsonl)")
    ap.add_argument("--results-dir", type=str, default=None,
                    help="the artifacts' directory (default <results>)")
    add_device_flag(ap)
    args = ap.parse_args([] if argv is None else argv)
    device = driver_device(ap, args.device)
    results = results or RESULTS
    out = args.out or os.path.join(results, "obs_smoke.jsonl")
    art = args.results_dir or results
    os.makedirs(art, exist_ok=True)
    trace_json = os.path.join(art, "obs_trace.json")
    spans_jsonl = os.path.join(art, "obs_spans.jsonl")
    metrics_out = os.path.join(art, "metrics.jsonl")
    flight_out = os.path.join(art, "obs_flight.jsonl")
    prof_speedscope = os.path.join(art, "obs_prof.speedscope.json")
    prof_collapsed = os.path.join(art, "obs_prof.collapsed")
    for p in (trace_json, spans_jsonl, metrics_out, flight_out,
              prof_speedscope, prof_collapsed):
        if os.path.exists(p):
            os.unlink(p)

    scores, labels = make_stream(args.n_events, pos_frac=0.5,
                                 separation=1.0, seed=0)
    cfg = ServingConfig(policy="block", flush_timeout_s=0.002,
                        compact_every=256, bg_compact=True,
                        tail_exemplar_ms=TAIL_EXEMPLAR_MS,
                        device=str(device))
    tracer = Tracer(capacity=1 << 17)
    profiler = SamplingProfiler()
    rec = replay(scores, labels, config=cfg, max_inflight=256,
                 chaos=CHAOS, tracer=tracer, trace_out=trace_json,
                 metrics_out=metrics_out, metrics_every_s=METRICS_EVERY_S,
                 flight_out=flight_out, slo_spec=SLO,
                 prof=profiler, prof_out=prof_speedscope)
    profiler.export_collapsed(prof_collapsed)
    tracer.export_jsonl(spans_jsonl)
    if tracer.dropped:
        return _fail(f"tracer ring dropped {tracer.dropped} spans: "
                     "raise capacity, the checks below would lie")

    rc = (_check_chrome(trace_json)
          or _check_stage_sums(spans_jsonl)
          or _check_metrics(metrics_out)
          or _check_flight(flight_out, rec)
          or _check_slo(rec, metrics_out)
          or _check_host_tax(rec, flight_out)
          or _check_speedscope(prof_speedscope))
    if rc:
        return rc

    # the summarizer digests every export: spans, Chrome trace, and the
    # profiler leg's host-tax table
    ts = trace_summary()
    summary = ts.summarize_spans(spans_jsonl, 10)
    ts.summarize_spans(trace_json, 5)
    host_tax_table = ts.summarize_collapsed(prof_collapsed, 8)
    print(summary, file=sys.stderr)
    print(host_tax_table, file=sys.stderr)

    row = {
        "stage": "obs_smoke",
        "n_events": args.n_events,
        "events_per_s": rec["events_per_s"],
        "insert_stage_p99_ms": rec["insert_stage_p99_ms"],
        "stage_coverage": rec["stage_attribution"]["coverage"],
        "trace_spans": rec["trace_spans"],
        "flight_events": rec["flight_events"],
        "auc_abs_err": rec.get("auc_abs_err"),
        "slo_healthy": rec["slo"]["healthy"],
        "slo_evaluations": rec["slo"]["evaluations"],
        "host_tax_coverage": rec["host_tax"]["coverage"],
        "host_fraction": rec["host_tax"]["host_fraction"],
        "device_fraction": rec["host_tax"]["device_fraction"],
        "compile_events": rec["host_tax"]["compile_events"],
        "tail_exemplars": rec["host_tax"]["tail_exemplars"],
        "prof_samples": rec.get("prof_samples"),
        "prof_overhead_fraction": rec.get("prof_overhead_fraction"),
        "card": card_of(device),
    }
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        f.write(json.dumps(row) + "\n")
    print(f"obs smoke OK: {rec['trace_spans']} spans, coverage="
          f"{row['stage_coverage']:.6f}, ledger="
          f"{row['host_tax_coverage']:.6f}, flight="
          f"{rec['flight_events']} -> {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
