"""Post-hoc diagnosis of a run's observability artifacts.

The counterpart of ``tuplewise_tpu.obs.doctor`` (``tuplewise-torch
doctor``). A serve or replay run (or what is left of it after SIGKILL)
leaves three artifacts side by side: ``metrics.jsonl`` (the flusher's
periodic registry snapshots), ``flight.jsonl`` (the lifecycle ring dump)
and a span export (JSONL or Chrome trace). The doctor reads whatever
subset exists and renders a verdict a human or a CI gate can act on:

* **SLO verdicts**: the metrics history replayed through
  :mod:`tuplewise_tpu_torch.obs.slo` (``--slo-spec``, or the conservative
  default spec: no heal exhaustion, an availability error budget).
* **Health verdicts**: the statistical monitors' final gauges (CI width
  of the streaming estimate, drift alerts, shard skew).
* **Fault -> recovery correlation**: every chaos injection or poison in
  the flight dump listed exactly once, each tied to its recovery
  evidence (the batcher restart that followed it, the poison reject
  that shed it, the heal that re-placed the mesh) and, with a span
  export, to the span its trace id points at.
* **Actuation attribution**: every control-plane ``actuation`` event
  judged on its triggering signal and an observed effect window.
* **Top self-time spans**: where the wall-clock went (total minus
  direct-child time).
* **Host-tax verdicts**: the wave ledger's final gauges (host/device
  fraction, coverage, first-use build and GC event counts) against the
  compile-churn and GC-in-p99 thresholds; the count-kernel and pack
  re-place counters under ``kernel``. The port's kernels have no
  fallback, so its runs never count ``count_kernel_fallbacks_total``
  above 0; artifacts that do are judged as the reference judges them.

Verdicts:

* ``healthy``   no faults observed, no SLO breach, no drift.
* ``recovered`` failures happened (chaos or real), each is tied to
                recovery evidence and no SLO objective breached.
* ``degraded``  an SLO objective breached, a monitor fired, a fault has
                no recovery evidence, an actuation is unattributed, or
                the process hit a terminal failure (heal exhaustion,
                snapshot error).

The last stdout line of the CLI is one machine-readable JSON object
(``{"doctor_verdict": ...}``).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import List, Optional, Tuple

from tuplewise_tpu_torch.obs.flight import FlightRecorder
from tuplewise_tpu_torch.obs.slo import DEFAULT_DOCTOR_SPEC, evaluate_history

# artifact filenames probed (in order) when only a directory is given
_METRICS_NAMES = ("metrics.jsonl",)
_FLIGHT_NAMES = ("flight.jsonl", "obs_flight.jsonl")
_SPAN_NAMES = ("spans.jsonl", "obs_spans.jsonl", "trace.json",
               "obs_trace.json")

# host-tax verdict thresholds (override via diagnose's ``context``): a
# steady-state service averaging more than one first-use build a batch
# (``xla_compile_events_total``, the ledger's name) on its request thread
# has lost its warm-up discipline; a GC pause distribution whose p99
# rivals the insert p99 means the collector is the tail. Both are
# generous enough that short runs without a warm-up clear them; a
# long-running serve should gate far tighter via context.
COMPILE_CHURN_PER_1K_BATCHES = 1000.0
GC_P99_FRACTION_OF_INSERT = 0.5
GC_MIN_PAUSES = 10


def load_metrics_rows(path: str) -> List[dict]:
    """Flusher rows, torn-tail tolerant (the file of a SIGKILLed
    process can end mid-line; keep what parses)."""
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                break
    return rows


def load_spans(path: str) -> List[dict]:
    """Spans from either export shape (span JSONL or Chrome trace
    JSON), self-contained so the doctor works from any checkout or
    working directory."""
    if path.endswith(".jsonl"):
        spans = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break    # torn tail
                if "meta" in rec:
                    continue
                spans.append(rec)
        return spans
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    spans = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        args = e.get("args", {})
        spans.append({
            "trace_id": args.get("trace_id"),
            "span_id": args.get("span_id"),
            "parent_id": args.get("parent_id"),
            "name": e["name"],
            "t0_s": e["ts"] / 1e6,
            "dur_s": e.get("dur", 0.0) / 1e6,
        })
    return spans


def top_self_spans(spans: List[dict], top_n: int = 10) -> List[dict]:
    """Per-name totals ordered by SELF time (total minus direct-child
    time) — the honest where-did-the-wall-clock-go list."""
    child_time: dict = defaultdict(float)
    for s in spans:
        if s.get("parent_id") is not None:
            child_time[s["parent_id"]] += s["dur_s"]
    agg: dict = defaultdict(lambda: {"n": 0, "total_s": 0.0,
                                     "self_s": 0.0})
    for s in spans:
        a = agg[s["name"]]
        a["n"] += 1
        a["total_s"] += s["dur_s"]
        a["self_s"] += max(0.0, s["dur_s"]
                           - child_time.get(s["span_id"], 0.0))
    out = [dict(name=n, **a) for n, a in agg.items()]
    out.sort(key=lambda a: -a["self_s"])
    return out[:top_n]


# --------------------------------------------------------------------- #
# fault -> recovery correlation                                          #
# --------------------------------------------------------------------- #

def _metric_value(rows: List[dict], name: str, default=0):
    if not rows:
        return default
    return rows[-1]["metrics"].get(name, {}).get("value", default)


def tenant_breakdown(metrics_rows: List[dict]) -> Optional[dict]:
    """Per-tenant diagnosis block: every tenant-labeled
    series in the final snapshot grouped by tenant — insert p99,
    admission rejections, and any per-tenant SLO breach gauge
    (``slo_breached{objective=...,tenant=...}``). None when the run
    was single-tenant (no tenant-labeled metrics)."""
    if not metrics_rows:
        return None
    from collections import defaultdict

    from tuplewise_tpu_torch.utils.profiling import parse_labeled_name

    m = metrics_rows[-1]["metrics"]
    out: dict = defaultdict(dict)
    for key, snap in m.items():
        base, labels = parse_labeled_name(key)
        if not labels or "tenant" not in labels:
            continue
        tid = labels["tenant"]
        if base == "insert_latency_s":
            p = snap.get("p99")
            out[tid]["insert_p99_ms"] = None if p is None else p * 1e3
            out[tid]["inserts"] = snap.get("count", 0)
        elif base == "tenant_rejected_total":
            out[tid]["rejected"] = snap.get("value", 0)
        elif base == "slo_breached":
            breached = out[tid].setdefault("slo_breached", [])
            if snap.get("value"):
                breached.append(labels.get("objective"))
    if not out:
        return None
    # bounded cardinality: when tenant_metric_cap
    # collapsed tenants into the {tenant=__other__} series, surface how
    # many distinct tenants that one series hides
    collapsed = m.get("tenant_metric_collapsed", {}).get("value", 0)
    if collapsed and "__other__" in out:
        out["__other__"]["collapsed_tenants"] = int(collapsed)
    return dict(out)


def _span_for_trace(spans: List[dict], trace_id) -> Optional[str]:
    """The root-most span name of a trace id (None when the export
    does not carry the trace)."""
    members = [s for s in spans if s.get("trace_id") == trace_id]
    if not members:
        return None
    roots = [s for s in members if s.get("parent_id") is None]
    return (roots or members)[0]["name"]


def correlate_faults(flight_events: List[dict], metrics_rows: List[dict],
                     spans: List[dict]) -> List[dict]:
    """One entry per injected fault (chaos_inject, plus chaos_poison
    expanded per poisoned event position), each carrying its recovery
    evidence. ``resolved=False`` entries push the verdict to
    degraded."""
    faults = []
    by_kind: dict = defaultdict(list)
    for e in flight_events:
        by_kind[e["kind"]].append(e)

    def _after(kind: str, seq: int) -> Optional[dict]:
        for e in by_kind.get(kind, ()):
            if e["seq"] > seq:
                return e
        return None

    for e in by_kind.get("chaos_inject", ()):
        point = e.get("point")
        entry = {
            "kind": "chaos_inject", "point": point, "seq": e["seq"],
            "t_wall": e.get("t_wall"), "action": e.get("action"),
            "trace_id": e.get("trace_id"),
            "trace_span": _span_for_trace(spans, e.get("trace_id")),
        }
        resolution = evidence = None
        if e.get("action") == "delay":
            # a latency injection needs no recovery machinery — the
            # engine absorbs the stall; when tail exemplars fired
            #, THEY are the evidence the stall was seen
            resolution = "latency_absorbed"
            n_ex = len(by_kind.get("tail_exemplar", ()))
            evidence = ({"tail_exemplars": n_ex} if n_ex else None)
        elif point == "batcher":
            r = _after("batcher_restart", e["seq"])
            if r is not None:
                resolution = "batcher_restart"
                evidence = {"seq": r["seq"]}
            elif _metric_value(metrics_rows, "batcher_restarts") > 0:
                resolution = "batcher_restart"
                evidence = {"batcher_restarts": _metric_value(
                    metrics_rows, "batcher_restarts")}
        elif point == "compactor_build":
            r = _after("compaction", e["seq"])
            n_restarts = _metric_value(metrics_rows,
                                       "bg_compactor_restarts")
            if r is not None:
                resolution = "compaction_resumed"
                evidence = {"next_compaction_seq": r["seq"],
                            "bg_compactor_restarts": n_restarts}
            elif n_restarts > 0:
                resolution = "compactor_restarted"
                evidence = {"bg_compactor_restarts": n_restarts}
        elif point in ("sharded_count", "place_base"):
            r = _after("heal", e["seq"])
            if r is not None:
                resolution = "healed"
                evidence = {"seq": r["seq"],
                            "mesh_width": r.get("mesh_width")}
        elif point == "major_merge":
            r = (_after("major_merge_fallback", e["seq"])
                 or _after("major_merge", e["seq"]))
            if r is not None:
                resolution = r["kind"]
                evidence = {"seq": r["seq"]}
            elif _metric_value(metrics_rows,
                               "major_merge_fallbacks") > 0:
                resolution = "major_merge_fallback"
                evidence = {"major_merge_fallbacks": _metric_value(
                    metrics_rows, "major_merge_fallbacks")}
        elif point in ("train_step", "mc_chunk", "mesh_mc",
                       "estimator", "checkpoint", "dist_init"):
            r = _after("heal", e["seq"])
            if r is not None:
                resolution = "healed"
                evidence = {"seq": r["seq"]}
        entry["resolution"] = resolution
        entry["resolved"] = resolution is not None
        entry["evidence"] = evidence
        faults.append(entry)

    # poison injections: one fault entry PER poisoned stream position,
    # each resolved by the engine's edge validation (poison_reject
    # events / counter)
    rejects = by_kind.get("poison_reject", ())
    n_rejects = max(len(rejects),
                    _metric_value(metrics_rows, "poison_rejects"))
    n_poisoned = 0
    for e in by_kind.get("chaos_poison", ()):
        positions = e.get("at_events") or [None] * int(
            e.get("n_poisoned", 1))
        for pos in positions:
            n_poisoned += 1
            faults.append({
                "kind": "chaos_poison", "point": "poison",
                "seq": e["seq"], "t_wall": e.get("t_wall"),
                "at_event": pos, "trace_id": e.get("trace_id"),
                "trace_span": _span_for_trace(spans, e.get("trace_id")),
                "resolution": ("poison_rejected"
                               if n_poisoned <= n_rejects else None),
                "resolved": n_poisoned <= n_rejects,
                "evidence": {"poison_rejects": n_rejects},
            })
    faults.sort(key=lambda f: f["seq"])
    return faults


def correlate_actuations(flight_events: List[dict],
                         metrics_rows: List[dict]) -> Optional[dict]:
    """Control-plane attribution: one entry per
    ``actuation`` flight event, each judged on the cause→action→effect
    chain the controller promises — a non-null triggering ``signal``
    (the cause) AND at least one metrics snapshot observed after the
    actuation (the effect window: a run that died before the
    post-actuation state was ever recorded cannot claim the actuation
    worked). ``attributed=False`` entries downgrade the verdict to
    ``degraded:unattributed_actuation`` — a controller that cannot
    explain WHY it turned a knob is itself a fault. None when the run
    had no controller (no actuation events)."""
    acts = [e for e in flight_events if e["kind"] == "actuation"]
    if not acts:
        return None
    mono_ts = sorted(r["ts_mono"] for r in metrics_rows
                     if "ts_mono" in r)
    # grace = one flusher cadence (median inter-row gap): the FINAL
    # flush runs its observers after writing its row, so an actuation
    # triggered by the last snapshot of a clean shutdown has its
    # evidence in that row, not after it. A run that died leaves its
    # post-crash actuations well outside one cadence.
    gaps = [b - a for a, b in zip(mono_ts, mono_ts[1:])]
    grace = sorted(gaps)[len(gaps) // 2] if gaps else 1.0
    entries = []
    by_knob: dict = defaultdict(int)
    for e in acts:
        sig = e.get("signal")
        has_signal = isinstance(sig, dict) and bool(sig) \
            and any(v is not None for v in sig.values())
        effect = bool(mono_ts) and (
            mono_ts[-1] >= e["t_mono"]
            or e["t_mono"] - mono_ts[-1] <= grace)
        entries.append({
            "seq": e["seq"], "t_wall": e.get("t_wall"),
            "knob": e.get("knob"), "action": e.get("action"),
            "signal": sig, "has_signal": has_signal,
            "effect_window": effect,
            "attributed": has_signal and effect,
        })
        by_knob[e.get("knob")] += 1
    return {
        "total": len(entries),
        "attributed": sum(1 for a in entries if a["attributed"]),
        "unattributed": sum(1 for a in entries
                            if not a["attributed"]),
        "by_knob": dict(by_knob),
        "events": entries,
    }


# --------------------------------------------------------------------- #
# diagnosis                                                              #
# --------------------------------------------------------------------- #

def _probe(run_dir: str, names: Tuple[str, ...]) -> Optional[str]:
    for n in names:
        p = os.path.join(run_dir, n)
        if os.path.exists(p):
            return p
    return None


def diagnose(metrics_path: Optional[str] = None,
             flight_path: Optional[str] = None,
             spans_path: Optional[str] = None,
             run_dir: Optional[str] = None,
             slo_spec=None, context: Optional[dict] = None,
             top_n: int = 10) -> dict:
    """Build the structured diagnosis report from whatever artifacts
    exist. ``run_dir`` probes default filenames for anything not given
    explicitly (the post-SIGKILL case: point it at --snapshot-dir)."""
    if run_dir:
        metrics_path = metrics_path or _probe(run_dir, _METRICS_NAMES)
        flight_path = flight_path or _probe(run_dir, _FLIGHT_NAMES)
        spans_path = spans_path or _probe(run_dir, _SPAN_NAMES)
    if not (metrics_path or flight_path):
        raise FileNotFoundError(
            "doctor needs at least a metrics.jsonl or a flight dump "
            f"(run_dir={run_dir!r})")

    metrics_rows = load_metrics_rows(metrics_path) if metrics_path \
        and os.path.exists(metrics_path) else []
    flight_events: List[dict] = []
    flight_header: dict = {}
    if flight_path and os.path.exists(flight_path):
        flight_header = FlightRecorder.load_dump(flight_path)
        flight_events = flight_header.pop("events")
    spans = load_spans(spans_path) if spans_path \
        and os.path.exists(spans_path) else []

    report: dict = {
        "artifacts": {
            "metrics": metrics_path, "flight": flight_path,
            "spans": spans_path,
            "metrics_rows": len(metrics_rows),
            "flight_events": len(flight_events),
            "spans_loaded": len(spans),
        },
    }

    # run window + identity from the metrics history
    if metrics_rows:
        first, last = metrics_rows[0], metrics_rows[-1]
        report["run"] = {
            "duration_s": last["ts_mono"] - first["ts_mono"],
            "platform": last.get("platform"),
            "config_digest": last.get("config_digest"),
            "stage": last.get("stage"),
            "events_total": _metric_value(metrics_rows, "events_total"),
        }

    # SLO verdicts over the metrics history
    slo_report = None
    if metrics_rows:
        slo_report = evaluate_history(
            slo_spec if slo_spec is not None else DEFAULT_DOCTOR_SPEC,
            metrics_rows, context=context)
    report["slo"] = slo_report

    # statistical-health verdicts: the monitors' final gauges
    m = metrics_rows[-1]["metrics"] if metrics_rows else {}

    def _g(name):
        return m.get(name, {}).get("value")

    health = {
        "estimate_ci_width": _g("estimate_ci_width"),
        "estimate_std_error": _g("estimate_std_error"),
        "estimate_terms": _g("estimate_terms"),
        "estimate_drift": _g("estimate_drift"),
        "drift_alerts": _g("drift_alerts_total") or 0,
        "shard_skew": _g("shard_skew"),
        "shard_balance_cv": _g("shard_balance_cv"),
    }
    report["health"] = health

    # host-tax ledger: where the insert wall-clock went,
    # judged against the compile-churn / GC-tail thresholds (None and
    # omitted for pre-ledger artifacts)
    from tuplewise_tpu_torch.obs.report import host_tax_block

    host_tax = host_tax_block(m) if m else None
    if host_tax is not None:
        ctx = context or {}
        churn_max = ctx.get("compile_churn_per_1k_batches",
                            COMPILE_CHURN_PER_1K_BATCHES)
        gc_frac = ctx.get("gc_p99_fraction_of_insert",
                          GC_P99_FRACTION_OF_INSERT)
        churn = host_tax.get("compile_events_per_1k_batches")
        host_tax["compile_churn"] = bool(
            churn is not None and churn > churn_max)
        ins_p99 = m.get("insert_latency_s", {}).get("p99")
        gc_p99_ms = host_tax.get("gc_pause_p99_ms")
        host_tax["gc_in_p99"] = bool(
            ins_p99 and gc_p99_ms is not None
            and (host_tax.get("gc_pauses") or 0) >= GC_MIN_PAUSES
            and gc_p99_ms >= gc_frac * ins_p99 * 1e3)
        report["host_tax"] = host_tax

    # silently-degraded serving paths: a fallen-
    # back count kernel or a fleet stuck re-shipping full packs used
    # to read "healthy" because nothing surfaced the counters
    kernel = {
        "count_kernel_calls": _g("count_kernel_calls_total") or 0,
        "count_kernel_fallbacks": _g("count_kernel_fallbacks_total")
        or 0,
        "pack_replaces": _g("pack_replaces_total") or 0,
        "pack_full_replaces": _g("pack_full_replaces_total") or 0,
    }
    if any(kernel.values()):
        report["kernel"] = kernel

    # per-tenant breakdown: fleet runs carry tenant-labeled
    # metrics; surface them grouped so the doctor answers "WHICH
    # tenant" in one read (None and omitted for single-tenant runs)
    tenants = tenant_breakdown(metrics_rows)
    if tenants is not None:
        report["tenants"] = tenants

    # fault -> breach correlation
    faults = correlate_faults(flight_events, metrics_rows, spans)
    report["faults"] = faults

    # control-plane attribution: every actuation tied to
    # its triggering signal + an observed effect window (None and
    # omitted when the run had no controller)
    actuations = correlate_actuations(flight_events, metrics_rows)
    if actuations is not None:
        report["actuations"] = actuations
    kinds: dict = {}
    for e in flight_events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    report["flight_summary"] = kinds

    report["top_self_spans"] = top_self_spans(spans, top_n)

    # the recovery counter block every exit summary carries, read from
    # the final snapshot — same builder, same keys (report parity)
    if metrics_rows:
        from tuplewise_tpu_torch.obs.report import recovery_counters

        report["recovery_counters"] = recovery_counters(m)

    report["verdict"] = _verdict(report, kinds)
    report["verdict_line"] = verdict_line(report)
    return report


def _verdict(report: dict, kinds: dict) -> str:
    degraded = []
    slo = report.get("slo")
    if slo is not None and not slo["healthy"]:
        degraded.append("slo_breached")
    if report["health"]["drift_alerts"]:
        degraded.append("estimate_drift")
    if kinds.get("heal_exhausted"):
        degraded.append("heal_exhausted")
    if kinds.get("snapshot_error"):
        degraded.append("snapshot_error")
    # host-tax verdicts: steady-state compiles on the
    # request thread / a GC tail rivaling the insert p99
    host_tax = report.get("host_tax")
    if host_tax is not None:
        if host_tax.get("compile_churn"):
            degraded.append("compile_on_request_thread")
        if host_tax.get("gc_in_p99"):
            degraded.append("gc_in_p99")
    # a fallen-back count kernel serves correct counts SLOWLY — that
    # is degradation, not health
    if (report.get("kernel") or {}).get("count_kernel_fallbacks"):
        degraded.append("count_kernel_fallback")
    unresolved = [f for f in report["faults"] if not f["resolved"]]
    if unresolved:
        degraded.append(f"{len(unresolved)}_unresolved_faults")
    # an actuation without a triggering signal or an observed effect
    # window means the control plane acted unexplained
    acts = report.get("actuations")
    if acts is not None and acts["unattributed"]:
        degraded.append("unattributed_actuation")
    if degraded:
        return "degraded:" + ",".join(degraded)
    # failures that DID happen and were recovered from
    had_failures = (bool(report["faults"])
                    or kinds.get("batcher_restart")
                    or kinds.get("heal"))
    return "recovered" if had_failures else "healthy"


def verdict_line(report: dict) -> dict:
    """The one-line machine-readable verdict (last stdout line of the
    CLI; ``tail -n 1`` is the whole CI integration)."""
    v = report["verdict"]
    slo = report.get("slo") or {}
    acts = report.get("actuations") or {}
    return {
        "doctor_verdict": v.split(":", 1)[0],
        "detail": v.split(":", 1)[1] if ":" in v else None,
        "healthy": v in ("healthy", "recovered"),
        "faults": len(report["faults"]),
        "faults_resolved": sum(1 for f in report["faults"]
                               if f["resolved"]),
        "slo_breaches": sum(
            o["breaches_total"]
            for o in slo.get("objectives", {}).values()),
        "drift_alerts": report["health"]["drift_alerts"],
        "actuations": acts.get("total", 0),
        "actuations_attributed": acts.get("attributed", 0),
        # the headline host-tax number: the fraction the
        # one-dispatch refactor exists to move (None pre-ledger)
        "host_fraction": (report.get("host_tax")
                          or {}).get("host_fraction"),
    }


def main(args) -> int:
    """CLI entry point (argparse namespace from harness/cli.py):
    pretty report to stdout, the machine verdict as the LAST stdout
    line; exit 0 on healthy/recovered, 2 on degraded."""
    report = diagnose(
        metrics_path=args.metrics, flight_path=args.flight,
        spans_path=args.spans, run_dir=args.dir,
        slo_spec=args.slo_spec, top_n=args.top_spans)
    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    line = report.pop("verdict_line")
    if not args.quiet:
        print(json.dumps(report, indent=2))
    print(json.dumps(line))
    return 0 if line["healthy"] else 2
