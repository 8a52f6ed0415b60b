"""Perf-regression sentinel over the port's serving trajectory (the
counterpart of the JAX package's ``scripts/perf_gate.py``; the same
loader, history join, bands, stage specs and modes).

``<results>/serving.jsonl`` (default ``results/torch/serving.jsonl``,
never the JAX package's ``results/serving.jsonl``) is the port's
append-only serving history. This gate compares the NEWEST row of each
gated stage against the history of comparable rows with noise bands:

    center = median(history)
    band   = max(tolerance_frac * center, mad_k * 1.4826 * MAD)

(the MAD term widens the band when the history itself is noisy, while
``tolerance_frac`` keeps a floor so two identical historic rows don't
produce a zero-width band). A breach is

    events_per_s          below  center - band      (throughput), or
    insert_latency_p99_ms above  center + band      (tail latency),

and each stage of ``_STAGE_METRICS`` bands its own metrics. Rows are
joined on their ``config_digest``; rows without a digest join on the
config fields that determine comparability (n_events / bg_compact /
max_inflight / max_batch).

Modes: ``--mode warn`` reports breaches and always exits 0; ``--mode
fail`` exits 1 on a breach. The default band floor is 25 % of the
history median (cross-host run noise; ``--tolerance-frac 0.15`` for
same-host comparisons). Where the history holds no row of a gated stage,
the gate says "no gateable rows" and exits 0. It touches no device.

Writes the verdict row (stage ``perf_gate``, per-stage verdicts under
``stages``) to ``--out`` (default ``<results>/perf_gate.jsonl``) and
prints it as one stdout JSON line.

Usage: python scripts_torch/perf_gate.py [--history PATH]
           [--mode warn|fail] [--stage bench_streaming,...] [--out PATH]
(``main(argv, results=DIR)`` reads and writes in DIR.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from statistics import median

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results", "torch")

# metric -> direction ("min" = lower is better)
_GATED = (("events_per_s", "max", "value"),
          ("insert_latency_p99_ms", "min", "insert_latency_p99_ms"))

# per-stage metric specs: each stage bands its own trajectory. Value
# fields are dotted paths into the row.
_STAGE_METRICS = {
    "bench_streaming": _GATED,
    "multi_tenant": (
        ("events_per_s_T256", "max", "cells.256.events_per_s"),
        ("insert_p99_ms_T256", "min", "cells.256.insert_p99_ms"),
    ),
    "fleet_incremental": (
        ("events_per_s", "max", "events_per_s"),
        ("insert_latency_p99_ms", "min", "insert_latency_p99_ms"),
        ("bytes_per_replace", "min", "bytes_per_replace"),
    ),
    # fused counts: kernel-mode throughput/p99 band against their own
    # history, and the one-launch-per-micro-batch witness must stay
    # exactly 1.0 (any drift means the fusion quietly split)
    "serving_kernel": (
        ("events_per_s", "max", "events_per_s"),
        ("insert_latency_p99_ms", "min", "insert_latency_p99_ms"),
        ("kernel_calls_per_batch", "min", "kernel_calls_per_batch"),
    ),
    # host-tax budget: the ledger row of a streaming benchmark run. Host
    # fraction creeping UP, steady-state compile events per 1k batches
    # UP, or the GC pause tail UP are quiet request-path regressions the
    # throughput band can miss entirely (a 5% host-fraction climb hides
    # inside the 25% events/s band).
    "host_tax": (
        ("host_fraction", "min", "host_fraction"),
        ("compile_events_per_1k", "min",
         "compile_events_per_1k_batches"),
        ("gc_pause_p99_ms", "min", "gc_pause_p99_ms"),
    ),
}
_DEFAULT_STAGES = ("bench_streaming,multi_tenant,fleet_incremental,"
                   "serving_kernel,host_tax")

# the config fields that make two bench_streaming rows comparable when
# no config_digest is stamped
_LEGACY_KEY = ("n_events", "bg_compact", "max_inflight", "max_batch")


def load_rows(path: str, stage: str):
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if row.get("stage") == stage:
                rows.append(row)
    return rows


def _legacy_key(row: dict):
    return tuple(row.get(k) for k in _LEGACY_KEY)


def comparable_history(rows, newest):
    """History rows comparable to the newest one: same config_digest
    when both sides carry one, else same legacy config fields."""
    digest = newest.get("config_digest")
    out = []
    for r in rows[:-1]:
        if digest and r.get("config_digest"):
            if r["config_digest"] == digest:
                out.append(r)
        elif _legacy_key(r) == _legacy_key(newest):
            out.append(r)
    return out


def _get_path(row: dict, path: str):
    """Resolve a dotted path ("cells.256.events_per_s") into a row."""
    cur = row
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def _value(row: dict, metric: str, value_field: str):
    # bench_streaming's events_per_s lives under "value" (metric field
    # says events/sec); everything else resolves by (dotted) path
    if value_field == "value":
        v = row.get("value")
        if v is None:
            v = row.get("events_per_s")
        return v
    return _get_path(row, value_field)


def _mad(xs, center):
    return median([abs(x - center) for x in xs])


def gate(rows, tolerance_frac: float, mad_k: float,
         min_history: int, metrics=_GATED) -> dict:
    newest = rows[-1]
    hist = comparable_history(rows, newest)
    verdict = {
        "stage": "perf_gate",
        "run_id": newest.get("run_id"),
        "config_digest": newest.get("config_digest"),
        "n_history": len(hist),
        "min_history": min_history,
        "tolerance_frac": tolerance_frac,
        "mad_k": mad_k,
        "checks": [],
        "ok": True,
    }
    if len(hist) < min_history:
        verdict["note"] = (
            f"insufficient comparable history ({len(hist)} < "
            f"{min_history}) — gate passes vacuously")
        return verdict
    for metric, direction, field in metrics:
        new = _value(newest, metric, field)
        xs = [v for v in (_value(r, metric, field) for r in hist)
              if v is not None]
        if new is None or len(xs) < min_history:
            verdict["checks"].append({
                "metric": metric, "ok": True,
                "note": "metric missing from newest row or history"})
            continue
        center = median(xs)
        band = max(tolerance_frac * abs(center),
                   mad_k * 1.4826 * _mad(xs, center))
        if direction == "max":
            breach = (center - new) > band
            limit = center - band
        else:
            breach = (new - center) > band
            limit = center + band
        verdict["checks"].append({
            "metric": metric, "direction": direction, "new": new,
            "median": center, "band": band, "limit": limit,
            "n": len(xs), "ok": not breach,
        })
        if breach:
            verdict["ok"] = False
    return verdict


def main(argv=None, *, results: str | None = None) -> int:
    results = results or RESULTS
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--history", type=str,
                    default=os.path.join(results, "serving.jsonl"))
    ap.add_argument("--stage", "--stages", dest="stages", type=str,
                    default=_DEFAULT_STAGES,
                    help="comma-separated stages to gate (each with "
                         "its own metric spec; unknown stages use the "
                         "bench_streaming spec)")
    ap.add_argument("--mode", choices=["warn", "fail"], default="warn")
    ap.add_argument("--min-history", type=int, default=2)
    ap.add_argument("--tolerance-frac", type=float, default=0.25,
                    help="relative band floor (0.25 = 25%% of the "
                         "history median — calibrated to measured "
                         "cross-container run noise; use 0.15 for "
                         "same-host comparisons)")
    ap.add_argument("--mad-k", type=float, default=4.0,
                    help="band widens to k robust-sigmas (1.4826*MAD) "
                         "when the history itself is noisy")
    ap.add_argument("--out", type=str,
                    default=os.path.join(results, "perf_gate.jsonl"))
    args = ap.parse_args([] if argv is None else argv)

    if not os.path.exists(args.history):
        print(f"PERF GATE: no history file {args.history!r} — "
              "nothing to gate", file=sys.stderr)
        return 0
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    stage_verdicts = {}
    for stage in stages:
        rows = load_rows(args.history, stage)
        if not rows:
            print(f"PERF GATE: no {stage!r} rows in {args.history!r}",
                  file=sys.stderr)
            continue
        v = gate(rows, args.tolerance_frac, args.mad_k,
                 args.min_history,
                 metrics=_STAGE_METRICS.get(stage, _GATED))
        v["gated_stage"] = stage
        stage_verdicts[stage] = v
    if not stage_verdicts:
        print(f"PERF GATE: no gateable rows in {args.history!r}",
              file=sys.stderr)
        return 0

    verdict = {
        "stage": "perf_gate",
        "mode": args.mode,
        "ok": all(v["ok"] for v in stage_verdicts.values()),
        "stages": stage_verdicts,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(json.dumps(verdict) + "\n")
    print(json.dumps(verdict))
    if not verdict["ok"]:
        bad = [f"{s}:{c['metric']}"
               for s, v in stage_verdicts.items()
               for c in v["checks"] if not c["ok"]]
        msg = (f"PERF GATE {'FAIL' if args.mode == 'fail' else 'WARN'}:"
               f" regression in {bad} (bands in {args.out})")
        print(msg, file=sys.stderr)
        if args.mode == "fail":
            return 1
    else:
        n_checks = sum(len(v["checks"])
                       for v in stage_verdicts.values())
        print(f"PERF GATE OK: {n_checks} checks across "
              f"{len(stage_verdicts)} stages", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
