"""CI leg of the port's static invariant checks (the counterpart of the
JAX package's ``scripts/analysis_gate.py``; the same flags, diffs and
verdict line): run ``tuplewise-torch check`` in-process, write the JSON
report artifact (and optionally SARIF for inline PR annotations), diff
the overflow certificate AND the hotpath cost certificate against their
committed baselines, and fail on any unwaived finding, waiver-file
error, parse error, import cycle, or certificate drift.

The finding ratchet lives in the waiver semantics (each waiver absorbs a
bounded count: ``tuplewise_tpu_torch/analysis/waivers.py``). Both
certificates have baselines by design:

* ``tuplewise_tpu_torch/analysis/exactness_bounds.toml``: the declared
  int32 accumulators' bounds at the compile-ladder maxima, so a ladder
  bump that breaks int32 safety fails with the violating bound NAMED.
* ``tuplewise_tpu_torch/analysis/hotpath_budget.toml``: the
  per-request-path-root host-cost counters. A counter that GROWS fails
  naming the root, the contributing sites, and the violated budget line;
  a counter that SHRINKS is the downward ratchet: the gate rewrites the
  budget file in place so the improvement is committed with the change.

The gate also asserts the parse cache actually caches: a second in-job
corpus load must hit (> 0 hits) or the gate fails.

Every artifact lands under ``results/torch/`` by default, never in the
JAX package's ``results/``.

Usage: python scripts_torch/analysis_gate.py
           [--out results/torch/analysis_report.json]
           [--sarif results/torch/analysis_report.sarif]
           [--hotpath-out results/torch/hotpath_certificate.json]
           [--update-hotpath-budget] [--no-cache] [--jobs N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASELINE = os.path.join(
    REPO, "tuplewise_tpu_torch", "analysis", "exactness_bounds.toml")
HOTPATH_BUDGET = os.path.join(
    REPO, "tuplewise_tpu_torch", "analysis", "hotpath_budget.toml")
RESULTS = os.path.join(REPO, "results", "torch")

_SARIF_RULE_HELP = {
    "race-unguarded-shared":
        "attribute shared across thread roles with an unguarded "
        "access",
    "race-inconsistent-guard":
        "attribute shared across thread roles with no common guard "
        "lock",
    "count-float-taint":
        "float-tainted value flows into an integer win-count "
        "accumulator",
    "count-narrow-accumulator":
        "raw int32 device value accumulated without widening",
    "overflow-int32":
        "int32 accumulator bound exceeds 2^31-1 at ladder maxima",
    "overflow-unproved":
        "count launcher or declared accumulator without a bound",
    "hotpath-root-missing":
        "declared request-path root no longer defined in the corpus",
    "future-leak":
        "request futures can be stranded unresolved on an exception "
        "path",
    "future-double-resolve":
        "future resolution without done() guard or try arbitration "
        "in a multi-resolver class",
    "future-close-leak":
        "close() never reaches a drain that fails queued futures",
    "thread-undisciplined":
        "Thread/Timer neither daemonized nor joined/cancelled from a "
        "lifecycle method",
    "handle-leak":
        "file handle opened outside `with` with no owning close on "
        "the exception path",
    "error-unhandled-protocol":
        "typed serving error with no {\"error\": ...} wire handler",
    "error-not-doctor-visible":
        "typed serving error invisible to obs/report.py and "
        "obs/doctor.py",
    "error-undocumented":
        "typed serving error README/DESIGN never mention",
}


def to_sarif(report: dict) -> dict:
    """SARIF 2.1.0 — one run, one result per finding (waived findings
    ride along at 'note' level with a suppression record, so the PR
    annotation layer shows them greyed out, not red)."""
    rules = {}
    results = []

    def add(f: dict, level: str, suppressed: bool,
            reason: str = "") -> None:
        rid = f["rule"]
        rules.setdefault(rid, {
            "id": rid,
            "shortDescription": {
                "text": _SARIF_RULE_HELP.get(
                    rid, f"tuplewise-torch invariant rule {rid}")},
        })
        res = {
            "ruleId": rid,
            "level": level,
            "message": {"text": f["message"]},
            "partialFingerprints": {
                "tuplewiseFingerprint/v1": f["fingerprint"]},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f["file"],
                        "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(int(f["line"]), 1)},
                }}],
        }
        if suppressed:
            res["suppressions"] = [{
                "kind": "external",
                "justification": reason or "waived in "
                "tuplewise_tpu_torch/analysis/waivers.toml"}]
        results.append(res)

    for f in report["findings"]:
        add(f, "error", suppressed=False)
    for f in report.get("waived", ()):
        add(f, "note", suppressed=True, reason=f.get("reason", ""))
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0"
                    ".json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "tuplewise-torch-check",
                "informationUri":
                    "docs/DESIGN.md#17-static-invariant-checks",
                "rules": sorted(rules.values(),
                                key=lambda r: r["id"]),
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str,
                    default=os.path.join(RESULTS, "analysis_report.json"))
    ap.add_argument("--sarif", type=str, default=None,
                    help="also write a SARIF 2.1.0 report here "
                         "(uploaded next to the JSON so findings "
                         "render as inline PR annotations)")
    ap.add_argument("--hotpath-out", type=str,
                    default=os.path.join(RESULTS,
                                         "hotpath_certificate.json"),
                    help="write the hotpath cost certificate artifact "
                         "here")
    ap.add_argument("--update-hotpath-budget", action="store_true",
                    help="rewrite the committed hotpath budget from "
                         "the freshly derived certificate (first "
                         "generation / reviewed re-baseline)")
    ap.add_argument("--jobs", type=int, default=None,
                    help="worker processes for the passes (default "
                         "auto)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the content-sha parse cache")
    args = ap.parse_args(argv)

    from tuplewise_tpu_torch.analysis import exactness, hotpath
    from tuplewise_tpu_torch.analysis.runner import run_checks

    report = run_checks(root=REPO, use_cache=not args.no_cache,
                        jobs=args.jobs)

    # overflow-certificate baseline diff: the derived bound table must
    # match the committed envelope exactly
    cert_errors = []
    if os.path.exists(BASELINE):
        with open(BASELINE, "r", encoding="utf-8") as f:
            cert_errors = exactness.compare_to_baseline(
                report["overflow_certificate"], f.read())
    else:
        cert_errors = [f"missing committed baseline {BASELINE}"]
    report["certificate_diff"] = cert_errors
    if cert_errors:
        report["ok"] = False

    # hotpath-budget diff: growth fails naming root + site + budget
    # line; shrinkage ratchets the committed file downward.
    # The second-in-job cache probe runs FIRST — the budget rewrite
    # below changes the cache epoch, which must not void the probe.
    cache_second_hits = None
    if not args.no_cache:
        from tuplewise_tpu_torch.analysis.cache import (
            ParseCache, compute_epoch,
        )
        from tuplewise_tpu_torch.analysis.core import ModuleSet

        probe = ParseCache(REPO, epoch=compute_epoch(REPO))
        ModuleSet.from_repo(REPO, cache=probe)
        cache_second_hits = probe.stats()["hits"]
        if cache_second_hits <= 0:
            report["ok"] = False
            report.setdefault("gate_errors", []).append(
                "parse cache never hits: the second in-job corpus "
                "load re-parsed everything — the epoch/key logic "
                "broke")

    hot_cert = report.get("hotpath_certificate")
    hot_errors, hot_shrinks = [], []
    if hot_cert is None:
        hot_errors = ["runner produced no hotpath certificate"]
    elif args.update_hotpath_budget:
        with open(HOTPATH_BUDGET, "w", encoding="utf-8") as f:
            f.write(hotpath.format_budget(hot_cert))
        print(f"hotpath budget rewritten: {HOTPATH_BUDGET}",
              file=sys.stderr)
    elif os.path.exists(HOTPATH_BUDGET):
        with open(HOTPATH_BUDGET, "r", encoding="utf-8") as f:
            hot_errors, hot_shrinks = hotpath.compare_to_budget(
                hot_cert, f.read())
        if not hot_errors and hot_shrinks:
            # the downward ratchet: commit the improvement
            with open(HOTPATH_BUDGET, "w", encoding="utf-8") as f:
                f.write(hotpath.format_budget(hot_cert))
    else:
        hot_errors = [f"missing committed budget {HOTPATH_BUDGET} — "
                      "generate it with --update-hotpath-budget and "
                      "commit after review"]
    report["hotpath_budget_diff"] = hot_errors
    report["hotpath_budget_ratchet"] = hot_shrinks
    if hot_errors:
        report["ok"] = False

    if args.hotpath_out and hot_cert is not None:
        os.makedirs(os.path.dirname(args.hotpath_out) or ".",
                    exist_ok=True)
        with open(args.hotpath_out, "w", encoding="utf-8") as f:
            json.dump({"stage": "hotpath_certificate",
                       "certificate": hot_cert,
                       "budget_diff": hot_errors,
                       "ratchet": hot_shrinks}, f, indent=2)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    if args.sarif:
        os.makedirs(os.path.dirname(args.sarif) or ".", exist_ok=True)
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(to_sarif(report), f, indent=2)

    s = report["summary"]
    c = s["cache"]
    t = s["timings"]
    print(f"ANALYSIS GATE: {s['files_analyzed']} files, "
          f"{s['findings_total']} findings "
          f"({s['waived']} waived, {s['unwaived']} unwaived), "
          f"{len(report['import_cycles'])} import cycles, "
          f"{len(report['dead_symbols'])} dead public symbols "
          f"(warn-only), cache {c['hits']}/{c['hits'] + c['misses']} "
          f"hits (2nd run {cache_second_hits}), "
          f"{t['total_s']:.2f}s jobs={t['jobs']}, certificate "
          f"{'OK' if not cert_errors else 'DRIFT'}, hotpath budget "
          f"{'OK' if not hot_errors else 'DRIFT'}"
          + (f" (ratcheted {len(hot_shrinks)} counters down)"
             if hot_shrinks else ""), file=sys.stderr)
    for f_ in report["findings"]:
        print(f"  UNWAIVED {f_['rule']}: {f_['file']}:{f_['line']} "
              f"[{f_['symbol']}] {f_['message']}", file=sys.stderr)
    if report.get("waiver_error"):
        print(f"  WAIVER FILE ERROR: {report['waiver_error']}",
              file=sys.stderr)
    for w in report["unused_waivers"]:
        print(f"  stale waiver: {w['rule']} {w['file']} "
              f"[{w['symbol']}] (waivers.toml:{w['line']})",
              file=sys.stderr)
    for e in cert_errors:
        print(f"  CERTIFICATE: {e}", file=sys.stderr)
    for e in hot_errors:
        print(f"  HOTPATH BUDGET: {e}", file=sys.stderr)
    for e in hot_shrinks:
        print(f"  hotpath ratchet (budget rewritten): {e}",
              file=sys.stderr)
    for e in report.get("gate_errors", ()):
        print(f"  GATE: {e}", file=sys.stderr)
    # one machine-readable verdict line on stdout (the doctor/perf-gate
    # convention: tail -n 1 | json)
    print(json.dumps({"stage": "analysis_gate", "ok": report["ok"],
                      "unwaived": s["unwaived"],
                      "waived": s["waived"],
                      "unused_waivers": s["waivers_unused"],
                      "certificate_ok": not cert_errors,
                      "hotpath_budget_ok": not hot_errors,
                      "hotpath_ratcheted": len(hot_shrinks),
                      "cache_hits": c["hits"],
                      "cache_second_run_hits": cache_second_hits}))
    if not report["ok"]:
        print("ANALYSIS GATE FAIL (report in "
              f"{args.out})", file=sys.stderr)
        return 1
    print("ANALYSIS GATE OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
