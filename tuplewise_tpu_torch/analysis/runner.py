"""``tuplewise-torch check`` — run the invariant passes (the five
syntactic ones, the flow-sensitive dataflow tier, the host-cost and
lifecycle tier) plus the module-graph report over the port, apply the
committed waiver file, and render one JSON report.

The report carries the **overflow certificate** (per-int32-accumulator
worst-case bounds at the compile-ladder maxima), the **hotpath
certificate** (per-request-path-root abstract cost
summaries, diffed by the gate against the committed
``analysis/hotpath_budget.toml`` — growth fails, shrinkage ratchets),
the parse-cache counters (epoch-keyed: a waiver/budget/checker edit
forces a cold run), and a per-pass **timing block** (independent
passes run concurrently on multi-core hosts; ``--jobs 1`` forces the
serial path).

``--diff <ref>`` restricts reported findings to
files changed vs a git ref PLUS their reverse-dependency closure from
the module graph — the fast pre-commit loop
(``scripts_torch/pre-commit.sh``). Stale waivers never fail a diff run
(out-of-scope findings legitimately match nothing).

Exit status: 0 = no unwaived findings (waived ones are listed, not
fatal); 1 = at least one unwaived finding, a malformed waiver file, or
(``--strict``) a stale waiver matching nothing. The CI leg
(``scripts_torch/analysis_gate.py``) runs this in fail mode, diffs both
certificates against their committed baselines, and uploads the JSON
(and ``--sarif``) artifacts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from tuplewise_tpu_torch.analysis import compile_ladder
from tuplewise_tpu_torch.analysis import config_drift
from tuplewise_tpu_torch.analysis import exactness
from tuplewise_tpu_torch.analysis import hotpath
from tuplewise_tpu_torch.analysis import lifecycle
from tuplewise_tpu_torch.analysis import lock_order
from tuplewise_tpu_torch.analysis import modgraph
from tuplewise_tpu_torch.analysis import races
from tuplewise_tpu_torch.analysis import telemetry_xref
from tuplewise_tpu_torch.analysis import traced_purity
from tuplewise_tpu_torch.analysis.cache import ParseCache, compute_epoch
from tuplewise_tpu_torch.analysis.core import Finding, ModuleSet
from tuplewise_tpu_torch.analysis.waivers import (
    WaiverError, apply_waivers, load_waivers,
)

#: (name, pass callable) — five syntactic passes, the two
#: dataflow-tier passes, the host-cost / lifecycle tier
#:, and the module-graph report
PASSES: Tuple[Tuple[str, Callable[[ModuleSet], List[Finding]]], ...] = (
    ("lock-order", lock_order.run),
    ("traced-purity", traced_purity.run),
    ("telemetry-xref", telemetry_xref.run),
    ("compile-ladder", compile_ladder.run),
    ("config-drift", config_drift.run),
    ("races", races.run),
    ("exactness", exactness.run),
    ("hotpath", hotpath.run),
    ("lifecycle", lifecycle.run),
    ("module-graph", modgraph.run),
)

DEFAULT_WAIVERS = "tuplewise_tpu_torch/analysis/waivers.toml"

#: per-pass wall-clock budget inside the process pool before the
#: runner falls back to computing that pass serially
_POOL_PASS_TIMEOUT_S = 300.0

#: the forked workers read this; fork shares it copy-on-write so the
#: parsed corpus is never pickled per task
_POOL_MS: Optional[ModuleSet] = None


def repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def _run_one(name: str, ms: ModuleSet):
    """(findings, hotpath certificate or None, seconds) for one pass.
    The hotpath pass derives its findings FROM the certificate, so
    one derivation serves both the findings and the report key."""
    t0 = time.perf_counter()
    if name == "hotpath":
        cert = hotpath.certificates(ms)
        fs = hotpath.missing_findings(cert)
    else:
        cert = None
        fs = dict(PASSES)[name](ms)
    return fs, cert, time.perf_counter() - t0


def _pool_worker(name: str):
    return (name,) + _run_one(name, _POOL_MS)


def _default_jobs() -> int:
    cpus = os.cpu_count() or 1
    if cpus <= 2 or not hasattr(os, "fork"):
        return 1    # fork overhead beats the win on small boxes
    return min(len(PASSES), cpus)


def _run_passes(ms: ModuleSet, jobs: Optional[int]
                ) -> Tuple[Dict[str, List[Finding]],
                           Dict[str, float], Optional[dict], int]:
    """Run every pass, concurrently when the host has the cores for
    it. Returns (per-pass findings, per-pass
    seconds, hotpath certificate, effective jobs). Pass results are
    deterministic and independent, so parallel == serial output by
    construction; any pool failure falls back to the serial path for
    whatever is missing."""
    jobs = _default_jobs() if jobs is None else max(1, int(jobs))
    results: Dict[str, List[Finding]] = {}
    timings: Dict[str, float] = {}
    cert: Optional[dict] = None
    if jobs > 1:
        global _POOL_MS
        try:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            ctx = multiprocessing.get_context("fork")
            _POOL_MS = ms
            with ProcessPoolExecutor(max_workers=jobs,
                                     mp_context=ctx) as ex:
                futs = {ex.submit(_pool_worker, name): name
                        for name, _fn in PASSES}
                for fut, name in futs.items():
                    try:
                        rname, fs, c, secs = fut.result(
                            timeout=_POOL_PASS_TIMEOUT_S)
                        results[rname] = fs
                        timings[rname] = secs
                        if c is not None:
                            cert = c
                    except Exception:
                        pass    # recomputed serially below
        except Exception:
            jobs = 1
        finally:
            _POOL_MS = None
    for name, _fn in PASSES:
        if name in results:
            continue
        fs, c, secs = _run_one(name, ms)
        results[name] = fs
        timings[name] = secs
        if c is not None:
            cert = c
    return results, timings, cert, jobs


def _git_changed(root: str, ref: str) -> Optional[Set[str]]:
    """Files changed vs ``ref`` (tracked diff + untracked), repo-
    relative; None when git is unavailable / ref unresolvable."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", ref],
            cwd=root, capture_output=True, text=True, timeout=30)
        if diff.returncode != 0:
            return None
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=30)
        out = {ln.strip() for ln in diff.stdout.splitlines()
               if ln.strip()}
        if untracked.returncode == 0:
            out |= {ln.strip() for ln in untracked.stdout.splitlines()
                    if ln.strip()}
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def run_checks(root: Optional[str] = None,
               waivers_path: Optional[str] = None,
               strict: bool = False,
               ms: Optional[ModuleSet] = None,
               use_cache: bool = True,
               jobs: Optional[int] = None,
               diff_ref: Optional[str] = None) -> dict:
    """The whole check as one JSON-able report dict; ``ms`` overrides
    the repo walk (fixture tests)."""
    t_total = time.perf_counter()
    root = root or repo_root()
    cache = None
    if ms is None:
        cache = ParseCache(root, epoch=compute_epoch(root)) \
            if use_cache else None
        ms = ModuleSet.from_repo(root, cache=cache)

    per_pass_findings, pass_timings, hot_cert, jobs_used = \
        _run_passes(ms, jobs)
    findings: List[Finding] = []
    per_pass = {}
    for name, _fn in PASSES:
        fs = per_pass_findings[name]
        per_pass[name] = len(fs)
        findings.extend(fs)
    findings.sort(key=lambda f: (f.rule, f.file, f.symbol))

    # --diff: scope findings to the changed
    # files + their reverse-dependency closure. Findings without a
    # real file (module-graph cycles) stay in scope.
    diff_info = None
    if diff_ref is not None:
        changed = _git_changed(root, diff_ref)
        if changed is None:
            diff_info = {"ref": diff_ref, "error":
                         "git diff failed — running unscoped"}
        else:
            scope = modgraph.reverse_closure(
                ms, {p for p in changed if p in ms.modules})
            scope |= changed
            findings = [f for f in findings
                        if f.file in scope
                        or not f.file.endswith(".py")]
            diff_info = {"ref": diff_ref,
                         "changed": sorted(changed & set(ms.modules)),
                         "scope": sorted(scope & set(ms.modules))}

    waiver_error = None
    waivers = []
    wpath = waivers_path
    if wpath is None:
        cand = os.path.join(root, DEFAULT_WAIVERS)
        wpath = cand if os.path.exists(cand) else None
    if wpath:
        try:
            with open(wpath, "r", encoding="utf-8") as f:
                waivers = load_waivers(f.read())
        except WaiverError as e:
            waiver_error = str(e)

    unwaived, waived, unused = apply_waivers(findings, waivers)
    if diff_info is not None:
        unused = []     # out-of-scope findings legitimately unmatched

    # overflow certificate: the per-accumulator bound table
    # at the declared compile-ladder maxima; ok=False bounds already
    # surfaced as overflow-int32 findings through the exactness pass
    cert = exactness.certificates(ms)

    # graph reports, timed so total_s covers the WHOLE check
    t0 = time.perf_counter()
    import_cycles = [cyc for cyc in modgraph.find_cycles(
        modgraph.import_graph(ms))]
    dead = modgraph.dead_symbols(ms)
    pass_timings["module-graph"] = pass_timings.get(
        "module-graph", 0.0) + (time.perf_counter() - t0)

    ok = not unwaived and waiver_error is None \
        and not ms.parse_errors and not (strict and unused)
    report = {
        "stage": "tuplewise_check",
        "ok": ok,
        "summary": {
            "files_analyzed": len(ms.modules),
            "findings_total": len(findings),
            "unwaived": len(unwaived),
            "waived": len(waived),
            "waivers_unused": len(unused),
            "per_pass": per_pass,
            "cache": (cache.stats() if cache is not None
                      else {"enabled": False, "hits": 0,
                            "misses": 0}),
            "timings": {
                "jobs": jobs_used,
                "passes_s": {k: round(v, 4)
                             for k, v in sorted(pass_timings.items())},
                "total_s": round(time.perf_counter() - t_total, 4),
            },
        },
        "overflow_certificate": cert,
        "hotpath_certificate": hot_cert,
        "findings": [f.to_dict() for f in unwaived],
        "waived": [dict(f.to_dict(), reason=w.reason,
                        waiver_line=w.line) for f, w in waived],
        "unused_waivers": [
            {"rule": w.rule, "file": w.file, "symbol": w.symbol,
             "line": w.line} for w in unused],
        "parse_errors": dict(ms.parse_errors),
        "import_cycles": import_cycles,
        "dead_symbols": dead,
    }
    if diff_info is not None:
        report["diff"] = diff_info
    if waiver_error is not None:
        report["waiver_error"] = waiver_error
    return report


def main(args) -> int:
    """CLI entry (argparse namespace from harness/cli.py)."""
    report = run_checks(root=args.root, waivers_path=args.waivers,
                        strict=args.strict,
                        use_cache=not getattr(args, "no_cache",
                                              False),
                        jobs=getattr(args, "jobs", None),
                        diff_ref=getattr(args, "diff", None))
    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        s = report["summary"]
        c = s["cache"]
        t = s["timings"]
        cache_note = (f", cache {c['hits']} hit/{c['misses']} miss"
                      if c["enabled"] else ", cache off")
        diff_note = ""
        if "diff" in report:
            d = report["diff"]
            diff_note = (f", diff vs {d['ref']} "
                         f"({len(d.get('scope', []))} files in scope)")
        print(f"tuplewise-torch check: {s['files_analyzed']} files, "
              f"{s['findings_total']} findings "
              f"({s['waived']} waived, {s['unwaived']} unwaived)"
              f"{cache_note}{diff_note}, {t['total_s']:.2f}s "
              f"(jobs={t['jobs']})")
        for f in report["findings"]:
            print(f"  {f['rule']}: {f['file']}:{f['line']} "
                  f"[{f['symbol']}]\n    {f['message']}")
        if report.get("waiver_error"):
            print(f"  waiver file error: {report['waiver_error']}",
                  file=sys.stderr)
        for w in report["unused_waivers"]:
            print(f"  stale waiver (matched nothing): {w['rule']} "
                  f"{w['file']} [{w['symbol']}] "
                  f"(waivers.toml:{w['line']})")
        if report["dead_symbols"]:
            print(f"  note: {len(report['dead_symbols'])} unreferenced "
                  "public symbols (warn-only; see --json)")
        print("OK" if report["ok"] else "FAIL")
    return 0 if report["ok"] else 1
