"""Fixture + repo tests for the host-cost certification tier: per-root
cost certificates (counter families, loop classification,
interprocedural multiplicity propagation), the committed-budget diff
(grow fails naming root/site/budget line, shrink ratchets), certificate
schema, the root-missing finding, and
the runner satellites — epoch-keyed parse cache, ``--diff`` scoping,
and the concurrent pass runner.
"""

import json
import os
import subprocess
import sys

import pytest

from tuplewise_tpu_torch.analysis import hotpath, modgraph
from tuplewise_tpu_torch.analysis.cache import ParseCache, compute_epoch
from tuplewise_tpu_torch.analysis.core import ModuleInfo, ModuleSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = os.path.join(REPO, "tuplewise_tpu_torch", "analysis",
                      "hotpath_budget.toml")


def ms_of(src: str, path: str = "tuplewise_tpu_torch/fixture.py",
          **extra) -> ModuleSet:
    return ModuleSet.from_sources({path: src, **extra})


FIXTURE = '''
import threading
import numpy as np


def helper(r):
    return [r, r]


class Engine:
    def __init__(self):
        self._lock = threading.Lock()

    def apply(self, run, groups):
        wave_buf = []
        arr = np.asarray(run)
        with self._lock:
            n = len(run)
        for r in run:
            d = {"v": r}
            wave_buf.append(helper(r))
        for tid, reqs in groups:
            seen = {tid}
        out = sharded_counts(arr, n)
        return wave_buf

    def quiet(self, run):
        cfg = (1, 2)
        for _side in ("pos", "neg"):
            pass
        return cfg
'''

ROOT_APPLY = (("tuplewise_tpu_torch/fixture.py", "Engine", "apply"),)
ROOT_QUIET = (("tuplewise_tpu_torch/fixture.py", "Engine", "quiet"),)


@pytest.fixture(scope="module")
def fixture_cert():
    return hotpath.certificates(ms_of(FIXTURE), roots=ROOT_APPLY)


def test_certificate_schema(fixture_cert):
    assert fixture_cert["missing"] == []
    (e,) = fixture_cert["roots"]
    assert e["root"] == "Engine.apply"
    assert e["file"] == "tuplewise_tpu_torch/fixture.py"
    assert e["line"] > 0
    assert e["loop_class"] in ("O(1)", "O(tenants)", "O(events)")
    assert isinstance(e["counters"], dict)
    for key, v in e["counters"].items():
        counter, _, suffix = key.rpartition("_per_")
        assert counter in hotpath.COUNTERS
        assert v > 0
        assert key in e["sites"] and len(e["sites"][key]) >= 1


def test_loop_classification_and_counters(fixture_cert):
    (e,) = fixture_cert["roots"]
    c = e["counters"]
    # the per-event dict display inside `for r in run`
    assert c["alloc_per_event"] >= 1
    # wave_buf = [] at function level
    assert c["alloc_per_wave"] >= 1
    # the {tid} set inside the `for tid, reqs in groups` tenant loop
    assert c["alloc_per_tenant"] >= 1
    # np.asarray at wave level
    assert c["np_alloc_per_wave"] >= 1
    # with self._lock at wave level
    assert c["lock_per_wave"] == 1
    # sharded_counts(...) is device dispatch
    assert c["dispatch_per_wave"] == 1
    assert e["loop_class"] == "O(events)"


def test_interprocedural_multiplicity(fixture_cert):
    (e,) = fixture_cert["roots"]
    # helper() is called inside the per-event loop: its [r, r] display
    # must bill per event, and show up in the site evidence
    sites = e["sites"].get("alloc_per_event", [])
    assert any("helper" in s for s in sites), sites


def test_quiet_root_is_o1():
    cert = hotpath.certificates(ms_of(FIXTURE), roots=ROOT_QUIET)
    (e,) = cert["roots"]
    # constant-tuple iteration and no per-event work: O(1), no alloc
    # beyond the wave-level tuple display
    assert e["loop_class"] == "O(1)"
    assert "alloc_per_event" not in e["counters"]


def test_missing_root_finding():
    cert = hotpath.certificates(
        ms_of(FIXTURE),
        roots=(("tuplewise_tpu_torch/fixture.py", "Engine", "vanished"),))
    assert cert["missing"] == [{"root": "Engine.vanished",
                               "file": "tuplewise_tpu_torch/fixture.py"}]
    (f,) = hotpath.missing_findings(cert)
    assert f.rule == "hotpath-root-missing"
    assert f.symbol == "Engine.vanished"


# --------------------------------------------------------------------- #
# budget file: parse / format / diff semantics                           #
# --------------------------------------------------------------------- #

def test_budget_roundtrip(fixture_cert):
    text = hotpath.format_budget(fixture_cert)
    entries = hotpath.parse_budget(text)
    (e,) = fixture_cert["roots"]
    (b,) = entries
    assert b["root"] == e["root"]
    assert b["loop_class"] == e["loop_class"]
    for k, v in e["counters"].items():
        assert b[k] == v
    errors, shrinks = hotpath.compare_to_budget(fixture_cert, text)
    assert errors == [] and shrinks == []


def test_budget_malformed():
    with pytest.raises(hotpath.BudgetError):
        hotpath.parse_budget("[maxima]\nS = 2\n")
    with pytest.raises(hotpath.BudgetError):
        hotpath.parse_budget("[[root]]\nroot = \"x\"\n")  # no file
    errors, _ = hotpath.compare_to_budget(
        {"roots": [], "missing": []}, "[[oops]]\n")
    assert errors and "only [[root]]" in errors[0]


def _bump(cert, key, delta):
    import copy

    out = copy.deepcopy(cert)
    c = out["roots"][0]["counters"]
    c[key] = c.get(key, 0) + delta
    if c[key] <= 0:
        del c[key]
    return out


def test_budget_growth_fails_naming_root_site_and_line(fixture_cert):
    text = hotpath.format_budget(fixture_cert)
    grown = _bump(fixture_cert, "alloc_per_event", 1)
    errors, shrinks = hotpath.compare_to_budget(grown, text)
    assert len(errors) == 1 and shrinks == []
    msg = errors[0]
    assert "Engine.apply" in msg
    assert "alloc_per_event" in msg
    # the violated budget line is NAMED
    assert "hotpath_budget.toml:" in msg
    lineno = int(msg.split("hotpath_budget.toml:")[1].split(")")[0])
    assert text.splitlines()[lineno - 1].startswith("alloc_per_event")
    # contributing sites ride along
    assert "tuplewise_tpu_torch/fixture.py" in msg


def test_budget_shrink_ratchets(fixture_cert):
    text = hotpath.format_budget(fixture_cert)
    shrunk = _bump(fixture_cert, "alloc_per_event", -1)
    errors, shrinks = hotpath.compare_to_budget(shrunk, text)
    assert errors == []
    assert shrinks and "alloc_per_event" in shrinks[0]


def test_budget_new_root_and_stale_root_fail(fixture_cert):
    import copy

    text = hotpath.format_budget(fixture_cert)
    extra = copy.deepcopy(fixture_cert)
    extra["roots"].append(dict(extra["roots"][0], root="Engine.new"))
    errors, _ = hotpath.compare_to_budget(extra, text)
    assert any("Engine.new" in e and "no committed budget" in e
               for e in errors)
    none = {"roots": [], "missing": []}
    errors, _ = hotpath.compare_to_budget(none, text)
    assert any("stale budget entry" in e for e in errors)


def test_budget_loop_class_worsening_fails(fixture_cert):
    import copy

    text = hotpath.format_budget(fixture_cert).replace(
        'loop_class = "O(events)"', 'loop_class = "O(1)"')
    errors, _ = hotpath.compare_to_budget(fixture_cert, text)
    assert any("loop class worsened" in e for e in errors)


def test_budget_missing_root_reported(fixture_cert):
    import copy

    cert = copy.deepcopy(fixture_cert)
    cert["missing"].append({"root": "Engine.gone",
                            "file": "tuplewise_tpu_torch/fixture.py"})
    errors, _ = hotpath.compare_to_budget(
        cert, hotpath.format_budget(fixture_cert))
    assert any("Engine.gone" in e and "ROOTS" in e for e in errors)


# --------------------------------------------------------------------- #
# the real repo against the committed budget                             #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def repo_ms():
    return ModuleSet.from_repo(REPO)


@pytest.fixture(scope="module")
def repo_cert(repo_ms):
    return hotpath.certificates(repo_ms)


def test_repo_all_roots_certified(repo_cert):
    assert repo_cert["missing"] == []
    names = {e["root"] for e in repo_cert["roots"]}
    assert names == {f"{cls}.{meth}" if cls else meth
                     for _p, cls, meth in hotpath.ROOTS}
    # the host-tax story the certificate exists to ratchet: the fleet
    # insert path pays per-event Python today
    fleet = next(e for e in repo_cert["roots"]
                 if e["root"] ==
                 "MultiTenantEngine._apply_insert_wave_ledgered")
    assert fleet["counters"].get("attr_hop_per_event", 0) > 0


def test_repo_certificate_matches_committed_budget(repo_cert):
    with open(BUDGET, "r", encoding="utf-8") as f:
        text = f.read()
    errors, shrinks = hotpath.compare_to_budget(repo_cert, text)
    assert errors == [], (
        "hotpath certificate drifted from the committed budget — a "
        "grown counter is new host cost on the request path (fix it "
        "or re-baseline with scripts_torch/analysis_gate.py "
        "--update-hotpath-budget after review):\n" + "\n".join(errors))
    assert shrinks == [], (
        "counters shrank — run scripts_torch/analysis_gate.py once to "
        "ratchet the committed budget down and commit it:\n"
        + "\n".join(shrinks))


def test_seeded_per_event_allocation_fails_budget(repo_ms, repo_cert):
    """The acceptance criterion, end to end: a per-event dict display
    + lock acquisition seeded into engine.py's resolve loop must fail
    the budget diff naming the root, the engine.py site, and the
    violated budget line."""
    path = "tuplewise_tpu_torch/serving/engine.py"
    src = repo_ms.modules[path].source
    anchor = "        for r in run:\n            # a request the reaper"
    assert anchor in src, "engine resolve-loop anchor moved"
    seeded = src.replace(
        anchor,
        "        for r in run:\n"
        "            with self._lock:\n"
        "                _shadow = {\"n\": len(r.scores)}\n"
        + anchor, 1)
    mods = dict(repo_ms.modules)
    mods[path] = ModuleInfo(path, seeded)
    ms2 = ModuleSet({k: v for k, v in mods.items()},
                    texts=repo_ms.texts, root=repo_ms.root)
    cert2 = hotpath.certificates(ms2)
    with open(BUDGET, "r", encoding="utf-8") as f:
        errors, _ = hotpath.compare_to_budget(cert2, f.read())
    assert errors, "seeded per-event allocation went undetected"
    blob = "\n".join(errors)
    assert "MicroBatchEngine._apply_inserts_wave" in blob
    assert "tuplewise_tpu_torch/serving/engine.py" in blob
    assert "hotpath_budget.toml:" in blob
    assert any("alloc_per_event" in e for e in errors)
    assert any("lock_per_event" in e for e in errors)


# --------------------------------------------------------------------- #
# runner satellites: epoch cache, --diff, concurrency                    #
# --------------------------------------------------------------------- #

def _mini_repo(tmp_path):
    adir = tmp_path / "tuplewise_tpu_torch" / "analysis"
    adir.mkdir(parents=True)
    (adir / "waivers.toml").write_text("# v1\n")
    sub = tmp_path / "tuplewise_tpu_torch" / "sub"
    sub.mkdir()
    (sub / "mod.py").write_text("def f():\n    return 1\n")
    return str(tmp_path)


def test_cache_epoch_waiver_edit_forces_cold_run(tmp_path):
    """The cache-epoch regression: content-sha-only keys replayed
    stale state across a waivers.toml edit. The epoch folds the
    waiver/budget/checker digests into every key, so the edit must
    produce a COLD re-run."""
    root = _mini_repo(tmp_path)
    c1 = ParseCache(root, epoch=compute_epoch(root))
    ModuleSet.from_repo(root, cache=c1)
    assert c1.misses >= 1
    c2 = ParseCache(root, epoch=compute_epoch(root))
    ModuleSet.from_repo(root, cache=c2)
    assert c2.hits >= 1 and c2.misses == 0      # warm, same epoch
    (tmp_path / "tuplewise_tpu_torch" / "analysis"
     / "waivers.toml").write_text("# v2 — edited waiver\n")
    c3 = ParseCache(root, epoch=compute_epoch(root))
    ModuleSet.from_repo(root, cache=c3)
    assert c3.hits == 0 and c3.misses >= 1      # cold re-run


def test_cache_epoch_tracks_checker_and_budget(tmp_path):
    root = _mini_repo(tmp_path)
    e1 = compute_epoch(root)
    (tmp_path / "tuplewise_tpu_torch" / "analysis"
     / "hotpath_budget.toml").write_text("# budget\n")
    e2 = compute_epoch(root)
    assert e1 != e2
    (tmp_path / "tuplewise_tpu_torch" / "analysis"
     / "newpass.py").write_text("# checker change\n")
    assert compute_epoch(root) != e2


def test_reverse_closure():
    ms = ModuleSet.from_sources({
        "tuplewise_tpu_torch/a.py": "from tuplewise_tpu_torch import b\n",
        "tuplewise_tpu_torch/b.py": "from tuplewise_tpu_torch import c\n",
        "tuplewise_tpu_torch/c.py": "x = 1\n",
        "tuplewise_tpu_torch/d.py": "y = 2\n",
    })
    scope = modgraph.reverse_closure(ms, {"tuplewise_tpu_torch/c.py"})
    assert scope == {"tuplewise_tpu_torch/a.py", "tuplewise_tpu_torch/b.py",
                     "tuplewise_tpu_torch/c.py"}
    assert "tuplewise_tpu_torch/d.py" not in scope


def test_run_checks_diff_mode():
    from tuplewise_tpu_torch.analysis.runner import run_checks

    report = run_checks(root=REPO, diff_ref="HEAD")
    assert report["diff"]["ref"] == "HEAD"
    assert "error" not in report["diff"]
    # scoped findings are a subset; stale waivers never fail a diff run
    assert report["unused_waivers"] == []
    assert report["ok"] is True, report["findings"]


def test_run_checks_timing_block():
    """The timing block covers every pass. Measured serially (jobs=1):
    with concurrent passes the total wall clock is below their sum."""
    from tuplewise_tpu_torch.analysis.runner import PASSES, run_checks

    report = run_checks(root=REPO, jobs=1)
    t = report["summary"]["timings"]
    assert t["jobs"] == 1
    assert set(t["passes_s"]) == {name for name, _ in PASSES}
    assert t["total_s"] >= sum(t["passes_s"].values()) * 0.5
    assert report["hotpath_certificate"] is not None


def test_concurrent_runner_matches_serial(tmp_path):
    """--jobs 2 in a clean subprocess (fork safety: no torch in that
    process): same verdict, every pass ran, certificate present. The
    report goes to a temporary directory, never into the repo."""
    out = str(tmp_path / "check_jobs2.json")
    proc = subprocess.run(
        [sys.executable, "-m", "tuplewise_tpu_torch.harness.cli",
         "check", "--jobs", "2", "--out", out],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        rep = json.load(f)
    assert rep["summary"]["timings"]["jobs"] == 2
    assert rep["ok"] is True
    from tuplewise_tpu_torch.analysis.runner import PASSES

    assert set(rep["summary"]["per_pass"]) == {
        name for name, _ in PASSES}
    assert rep["hotpath_certificate"]["missing"] == []
