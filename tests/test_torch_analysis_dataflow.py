"""Fixture tests for the flow-sensitive dataflow tier:
the shared engine (call/return/attribute chase, cycle termination),
guard-inference race detection (seeded-bad / clean-twin pairs PLUS
the two historical-bug regression fixtures), integer-exactness +
overflow certification (float-taint, narrow accumulator,
overflow-at-ladder-max, committed-baseline diff), the reworked
flow-sensitive compile-ladder chase, the incremental parse cache, and
the SARIF emitter.
"""

import importlib.util
import os

import pytest

from tuplewise_tpu_torch.analysis import compile_ladder, exactness, races
from tuplewise_tpu_torch.analysis import dataflow
from tuplewise_tpu_torch.analysis.cache import ParseCache
from tuplewise_tpu_torch.analysis.core import ModuleSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "analysis_gate", os.path.join(REPO, "scripts_torch", "analysis_gate.py"))
analysis_gate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(analysis_gate)


def ms_of(src: str, path: str = "tuplewise_tpu_torch/fixture.py",
          **extra) -> ModuleSet:
    return ModuleSet.from_sources({path: src, **extra})


def rules(findings):
    return sorted({f.rule for f in findings})


# --------------------------------------------------------------------- #
# dataflow engine                                                        #
# --------------------------------------------------------------------- #

class _ConstDomain(dataflow.Domain):
    """Tiny test domain: integer constants propagate, + adds."""

    top = None

    def const(self, value):
        return value if isinstance(value, int) else None

    def binop(self, op, left, right):
        import ast

        if isinstance(op, ast.Add) and isinstance(left, int) \
                and isinstance(right, int):
            return left + right
        return None


def _eval(src: str, func: str, domain=None):
    ms = ms_of(src)
    engine = dataflow.Engine(ms, domain or _ConstDomain())
    return engine.eval_function(("tuplewise_tpu_torch/fixture.py", "",
                                 func))


def test_dataflow_multi_step_assignment_chase():
    # three assignments deep — a one-level chase stops at one
    assert _eval("""
def f():
    a = 1
    b = a + 2
    c = b + 3
    return c
""", "f") == 6


def test_dataflow_call_return_chase():
    assert _eval("""
def g(x):
    return x + 10


def f():
    return g(1) + 100
""", "f") == 111


def test_dataflow_branch_join():
    # both branches agree -> the value survives the join; disagreement
    # joins to top
    assert _eval("""
def f(cond):
    if cond:
        x = 5
    else:
        x = 5
    return x
""", "f") == 5
    assert _eval("""
def f(cond):
    if cond:
        x = 5
    else:
        x = 6
    return x
""", "f") is None


def test_dataflow_attribute_write_join():
    src = """
class C:
    def __init__(self):
        self.x = 7

    def f(self):
        return self.x + 1
"""
    ms = ms_of(src)
    engine = dataflow.Engine(ms, _ConstDomain())
    assert engine.eval_function(
        ("tuplewise_tpu_torch/fixture.py", "C", "C.f")) == 8


def test_dataflow_struct_field_chase():
    # constructor fields flow through attribute reads (the MergePlan
    # pattern the ladder pass relies on)
    assert _eval("""
class Plan:
    pos: int
    cap: int


def mk():
    return Plan(1, cap=41)


def f():
    p = mk()
    return p.cap + 1
""", "f") == 42


def test_dataflow_cycle_terminates():
    # mutually recursive calls must terminate (summary cut to top)
    assert _eval("""
def a(n):
    return b(n) + 1


def b(n):
    return a(n) + 1


def f():
    return a(0)
""", "f") is None


def test_dataflow_param_values_join_call_sites():
    src = """
def callee(v):
    return v


def one():
    return callee(3)


def two():
    return callee(3)
"""
    ms = ms_of(src)
    engine = dataflow.Engine(ms, _ConstDomain())
    pv = engine.param_values(("tuplewise_tpu_torch/fixture.py", "",
                              "callee"))
    assert pv == {"v": 3}


def test_dataflow_closure_env():
    # nested defs read the enclosing function's environment (the
    # healer's ``attempt`` closures)
    src = """
def f():
    pad = 4

    def attempt():
        return pad + 1
    return attempt
"""
    ms = ms_of(src)
    engine = dataflow.Engine(ms, _ConstDomain())
    assert engine.eval_function(
        ("tuplewise_tpu_torch/fixture.py", "", "f.attempt")) == 5


# --------------------------------------------------------------------- #
# races — guard inference                                                #
# --------------------------------------------------------------------- #

_SCOPE = ("tuplewise_tpu_torch/",)

_INCONSISTENT = """
import threading


class Mixed:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self._shared = 0
        self._worker = threading.Thread(
            target=self._run, name="tuplewise-compactor", daemon=True)

    def bump(self):
        with self._a:
            self._shared += 1

    def _run(self):
        with self._b:
            self._shared += 1
"""

_INCONSISTENT_CLEAN = _INCONSISTENT.replace("with self._b:",
                                            "with self._a:")

_UNGUARDED = """
import threading


class Leaky:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []
        self._worker = threading.Thread(
            target=self._drain, name="tuplewise-batcher", daemon=True)

    def push(self, x):
        with self._lock:
            self._items.append(x)

    def _drain(self):
        self._items.clear()
"""

_UNGUARDED_CLEAN = _UNGUARDED.replace(
    "    def _drain(self):\n        self._items.clear()",
    "    def _drain(self):\n        with self._lock:\n"
    "            self._items.clear()")


def test_race_inconsistent_guard_flagged():
    fs = races.run(ms_of(_INCONSISTENT), scope=_SCOPE)
    assert any(f.rule == "race-inconsistent-guard"
               and f.symbol == "Mixed._shared" for f in fs)


def test_race_consistent_guard_clean():
    assert races.run(ms_of(_INCONSISTENT_CLEAN), scope=_SCOPE) == []


def test_race_unguarded_shared_flagged():
    fs = races.run(ms_of(_UNGUARDED), scope=_SCOPE)
    assert any(f.rule == "race-unguarded-shared"
               and f.symbol == "Leaky._items" for f in fs)
    # the evidence chain names both roles and the unguarded site
    (f,) = [f for f in fs if f.symbol == "Leaky._items"]
    assert "NO LOCK" in f.message and "batcher" in f.message \
        and "caller" in f.message


def test_race_guarded_everywhere_clean():
    assert races.run(ms_of(_UNGUARDED_CLEAN), scope=_SCOPE) == []


def test_race_single_role_not_flagged():
    # written+read from one role only: not shared
    src = """
import threading


class Solo:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def a(self):
        self._n += 1

    def b(self):
        return self._n
"""
    assert races.run(ms_of(src), scope=_SCOPE) == []


def test_race_init_writes_ignored():
    # constructor writes don't count as sharing (object not published)
    src = """
import threading


class InitOnly:
    def __init__(self):
        self._lock = threading.Lock()
        self._cfg = 3
        self._worker = threading.Thread(
            target=self._run, name="tuplewise-batcher", daemon=True)

    def _run(self):
        return self._cfg
"""
    assert races.run(ms_of(src), scope=_SCOPE) == []


# ---- historical-bug regression fixtures ------- #

_DEADLINE_REAPER_HOLE = """
import threading


class WedgedEngine:
    '''The deadline hole, race-shaped: deadline expiry ran
    only at dispatch, so the fix added a reaper timer — written
    WITHOUT taking the queue/pending guard, it would race submitters
    exactly like this.'''

    def __init__(self):
        self._lock = threading.Lock()
        self._pending = []
        self._reaper = threading.Thread(
            target=self._reap, name="tuplewise-reaper", daemon=True)

    def submit(self, r):
        with self._lock:
            self._pending.append(r)

    def _reap(self):
        stale = [r for r in self._pending if r.expired]
        for r in stale:
            self._pending.remove(r)
"""

_DEADLINE_REAPER_FIXED = _DEADLINE_REAPER_HOLE.replace(
    "    def _reap(self):\n        stale",
    "    def _reap(self):\n        with self._lock:\n            stale"
).replace(
    "        for r in stale:\n            self._pending.remove(r)",
    "            for r in stale:\n                "
    "self._pending.remove(r)")

_BLOCK_POLICY_HAZARD = """
import queue
import threading


class BlockingEngine:
    '''The block-policy shutdown hazard, race-shaped: close()
    flips the draining flag with no lock while submit reads it under
    the lock before blocking on a full queue — the unguarded write is
    exactly the window where a producer blocks forever.'''

    def __init__(self):
        self._lock = threading.Lock()
        self._q = queue.Queue(maxsize=8)
        self._draining = False
        self._worker = threading.Thread(
            target=self._run, name="tuplewise-batcher", daemon=True)

    def submit(self, r):
        with self._lock:
            if self._draining:
                raise RuntimeError("closed")
        self._q.put(r)

    def close(self):
        self._draining = True

    def _run(self):
        while not self._draining:
            self._q.get()
"""

_BLOCK_POLICY_FIXED = _BLOCK_POLICY_HAZARD.replace(
    "    def close(self):\n        self._draining = True",
    "    def close(self):\n        with self._lock:\n"
    "            self._draining = True").replace(
    "        while not self._draining:\n            self._q.get()",
    "        while True:\n            with self._lock:\n"
    "                if self._draining:\n                    return\n"
    "            self._q.get()")


def test_race_redetects_deadline_reaper_hole():
    fs = races.run(ms_of(_DEADLINE_REAPER_HOLE), scope=_SCOPE)
    assert any(f.rule == "race-unguarded-shared"
               and f.symbol == "WedgedEngine._pending"
               and "reaper" in f.message for f in fs)


def test_race_deadline_reaper_fixed_clean():
    assert races.run(ms_of(_DEADLINE_REAPER_FIXED),
                     scope=_SCOPE) == []


def test_race_redetects_block_policy_shutdown_hazard():
    fs = races.run(ms_of(_BLOCK_POLICY_HAZARD), scope=_SCOPE)
    assert any(f.rule == "race-unguarded-shared"
               and f.symbol == "BlockingEngine._draining"
               for f in fs)


def test_race_block_policy_fixed_clean():
    assert races.run(ms_of(_BLOCK_POLICY_FIXED), scope=_SCOPE) == []


# --------------------------------------------------------------------- #
# exactness — float taint                                                #
# --------------------------------------------------------------------- #

_TAINT_BAD = """
import numpy as np


class Idx:
    def __init__(self):
        self._wins2 = 0

    def insert(self, p, n):
        ns = np.sort(n)
        less = np.searchsorted(ns, p, side="left").astype(np.int64)
        leq = np.searchsorted(ns, p, side="right").astype(np.int64)
        self._wins2 += 2 * less.sum() + 0.5 * leq.sum()
"""

_TAINT_CLEAN = _TAINT_BAD.replace(
    "2 * less.sum() + 0.5 * leq.sum()",
    "int(2 * less.sum() + (leq - less).sum())")

_NARROW = """
import torch


class Idx:
    def __init__(self):
        self._wins2 = 0

    def insert(self, base, q):
        less = torch.searchsorted(base, q, out_int32=True)
        self._wins2 += less.sum()
"""

_NARROW_CLEAN = _NARROW.replace("less.sum()", "int(less.sum())")


def test_float_taint_flagged():
    fs = exactness.run(ms_of(_TAINT_BAD))
    assert any(f.rule == "count-float-taint"
               and "Idx.insert" in f.symbol for f in fs)


def test_integer_path_clean():
    assert exactness.run(ms_of(_TAINT_CLEAN)) == []


def test_taint_through_helper_return():
    # the float sneaks in one call away — the interprocedural chase
    # still sees it
    src = """
def half(x):
    return 0.5 * x


class Idx:
    def __init__(self):
        self._wins2 = 0

    def bump(self, d):
        self._wins2 += half(d)
"""
    fs = exactness.run(ms_of(src))
    assert any(f.rule == "count-float-taint" for f in fs)


def test_narrow_accumulator_flagged():
    fs = exactness.run(ms_of(_NARROW))
    assert any(f.rule == "count-narrow-accumulator" for f in fs)


def test_widened_accumulator_clean():
    assert exactness.run(ms_of(_NARROW_CLEAN)) == []


# --------------------------------------------------------------------- #
# exactness — overflow certification                                     #
# --------------------------------------------------------------------- #

_PSUM_PATH = "tuplewise_tpu_torch/parallel/fixture_counts.py"
_PSUM_COUNT = """
import torch


def count_mesh(runs, q):
    n = runs.shape[0]
    return torch.searchsorted(runs, q.expand(n, len(q)).contiguous(),
                              out_int32=True)
"""
# its declared entry: the reference's psum-count category, S * cap
_PSUM_TABLE = (exactness.Accumulator(
    _PSUM_PATH, "count_mesh",
    "tuplewise_tpu/parallel/sharded_counts.py::sharded_count_fn",
    "psum-count", ("S", "cap")),)


def test_certificate_bounds_psum_count():
    cert = exactness.certificates(ms_of(_PSUM_COUNT, path=_PSUM_PATH),
                                  accumulators=_PSUM_TABLE)
    (e,) = cert["bounds"]
    assert e["function"] == "count_mesh"
    assert e["category"] == "psum-count"
    assert e["bound"] == (exactness.DEFAULT_MAXIMA["S"]
                          * exactness.DEFAULT_MAXIMA["cap"])
    assert e["ok"] and cert["ok"]


def test_certificate_overflow_at_ladder_max_flagged():
    # blow the envelope: S * cap no longer fits in int32
    big = dict(exactness.DEFAULT_MAXIMA, S=4096, cap=2 ** 21)
    cert = exactness.certificates(ms_of(_PSUM_COUNT, path=_PSUM_PATH),
                                  maxima=big, accumulators=_PSUM_TABLE)
    assert not cert["ok"]
    fs = exactness.overflow_findings(cert)
    assert any(f.rule == "overflow-int32" and f.symbol == "count_mesh"
               for f in fs)


def test_certificate_unproved_factory_flagged():
    # a launcher that loads a count kernel through ops/_build.py with no
    # entry in the table: the certificate cannot bound it
    src = """
_SOURCE = "signed_count.cu"


def load_library():
    from tuplewise_tpu_torch.ops import _build

    return _build.load(_SOURCE)


def weird_count(runs, q):
    lib = load_library()
    return lib.tw_count(runs, q)
"""
    cert = exactness.certificates(ms_of(
        src, path="tuplewise_tpu_torch/ops/fixture_kernels.py"))
    assert [u["function"] for u in cert["unproved"]] == ["weird_count"]
    fs = exactness.overflow_findings(cert)
    assert any(f.rule == "overflow-unproved" for f in fs)


def test_baseline_roundtrip_and_drift():
    cert = exactness.certificates(ms_of(_PSUM_COUNT, path=_PSUM_PATH),
                                  accumulators=_PSUM_TABLE)
    text = "\n".join(
        ["[maxima]"]
        + [f"{k} = {v}" for k, v in cert["maxima"].items()]
        + sum(([
            "", "[[bound]]",
            f'function = "{e["function"]}"',
            f'file = "{e["file"]}"',
            f'bound = {e["bound"]}',
        ] for e in cert["bounds"]), []))
    assert exactness.compare_to_baseline(cert, text) == []
    drift = text.replace(f'bound = {cert["bounds"][0]["bound"]}',
                         "bound = 7")
    errs = exactness.compare_to_baseline(cert, drift)
    assert any("count_mesh" in e and "drift" in e for e in errs)
    # maxima drift is named too
    mdrift = text.replace("S = 256", "S = 512")
    errs = exactness.compare_to_baseline(cert, mdrift)
    assert any("maxima" in e for e in errs)


def test_repo_certificate_matches_committed_baseline():
    ms = ModuleSet.from_repo(REPO)
    cert = exactness.certificates(ms)
    with open(os.path.join(REPO, "tuplewise_tpu_torch", "analysis",
                           "exactness_bounds.toml")) as f:
        assert exactness.compare_to_baseline(cert, f.read()) == []
    assert cert["ok"] and not cert["unproved"]
    # the count hot path's device accumulators are all certified: the
    # kernels' launchers and their searchsorted twins
    fns = {e["function"] for e in cert["bounds"]}
    assert {"signed_count", "signed_count_mesh", "tenant_count",
            "tenant_count_mesh", "signed_count_searchsorted_mesh",
            "tenant_count_searchsorted_mesh", "delta_append",
            "sharded_major_merge"} <= fns


# --------------------------------------------------------------------- #
# compile-ladder — the flow-sensitive chase                              #
# --------------------------------------------------------------------- #

_LADDER = """
import numpy as np
import torch


def delta_append(old, cap_old, chunk, cap_chunk, cap_new):
    return torch.full((2, cap_new), float("inf"))


def next_bucket(n):
    b = 256
    while b < n:
        b *= 2
    return b
"""


def test_ladder_multi_step_chain_flagged():
    src = _LADDER + """

def grow(old, chunk):
    a = len(old)
    b = a
    c = b
    return delta_append(old, c, chunk, next_bucket(len(chunk)), 512)
"""
    fs = compile_ladder.run(ms_of(src))
    assert any(f.rule == "ladder-raw-shape" and ":1" in f.symbol
               for f in fs)
    assert not any(":3" in f.symbol for f in fs)


def test_ladder_interprocedural_callsite_proof():
    # the callee reads .shape / .size(), but every caller pads to the
    # bucket — the call-site join proves it clean (the pattern a
    # one-level chase had to waive)
    src = _LADDER + """

def dispatch(q_block):
    qb = q_block.shape[0]
    return delta_append(q_block, qb, q_block, q_block.size(0), qb)


def caller_a(q):
    q_p = np.zeros(next_bucket(len(q)))
    return dispatch(q_p)


def caller_b(q):
    q_p = torch.zeros(next_bucket(len(q)))
    return dispatch(q_p)
"""
    assert compile_ladder.run(ms_of(src)) == []


def test_ladder_raw_callsite_still_flagged():
    src = _LADDER + """

def dispatch(q_block):
    qb = q_block.shape[0]
    return delta_append(q_block, qb, q_block, qb, qb)


def caller_a(q):
    return dispatch(np.asarray(q))
"""
    fs = compile_ladder.run(ms_of(src))
    assert any(f.rule == "ladder-raw-shape"
               and "dispatch" in f.symbol for f in fs)


def test_ladder_struct_field_chase():
    # a NamedTuple field built with next_bucket proves clean through
    # the constructor (the plan_major_merge / MergePlan pattern)
    src = _LADDER + """

class Plan:
    pos: object
    cap_out: int


def plan(base):
    pos = np.full(next_bucket(len(base)), 0)
    return Plan(pos, next_bucket(len(base)))


def merge(base):
    p = plan(base)
    return delta_append(base, len(p.pos), base, p.cap_out, p.cap_out)
"""
    assert compile_ladder.run(ms_of(src)) == []


def test_ladder_factory_result_shapes_on_ladder():
    # a tensor RETURNED by a chokepoint that allocates on the ladder has
    # ladder shapes (the callee's summary): its .shape reads are clean
    src = _LADDER + """

def two_stage(old, chunk):
    mid = delta_append(old, 256, chunk, 256, next_bucket(len(chunk)))
    return delta_append(mid, int(mid.shape[1]), chunk, 256, 512)
"""
    assert compile_ladder.run(ms_of(src)) == []


# --------------------------------------------------------------------- #
# incremental parse cache                                                #
# --------------------------------------------------------------------- #

def test_parse_cache_hits_on_unchanged_source(tmp_path):
    cache = ParseCache(str(tmp_path))
    src = "def f():\n    return 1\n"
    ms1 = ModuleSet.from_repo  # noqa: F841 (API presence)
    from tuplewise_tpu_torch.analysis.core import ModuleInfo

    mi = ModuleInfo("tuplewise_tpu_torch/x.py", src)
    cache.put("tuplewise_tpu_torch/x.py", src, mi)
    hit = cache.get("tuplewise_tpu_torch/x.py", src)
    assert hit is not None and "f" in hit.functions
    assert cache.hits == 1
    # content change -> miss
    assert cache.get("tuplewise_tpu_torch/x.py", src + "# x\n") is None
    assert cache.misses == 1


def test_from_repo_uses_cache(tmp_path):
    pkg = tmp_path / "tuplewise_tpu_torch" / "sub"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text("def f():\n    return 1\n")
    cache = ParseCache(str(tmp_path))
    ms = ModuleSet.from_repo(str(tmp_path), cache=cache)
    assert cache.misses == 1 and cache.hits == 0
    cache2 = ParseCache(str(tmp_path))
    ms2 = ModuleSet.from_repo(str(tmp_path), cache=cache2)
    assert cache2.hits == 1 and cache2.misses == 0
    assert "f" in ms2.modules["tuplewise_tpu_torch/sub/mod.py"].functions
    assert ms.modules.keys() == ms2.modules.keys()


@pytest.fixture(scope="module")
def repo_report():
    """One uncached full-tree run shared by the module's tests."""
    from tuplewise_tpu_torch.analysis.runner import run_checks

    return run_checks(root=REPO, use_cache=False)


def test_run_checks_reports_cache_counters(repo_report):
    report = repo_report
    assert report["summary"]["cache"] == {
        "enabled": False, "hits": 0, "misses": 0}
    assert "overflow_certificate" in report
    assert report["overflow_certificate"]["ok"] is True


# --------------------------------------------------------------------- #
# SARIF emitter                                                          #
# --------------------------------------------------------------------- #

def test_sarif_shape():
    report = {
        "findings": [{
            "rule": "race-unguarded-shared", "file": "a.py",
            "line": 3, "symbol": "C.x", "message": "boom",
            "fingerprint": "race-unguarded-shared:a.py:C.x"}],
        "waived": [{
            "rule": "ladder-raw-shape", "file": "b.py", "line": 9,
            "symbol": "f::g:0", "message": "waived thing",
            "fingerprint": "ladder-raw-shape:b.py:f::g:0",
            "reason": "documented protocol"}],
    }
    sarif = analysis_gate.to_sarif(report)
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == {
        "race-unguarded-shared", "ladder-raw-shape"}
    errors = [r for r in run["results"] if r["level"] == "error"]
    notes = [r for r in run["results"] if r["level"] == "note"]
    assert len(errors) == 1 and len(notes) == 1
    assert notes[0]["suppressions"][0]["justification"] \
        == "documented protocol"
    loc = errors[0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "a.py"
    assert loc["region"]["startLine"] == 3


# --------------------------------------------------------------------- #
# full-repo invariants of the new tier                                   #
# --------------------------------------------------------------------- #

def test_repo_races_and_exactness_clean_modulo_waivers(repo_report):
    report = repo_report
    assert report["ok"] is True
    per_pass = report["summary"]["per_pass"]
    # the new passes RAN and bit on the real tree (waived findings
    # prove the race rules are live, not vacuous)
    assert "races" in per_pass and "exactness" in per_pass
    assert per_pass["races"] > 0
    assert any(w["rule"].startswith("race-")
               for w in report["waived"])
