"""The port's static analysis held against the JAX package's: both run
on this tree, each over its own package. The port's ``check --strict``
is clean; the JAX ``tuplewise check`` stays clean on its own 103 files
(the port's files never enter its globs); the port's overflow
certificate carries the bounds of its JAX counterparts at the same
maxima; every function the JAX pass reaches from a traced root that has
a same-named port counterpart is a port root; every JAX hotpath root
exists in the port, ``sharded_counts`` O(1) in both; each fault class,
given as a JAX fixture to the JAX pass and as a torch fixture to the
port's pass, is flagged by both. The port's declared tables (dispatch
names, chokepoints, accumulators, run-bounded loops) are held complete
against the port's own code."""

import ast
import os
import shutil

import pytest

from tuplewise_tpu.analysis import compile_ladder as jcl
from tuplewise_tpu.analysis import exactness as jex
from tuplewise_tpu.analysis import hotpath as jhp
from tuplewise_tpu.analysis import lock_order as jlo
from tuplewise_tpu.analysis import races as jra
from tuplewise_tpu.analysis import traced_purity as jtp
from tuplewise_tpu.analysis.cache import compute_epoch as jax_epoch
from tuplewise_tpu.analysis.core import ModuleSet as JaxModuleSet
from tuplewise_tpu.analysis.core import call_name as jax_call_name
from tuplewise_tpu.analysis.runner import run_checks as jax_run_checks
from tuplewise_tpu_torch.analysis import (
    compile_ladder, exactness, hotpath, lock_order, races, traced_purity,
)
from tuplewise_tpu_torch.analysis.cache import compute_epoch
from tuplewise_tpu_torch.analysis.core import ModuleSet, call_name
from tuplewise_tpu_torch.analysis.runner import run_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FILES = 103


def _port_path(path: str) -> str:
    for ref, port in (("tuplewise_tpu/", "tuplewise_tpu_torch/"),
                      ("scripts/", "scripts_torch/")):
        if path.startswith(ref):
            return port + path[len(ref):]
    return path


@pytest.fixture(scope="module")
def port_ms():
    return ModuleSet.from_repo(REPO)


@pytest.fixture(scope="module")
def jax_ms():
    return JaxModuleSet.from_repo(REPO)


@pytest.fixture(scope="module")
def port_report():
    return run_checks(root=REPO, strict=True, use_cache=False)


# --------------------------------------------------------------------- #
# (a), (b): both checks clean on the tree                                 #
# --------------------------------------------------------------------- #

def test_port_check_strict_clean(port_report):
    r = port_report
    assert r["findings"] == [], [
        (f["rule"], f["file"], f["symbol"]) for f in r["findings"]]
    assert r["unused_waivers"] == [] and r["parse_errors"] == {}
    assert "waiver_error" not in r and r["ok"] is True
    # the port's waivers bite on its own tree
    assert r["summary"]["waived"] > 0


def test_port_check_cli_strict_exits_zero_without_card(monkeypatch,
                                                      capsys):
    """``tuplewise-torch check --strict`` is host-only: no card is no
    reason to exit 2."""
    import torch

    from tuplewise_tpu_torch.harness import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["check", "--strict", "--root", REPO]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "OK"
    with pytest.raises(SystemExit):
        cli.main(["check", "--device", "cpu"])


def test_port_scans_only_its_own_files(port_ms):
    paths = set(port_ms.modules)
    assert paths and all(
        p.startswith(("tuplewise_tpu_torch/", "scripts_torch/",
                      "bench_torch")) for p in paths)
    assert "tuplewise_tpu_torch/analysis/runner.py" in paths
    assert "scripts_torch/analysis_gate.py" in paths
    assert {p for p in paths if p.startswith("bench_torch")} == {
        f for f in os.listdir(REPO)
        if f.startswith("bench_torch") and f.endswith(".py")}


def test_gate_writes_its_artifacts_under_results_torch(tmp_path, capsys):
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location(
        "port_gate", os.path.join(REPO, "scripts_torch", "analysis_gate.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    assert gate.RESULTS == os.path.join(REPO, "results", "torch")
    out = {k: str(tmp_path / f"{k}.json") for k in ("report", "sarif",
                                                    "hotpath")}
    assert gate.main(["--no-cache", "--out", out["report"], "--sarif",
                      out["sarif"], "--hotpath-out", out["hotpath"]]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["ok"] and verdict["certificate_ok"] \
        and verdict["hotpath_budget_ok"] and verdict["unwaived"] == 0
    with open(out["report"]) as f:
        report = json.load(f)
    assert report["certificate_diff"] == [] \
        and report["hotpath_budget_diff"] == []
    with open(out["sarif"]) as f:
        sarif = json.load(f)
    assert sarif["runs"][0]["tool"]["driver"]["name"] \
        == "tuplewise-torch-check"
    with open(out["hotpath"]) as f:
        assert json.load(f)["certificate"]["missing"] == []


def test_jax_check_stays_clean_on_its_files():
    r = jax_run_checks(root=REPO, use_cache=False)
    assert r["summary"]["files_analyzed"] == JAX_FILES
    assert r["findings"] == [] and r["unused_waivers"] == []
    assert r["ok"] is True


# --------------------------------------------------------------------- #
# (c): the overflow certificate against the JAX package's                 #
# --------------------------------------------------------------------- #

def test_overflow_bounds_equal_the_jax_counterparts(port_ms, jax_ms):
    port = exactness.certificates(port_ms)
    ref = jex.certificates(jax_ms)
    assert port["maxima"] == ref["maxima"] == jex.DEFAULT_MAXIMA
    by_fac = {f"{e['file']}::{e['factory']}": e for e in ref["bounds"]}
    assert port["bounds"] and port["ok"] and ref["ok"]
    for e in port["bounds"]:
        r = by_fac[e["counterpart"]]
        assert (e["bound"], e["category"], e["expr"]) == (
            r["bound"], r["category"], r["expr"]), e["function"]
    # every declared accumulator is in the certificate
    assert {(a.file, a.function) for a in exactness.ACCUMULATORS} == {
        (e["file"], e["function"]) for e in port["bounds"]}


def test_every_count_launcher_has_an_accumulator(port_ms):
    launchers = exactness.count_launchers(port_ms)
    assert {n for _, n, _ in launchers} == {
        "signed_count", "signed_count_mesh", "tenant_count",
        "tenant_count_mesh"}
    declared = {(a.file, a.function) for a in exactness.ACCUMULATORS}
    assert {(p, n) for p, n, _ in launchers} <= declared


def test_every_int32_search_has_an_accumulator(port_ms):
    """A function of the port that searches into int32
    (``out_int32=True``) accumulates int32 counts: it is declared."""
    declared = {(a.file, a.function) for a in exactness.ACCUMULATORS}
    found = set()
    for path, mi in port_ms.modules.items():
        if path.startswith("tuplewise_tpu_torch/analysis/"):
            continue
        for name, fn in mi.functions.items():
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call) \
                        and call_name(sub) == "torch.searchsorted" \
                        and any(k.arg == "out_int32" for k in sub.keywords):
                    found.add((path, name))
    assert found and found <= declared


# --------------------------------------------------------------------- #
# (d): the traced roots against the JAX package's                         #
# --------------------------------------------------------------------- #

def _jax_traced(ms):
    """The functions the JAX traced-purity pass reaches: its roots
    (jit decorators, jit / shard_map / pallas_call arguments) and every
    bare-name call they make, resolved as that pass resolves them."""
    by_name = {}
    for path, mi in ms.modules.items():
        for fi in mi.iter_functions():
            by_name.setdefault(fi.qualname.split(".")[-1], []).append(
                (path, fi.qualname))

    def lookup(path, name):
        cands = [k for k in by_name.get(name, ()) if k[0] == path]
        if cands:
            return cands[0]
        res = ms.resolve_import(ms.modules[path], name)
        if res is not None:
            cands = [k for k in by_name.get(res[1] or name, ())
                     if k[0] == res[0]]
            if cands:
                return cands[0]
        return None

    roots = set()
    for path, mi in ms.modules.items():
        for fi in mi.iter_functions():
            if any(jtp._is_jit_deco(d)
                   for d in getattr(fi.node, "decorator_list", ())):
                roots.add((path, fi.qualname))
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call) and jax_call_name(node) in (
                    jtp._JIT_WRAPPERS | jtp._SHMAP_WRAPPERS | jtp._PALLAS):
                for t in node.args[:1]:
                    if isinstance(t, ast.Name):
                        k = lookup(path, t.id)
                        if k is not None:
                            roots.add(k)
    calls = {}
    for path, mi in ms.modules.items():
        for fi in mi.iter_functions():
            out = set()
            for sub in ast.walk(fi.node):
                if isinstance(sub, ast.Call):
                    cn = jax_call_name(sub)
                    if cn and "." not in cn:
                        k = lookup(path, cn)
                        if k is not None:
                            out.add(k)
            calls[(path, fi.qualname)] = out
    seen, todo = set(), list(roots)
    while todo:
        k = todo.pop()
        if k not in seen:
            seen.add(k)
            todo.extend(calls.get(k, ()))
    return seen


def test_jax_traced_functions_with_a_counterpart_are_port_roots(port_ms,
                                                              jax_ms):
    jax_reached = _jax_traced(jax_ms)
    assert len(jax_reached) > 50
    port_funcs = {(p, fi.qualname) for p, mi in port_ms.modules.items()
                  for fi in mi.iter_functions()}
    roots = traced_purity.traced_roots(port_ms)
    same_named = {(_port_path(p), q) for p, q in jax_reached
                  if (_port_path(p), q) in port_funcs}
    assert same_named and same_named <= roots, sorted(same_named - roots)
    # the declared table cites real traced functions of the JAX package
    # and real functions of the port
    cited = {f"{p}::{q}" for p, q in jax_reached}
    for (path, qual), refs in traced_purity.TRACED_ROOTS.items():
        assert (path, qual) in port_funcs, (path, qual)
        assert refs and set(refs) <= cited, (qual, set(refs) - cited)


def test_autograd_functions_are_roots(port_ms):
    roots = traced_purity.traced_roots(port_ms)
    for q in ("DiffPairMean.forward", "DiffPairMean.backward",
              "DiffPairMeanLossFree.forward",
              "DiffPairMeanLossFree.backward"):
        assert ("tuplewise_tpu_torch/ops/pair_tiles.py", q) in roots


def test_declared_traced_root_is_checked():
    """A function at a declared root's path and name is scanned: the
    device design draw on torch's global generator is flagged there,
    and nowhere else."""
    src = """
import torch


def draw_pair_design_device(gen, n1, n2, n_pairs):
    return torch.randint(0, n1, (n_pairs,))
"""
    path = "tuplewise_tpu_torch/ops/device_design.py"
    fs = traced_purity.run(ModuleSet.from_sources({path: src}))
    assert [(f.rule, f.symbol) for f in fs] == [
        ("traced-host-rng", "draw_pair_design_device::torch.randint")]
    other = "tuplewise_tpu_torch/ops/elsewhere.py"
    assert traced_purity.run(ModuleSet.from_sources({other: src})) == []
    fixed = src.replace("(n_pairs,))", "(n_pairs,), generator=gen)")
    assert traced_purity.run(ModuleSet.from_sources({path: fixed})) == []


# --------------------------------------------------------------------- #
# (e): the hotpath roots against the JAX package's                        #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def port_hot(port_ms):
    return hotpath.certificates(port_ms)


def test_every_jax_hotpath_root_is_in_the_port(port_hot):
    assert port_hot["missing"] == []
    assert {_port_path(p) for p, _, _ in jhp.ROOTS} == {
        p for p, _, _ in hotpath.ROOTS}
    assert [(c, m) for _, c, m in jhp.ROOTS] == [
        (c, m) for _, c, m in hotpath.ROOTS]
    with open(os.path.join(REPO, "tuplewise_tpu_torch", "analysis",
                           "hotpath_budget.toml")) as f:
        errors, shrinks = hotpath.compare_to_budget(port_hot, f.read())
    assert errors == [] and shrinks == []


def test_sharded_counts_is_o1_in_both(port_hot, jax_ms):
    ref = {e["root"]: e for e in jhp.certificates(jax_ms)["roots"]}
    port = {e["root"]: e for e in port_hot["roots"]}
    assert ref["sharded_counts"]["loop_class"] == "O(1)"
    assert port["sharded_counts"]["loop_class"] == "O(1)"
    # the count is priced as a dispatch, and the walk never entered a
    # launcher's plain CPU version
    assert port["sharded_counts"]["counters"]["dispatch_per_wave"] >= 1
    sites = [s for v in port["sharded_counts"]["sites"].values()
             for s in v]
    assert not any("count_kernels.py" in s for s in sites)


def test_launcher_is_a_dispatch_leaf():
    src = """
def _plain(runs, q):
    out = []
    for r in runs:
        out.append([x < q for x in r])
    return out


def signed_count(runs, q):
    return _plain(runs, q)


def count(runs, q):
    return signed_count(runs, q)
"""
    ms = ModuleSet.from_sources({"tuplewise_tpu_torch/fixture.py": src})
    (e,) = hotpath.certificates(
        ms, roots=(("tuplewise_tpu_torch/fixture.py", "", "count"),))[
            "roots"]
    assert e["loop_class"] == "O(1)" and e["functions_reached"] == 1
    assert e["counters"]["dispatch_per_wave"] == 1


def test_run_bounded_loops_name_real_iterables(port_ms):
    """Each name in the hotpath pass's run-bounded table is iterated by
    some loop of its file (no stale entry)."""
    for path, names in hotpath.RUN_BOUNDED.items():
        iters = set()
        for node in ast.walk(port_ms.modules[path].tree):
            if isinstance(node, (ast.For, ast.comprehension)):
                for n in ast.walk(node.iter):
                    if isinstance(n, ast.Name):
                        iters.add(n.id)
        assert names <= iters, names - iters


# --------------------------------------------------------------------- #
# the declared tables, complete against the port's code                   #
# --------------------------------------------------------------------- #

def test_dispatch_names_are_port_functions(port_ms):
    defined = {n for mi in port_ms.modules.values() for n in mi.functions}
    methods = {n for mi in port_ms.modules.values()
               for ms in mi.classes.values() for n in ms}
    assert lock_order.LAUNCHERS | lock_order.COUNT_LAYER <= defined
    assert lock_order.COLLECTIVES <= methods
    # every count launcher is a launcher of the lock and hotpath passes
    assert {n for _, n, _ in exactness.count_launchers(port_ms)} \
        <= lock_order.LAUNCHERS


def test_chokepoints_complete(port_ms):
    """Every public function of the count layer that takes a size
    (``cap``, ``cap_*``, ``*_cap``, ``t_bucket``) is a chokepoint, with
    exactly those parameters."""
    mi = port_ms.modules["tuplewise_tpu_torch/parallel/sharded_counts.py"]
    want = {}
    for name, fn in mi.functions.items():
        if name.startswith("_"):
            continue
        sizes = tuple(a.arg for a in fn.args.args
                      if a.arg == "cap" or a.arg.startswith("cap_")
                      or a.arg.endswith("_cap") or a.arg == "t_bucket")
        if sizes:
            want[name] = sizes
    assert want == compile_ladder.CHOKEPOINTS


# --------------------------------------------------------------------- #
# (f): each fault class flagged by both packages' passes                  #
# --------------------------------------------------------------------- #

_FAULTS = {
    "lock-held-blocking": (
        "lock",
        """
import threading
from tuplewise_tpu.parallel.sharded_counts import sharded_counts

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def f(self, mesh, dev, cap, q, dtype):
        with self._lock:
            return sharded_counts(mesh, dev, cap, q, dtype)
""",
        """
import threading
from tuplewise_tpu_torch.ops.count_kernels import signed_count

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def f(self, runs, signs, sets, qa, qb):
        with self._lock:
            return signed_count(runs, signs, sets, qa, qb)
"""),
    "traced-wall-clock": (
        "traced",
        """
import time
import jax

@jax.jit
def f(x):
    return x + time.time()
""",
        """
import time
import torch

class F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x + time.time()
"""),
    "traced-host-rng": (
        "traced",
        """
import jax
import numpy as np

@jax.jit
def f(x):
    return x + np.random.rand()
""",
        """
import torch

class F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x + torch.rand(x.shape)
"""),
    "traced-device-sync": (
        "traced",
        """
import jax

@jax.jit
def f(x):
    return x.item()
""",
        """
import torch

class F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.item()
"""),
    "ladder-raw-shape": (
        "ladder",
        """
import functools

@functools.lru_cache(maxsize=None)
def pack_fn(t_bucket):
    return lambda runs: runs

def place(runs):
    return pack_fn(len(runs))(runs)
""",
        """
def place_tenant_pack(mesh, runs, t_bucket):
    return runs

def place(mesh, runs):
    return place_tenant_pack(mesh, runs, len(runs))
"""),
    "count-narrow-accumulator": (
        "exact",
        """
import jax.numpy as jnp

class Idx:
    def __init__(self):
        self._wins2 = 0

    def insert(self, base, q):
        less = jnp.searchsorted(base, q)
        self._wins2 += less.sum()
""",
        """
import torch

class Idx:
    def __init__(self):
        self._wins2 = 0

    def insert(self, base, q):
        less = torch.searchsorted(base, q, out_int32=True)
        self._wins2 += less.sum()
"""),
    "race-unguarded-shared": (
        "race",
        """
import threading

class E:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0
        self._t = threading.Thread(target=self._work, name="batcher")

    def _work(self):
        self.n += 1

    def bump(self):
        with self._lock:
            self.n += 1
""",
        None),
}


def _run(kind, jax_side, ms):
    if kind == "lock":
        return (jlo if jax_side else lock_order).run(ms)
    if kind == "traced":
        return (jtp if jax_side else traced_purity).run(ms)
    if kind == "ladder":
        return (jcl if jax_side else compile_ladder).run(ms)
    if kind == "exact":
        return (jex if jax_side else exactness).run(ms)
    scope = ("tuplewise_tpu/",) if jax_side else ("tuplewise_tpu_torch/",)
    return (jra if jax_side else races).run(ms, scope=scope)


@pytest.mark.parametrize("rule", sorted(_FAULTS))
def test_fault_class_flagged_by_both(rule):
    kind, jax_src, port_src = _FAULTS[rule]
    port_src = port_src or jax_src
    jms = JaxModuleSet.from_sources({"tuplewise_tpu/fixture.py": jax_src})
    pms = ModuleSet.from_sources(
        {"tuplewise_tpu_torch/fixture.py": port_src})
    assert rule in {f.rule for f in _run(kind, True, jms)}
    assert rule in {f.rule for f in _run(kind, False, pms)}


def test_overflow_unproved_flagged_by_both():
    jsrc = """
import functools

@functools.lru_cache(maxsize=None)
def weird_fn(alpha, beta):
    import jax.numpy as jnp

    return lambda x: x.astype(jnp.int32)
"""
    psrc = """
_SOURCE = "tenant_count.cu"

def load():
    from tuplewise_tpu_torch.ops import _build

    return _build.load(_SOURCE)

def weird_count(packs, q):
    return load().tw_count(packs, q)
"""
    jfs = jex.run(JaxModuleSet.from_sources(
        {"tuplewise_tpu/fixture.py": jsrc}))
    pfs = exactness.run(ModuleSet.from_sources(
        {"tuplewise_tpu_torch/ops/fixture.py": psrc}))
    assert "overflow-unproved" in {f.rule for f in jfs}
    assert "overflow-unproved" in {f.rule for f in pfs}


# --------------------------------------------------------------------- #
# the two packages' cache epochs stay apart                               #
# --------------------------------------------------------------------- #

def test_port_waiver_edit_moves_only_the_port_epoch(tmp_path):
    for pkg in ("tuplewise_tpu", "tuplewise_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg, "analysis"),
                        tmp_path / pkg / "analysis",
                        ignore=shutil.ignore_patterns("__pycache__"))
    root = str(tmp_path)
    p1, j1 = compute_epoch(root), jax_epoch(root)
    assert p1 != j1
    waivers = tmp_path / "tuplewise_tpu_torch" / "analysis" / "waivers.toml"
    waivers.write_text(waivers.read_text() + "\n# reviewed\n")
    assert compute_epoch(root) != p1
    assert jax_epoch(root) == j1
    # and the reverse: the JAX package's waivers do not move the port's
    p2 = compute_epoch(root)
    jw = tmp_path / "tuplewise_tpu" / "analysis" / "waivers.toml"
    jw.write_text(jw.read_text() + "\n# reviewed\n")
    assert jax_epoch(root) != j1 and compute_epoch(root) == p2
