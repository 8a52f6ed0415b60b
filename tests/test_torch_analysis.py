"""Fixture tests for the static invariant checkers.

Every pass is demonstrated on a seeded violation (flagged) and its
clean twin (not flagged); waiver + ratchet semantics are pinned; and
the full-repo run must be clean modulo the committed waiver file —
the same invariant scripts_torch/analysis_gate.py enforces in CI.
"""

import os
import types

import pytest

from tuplewise_tpu_torch.analysis import (
    compile_ladder, config_drift, lock_order, modgraph,
    telemetry_xref, traced_purity,
)
from tuplewise_tpu_torch.analysis.core import Finding, ModuleSet
from tuplewise_tpu_torch.analysis.runner import run_checks
from tuplewise_tpu_torch.analysis.waivers import (
    WaiverError, Waiver, apply_waivers, load_waivers,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ms_of(src: str, path: str = "tuplewise_tpu_torch/fixture.py",
          texts=None) -> ModuleSet:
    return ModuleSet.from_sources({path: src}, texts=texts)


def rules(findings):
    return sorted({f.rule for f in findings})


# --------------------------------------------------------------------- #
# pass 1 — lock order / thread discipline                                #
# --------------------------------------------------------------------- #

_LOCK_CYCLE = """
import threading

class A:
    def __init__(self):
        self._l1 = threading.Lock()
        self._l2 = threading.Lock()

    def f(self):
        with self._l1:
            with self._l2:
                pass

    def g(self):
        with self._l2:
            with self._l1:
                pass
"""

_LOCK_CYCLE_CLEAN = _LOCK_CYCLE.replace(
    "with self._l2:\n            with self._l1:",
    "with self._l1:\n            with self._l2:")

_LOCK_BLOCKING = """
import queue
import threading

class B:
    def __init__(self):
        self._lock = threading.Lock()
        self._q = queue.Queue()

    def f(self):
        with self._lock:
            return self._q.get()
"""


def test_lock_order_cycle_flagged():
    fs = lock_order.run(ms_of(_LOCK_CYCLE))
    assert "lock-order-cycle" in rules(fs)


def test_lock_order_consistent_clean():
    fs = lock_order.run(ms_of(_LOCK_CYCLE_CLEAN))
    assert "lock-order-cycle" not in rules(fs)


def test_lock_held_blocking_flagged():
    fs = lock_order.run(ms_of(_LOCK_BLOCKING))
    assert any(f.rule == "lock-held-blocking"
               and "queue_get" in f.symbol for f in fs)


def test_lock_held_blocking_bounded_clean():
    clean = _LOCK_BLOCKING.replace("self._q.get()",
                                   "self._q.get(timeout=1.0)")
    assert lock_order.run(ms_of(clean)) == []


def test_lock_held_blocking_through_callee():
    # the blocking op is one resolved call away — still attributed
    src = _LOCK_BLOCKING.replace(
        "            return self._q.get()",
        "            return self.h()\n\n"
        "    def h(self):\n"
        "        return self._q.get()")
    fs = lock_order.run(ms_of(src))
    assert any(f.rule == "lock-held-blocking" and "via B.h" in f.message
               for f in fs)


def test_lock_dispatch_under_lock_flagged():
    # a count kernel's launcher is device dispatch: holding a lock
    # across it is the hold the reference flags around its count
    src = """
import threading
from tuplewise_tpu_torch.ops.count_kernels import signed_count

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def f(self, runs, signs, sets, qa, qb):
        with self._lock:
            return signed_count(runs, signs, sets, qa, qb)
"""
    fs = lock_order.run(ms_of(src))
    assert any(f.rule == "lock-held-blocking"
               and "device_dispatch" in f.symbol for f in fs)


# --------------------------------------------------------------------- #
# pass 2 — traced purity                                                 #
# --------------------------------------------------------------------- #

_TRACED_BAD = """
import time

import torch


class F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        t = time.time()
        r = torch.rand(x.shape)
        return x + t + r
"""

_TRACED_CLEAN = """
import torch


class F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gen):
        return x + torch.randn(x.shape, generator=gen)
"""


def test_traced_purity_flagged():
    fs = traced_purity.run(ms_of(_TRACED_BAD))
    assert "traced-wall-clock" in rules(fs)
    assert "traced-host-rng" in rules(fs)


def test_traced_purity_clean():
    assert traced_purity.run(ms_of(_TRACED_CLEAN)) == []


def test_traced_purity_reaches_helpers():
    src = """
import time

import torch


def helper(x):
    return x + time.perf_counter()


class F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return helper(x)
"""
    fs = traced_purity.run(ms_of(src))
    assert any(f.rule == "traced-wall-clock" and "helper" in f.symbol
               for f in fs)


def test_traced_purity_ignores_host_code():
    src = """
import time


def host_only(x):
    return x + time.time()
"""
    assert traced_purity.run(ms_of(src)) == []


def test_traced_float_and_item_flagged():
    src = """
import torch


class F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor):
        return float(x) + x.item()
"""
    fs = traced_purity.run(ms_of(src))
    assert "traced-float-coercion" in rules(fs)
    assert "traced-device-sync" in rules(fs)


# --------------------------------------------------------------------- #
# pass 3 — telemetry cross-reference                                     #
# --------------------------------------------------------------------- #

def _telemetry_ms(consumer_metric: str, producer_metric: str = "hits_total"):
    producer = f"""
class Engine:
    def __init__(self, registry):
        self._c = registry.counter("{producer_metric}")
"""
    consumer = f"""
def _v(m, name, default=0):
    return m.get(name, {{}}).get("value", default)


def report(metrics):
    return {{"hits": _v(metrics, "{consumer_metric}")}}
"""
    return ModuleSet.from_sources({
        "tuplewise_tpu_torch/fixture_engine.py": producer,
        "tuplewise_tpu_torch/obs/fixture_report.py": consumer,
    })


def test_telemetry_typo_flagged():
    ms = _telemetry_ms("hist_total")    # typo of hits_total
    fs = telemetry_xref.run(
        ms, consumer_paths=("tuplewise_tpu_torch/obs/fixture_report.py",))
    assert any(f.rule == "telemetry-consumed-unproduced"
               and f.symbol == "hist_total" for f in fs)


def test_telemetry_match_clean():
    ms = _telemetry_ms("hits_total")
    fs = telemetry_xref.run(
        ms, consumer_paths=("tuplewise_tpu_torch/obs/fixture_report.py",))
    assert fs == []


def test_telemetry_flight_kind_xref():
    src = """
class E:
    def go(self, flight):
        flight.record("heal_done", n=1)


def _after(kind, seq):
    return None


def diagnose(by_kind):
    a = by_kind.get("heal_done")
    b = _after("heal_exhasted", 0)    # typo
    return a, b
"""
    fs = telemetry_xref.run(
        ms_of(src), consumer_paths=("tuplewise_tpu_torch/fixture.py",))
    syms = {f.symbol for f in fs}
    assert "flight:heal_exhasted" in syms
    assert "flight:heal_done" not in syms


def test_telemetry_type_conflict_flagged():
    src = """
class E:
    def __init__(self, m):
        self._a = m.counter("depth_live")
        self._b = m.gauge("depth_live")
"""
    fs = telemetry_xref.run(ms_of(src), consumer_paths=())
    assert any(f.rule == "telemetry-type-conflict"
               and f.symbol == "depth_live" for f in fs)


def test_metric_direct_construction_flagged():
    src = """
from tuplewise_tpu_torch.utils.profiling import Counter


def make():
    return Counter("rogue_total")
"""
    fs = telemetry_xref.run(ms_of(src), consumer_paths=())
    assert any(f.rule == "metric-direct-construction" for f in fs)


def test_doc_telemetry_unknown_flagged():
    ms = ModuleSet.from_sources(
        {"tuplewise_tpu_torch/fixture_engine.py":
            'class E:\n    def __init__(self, m):\n'
            '        self._c = m.counter("hits_total")\n'},
        texts={"README.md": "exports `hits_total` and `mists_total`"})
    fs = telemetry_xref.run(ms, consumer_paths=())
    syms = {f.symbol for f in fs if f.rule == "doc-telemetry-unknown"}
    assert syms == {"mists_total"}


def test_fstring_producer_matches_glob():
    src = """
_KINDS = ("insert", "score")


class E:
    def __init__(self, m):
        self._c = {k: m.counter(f"requests_{k}_total") for k in _KINDS}


def _v(m, name, default=0):
    return m.get(name, {}).get("value", default)


def report(metrics):
    return _v(metrics, "requests_insert_total")
"""
    fs = telemetry_xref.run(
        ms_of(src), consumer_paths=("tuplewise_tpu_torch/fixture.py",))
    assert fs == []


# --------------------------------------------------------------------- #
# pass 4 — compile ladder                                                #
# --------------------------------------------------------------------- #

_LADDER_BAD = """
def next_bucket(n):
    b = 256
    while b < n:
        b *= 2
    return b


def tenant_pack_counts(mesh, pos_pack, cap_pos, neg_pack, cap_neg,
                       t_bucket, qn, qp):
    return qn


def serve(mesh, pos, neg, qn, qp):
    return tenant_pack_counts(mesh, pos, len(pos), neg,
                              next_bucket(len(neg)), 8, qn, qp)
"""


def test_ladder_raw_shape_flagged():
    fs = compile_ladder.run(ms_of(_LADDER_BAD))
    assert any(f.rule == "ladder-raw-shape" and ":2" in f.symbol
               for f in fs)
    # arg 4 went through next_bucket — must NOT be flagged
    assert not any(":4" in f.symbol for f in fs)


def test_ladder_bucketed_clean():
    clean = _LADDER_BAD.replace("neg, len(pos), neg,",
                                "neg, next_bucket(len(pos)), neg,").replace(
        "tenant_pack_counts(mesh, pos, len(pos), neg,",
        "tenant_pack_counts(mesh, pos, next_bucket(len(pos)), neg,")
    assert compile_ladder.run(ms_of(clean)) == []


def test_ladder_chases_one_assignment():
    src = _LADDER_BAD.replace(
        "    return tenant_pack_counts(mesh, pos, len(pos), neg,",
        "    cp = len(pos)\n"
        "    return tenant_pack_counts(mesh, pos, cp, neg,")
    fs = compile_ladder.run(ms_of(src))
    assert any(f.rule == "ladder-raw-shape" for f in fs)


# --------------------------------------------------------------------- #
# pass 5 — config / CLI / doc drift                                      #
# --------------------------------------------------------------------- #

_CONFIG_SRC = """
import dataclasses


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    budget: int = 64
    secret_knob: int = 3


def build(ap):
    ap.add_argument("--budget", type=int, default=64)
"""


def test_config_field_unbound_flagged():
    ms = ModuleSet.from_sources(
        {"tuplewise_tpu_torch/fixture.py": _CONFIG_SRC},
        texts={"README.md": "uses `--budget`"})
    fs = config_drift.run(ms)
    assert any(f.rule == "config-field-unbound"
               and f.symbol == "ServingConfig.secret_knob" for f in fs)


def test_config_field_documented_clean():
    ms = ModuleSet.from_sources(
        {"tuplewise_tpu_torch/fixture.py": _CONFIG_SRC},
        texts={"README.md": "uses `--budget` and `secret_knob`"})
    assert config_drift.run(ms) == []


def test_doc_flag_unknown_flagged():
    ms = ModuleSet.from_sources(
        {"tuplewise_tpu_torch/fixture.py": _CONFIG_SRC},
        texts={"README.md":
               "run with `--budget 8` and `--budgte 9`"})  # typo
    fs = config_drift.run(ms)
    assert any(f.rule == "doc-flag-unknown"
               and f.symbol == "--budgte" for f in fs)


# --------------------------------------------------------------------- #
# module graph — import cycles                                           #
# --------------------------------------------------------------------- #

def test_import_cycle_flagged():
    ms = ModuleSet.from_sources({
        "tuplewise_tpu_torch/aaa.py": "import tuplewise_tpu_torch.bbb\n",
        "tuplewise_tpu_torch/bbb.py": "import tuplewise_tpu_torch.aaa\n",
    })
    fs = modgraph.run(ms)
    assert rules(fs) == ["import-cycle"]


def test_lazy_import_cycle_clean():
    ms = ModuleSet.from_sources({
        "tuplewise_tpu_torch/aaa.py": "import tuplewise_tpu_torch.bbb\n",
        "tuplewise_tpu_torch/bbb.py":
            "def f():\n    import tuplewise_tpu_torch.aaa\n",
    })
    assert modgraph.run(ms) == []


# --------------------------------------------------------------------- #
# waivers + ratchet                                                      #
# --------------------------------------------------------------------- #

def _finding(sym: str) -> Finding:
    return Finding("lock-held-blocking", "tuplewise_tpu_torch/x.py", 1, sym,
                   "msg")


def test_waiver_matches_and_ratchets():
    w = load_waivers("""
[[waiver]]
rule = "lock-held-blocking"
file = "tuplewise_tpu_torch/x.py"
symbol = "F::*"
count = 1
reason = "intentional hold documented in DESIGN for this fixture"
""")
    unwaived, waived, unused = apply_waivers(
        [_finding("F::l::sleep"), _finding("F::l::fsync")], w)
    # the ratchet: count=1 absorbs the first finding, the second is
    # NEW damage and stays unwaived
    assert len(waived) == 1 and len(unwaived) == 1
    assert unused == []


def test_waiver_unused_reported():
    w = load_waivers("""
[[waiver]]
rule = "lock-held-blocking"
file = "tuplewise_tpu_torch/gone.py"
reason = "this code was deleted; the waiver should be pruned"
""")
    unwaived, waived, unused = apply_waivers([_finding("F::x")], w)
    assert len(unwaived) == 1 and waived == [] and len(unused) == 1


@pytest.mark.parametrize("body", [
    "[[waiver]]\nrule = \"r\"\nfile = \"f\"\nreason = \"short\"",
    "[[waiver]]\nfile = \"f\"\nreason = \"no rule given here at all\"",
    "[[waiver]]\nrule = \"r\"\nfile = \"f\"\ncount = 0\n"
    "reason = \"count zero is meaningless padding text\"",
    "[table]\nrule = \"r\"",
    "rule = \"r\"",
])
def test_waiver_file_validation(body):
    with pytest.raises(WaiverError):
        load_waivers(body)


def test_waiver_symbol_glob():
    w = Waiver(rule="r", file="f", reason="x" * 30, symbol="A.*::lock::*")
    assert w.matches(Finding("r", "f", 1, "A.m::lock::sleep", ""))
    assert not w.matches(Finding("r", "f", 1, "B.m::lock::sleep", ""))


# --------------------------------------------------------------------- #
# full-repo invariants (the CI gate's exact contract)                    #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def repo_report():
    return run_checks(root=REPO)


def test_repo_clean_modulo_waivers(repo_report):
    assert repo_report["parse_errors"] == {}
    assert "waiver_error" not in repo_report
    assert repo_report["findings"] == [], (
        "unwaived findings — fix them or add a justified waiver:\n"
        + "\n".join(f"{f['rule']}: {f['file']} [{f['symbol']}]"
                    for f in repo_report["findings"]))
    assert repo_report["ok"] is True


def test_repo_no_import_cycles(repo_report):
    assert repo_report["import_cycles"] == []


def test_repo_no_stale_waivers(repo_report):
    assert repo_report["unused_waivers"] == [], (
        "waivers.toml entries matching nothing — prune them")


def test_repo_every_pass_ran(repo_report):
    per_pass = repo_report["summary"]["per_pass"]
    assert set(per_pass) == {"lock-order", "traced-purity",
                             "telemetry-xref", "compile-ladder",
                             "config-drift", "races", "exactness",
                             "hotpath", "lifecycle", "module-graph"}
    # the waived findings prove the passes bite on the real tree
    assert repo_report["summary"]["waived"] > 0


def test_runner_cli_writes_report(tmp_path):
    from tuplewise_tpu_torch.analysis.runner import main

    out = tmp_path / "report.json"
    args = types.SimpleNamespace(root=REPO, waivers=None, json=False,
                                 out=str(out), strict=False)
    assert main(args) == 0
    import json

    rep = json.loads(out.read_text())
    assert rep["ok"] is True


# --------------------------------------------------------------------- #
# drive-by: the registry's single                   #
# create-or-return path                                                  #
# --------------------------------------------------------------------- #

def test_registry_create_or_return_shared_across_call_sites():
    from tuplewise_tpu_torch.utils.profiling import MetricsRegistry

    m = MetricsRegistry()
    # two independent call sites (engine + flusher pattern) must share
    # ONE object per (name, labels) — never twin series
    g1 = m.gauge("queue_depth_live")
    g2 = m.gauge("queue_depth_live")
    assert g1 is g2
    h1 = m.histogram("insert_latency_s", labels={"tenant": "a"})
    h2 = m.histogram("insert_latency_s", labels={"tenant": "a"})
    assert h1 is h2
    assert m.histogram("insert_latency_s") is not h1  # distinct series
    with pytest.raises(TypeError):
        m.counter("queue_depth_live")    # type conflict raises loudly


def test_registry_create_or_return_concurrent():
    import threading as th

    from tuplewise_tpu_torch.utils.profiling import MetricsRegistry

    m = MetricsRegistry()
    got = []
    barrier = th.Barrier(8)

    def reg():
        barrier.wait()
        got.append(m.counter("races_total"))

    threads = [th.Thread(target=reg) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({id(c) for c in got}) == 1
    got[0].inc()
    assert m.snapshot()["races_total"]["value"] == 1
