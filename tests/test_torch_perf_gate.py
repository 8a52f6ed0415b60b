"""scripts_torch/perf_gate.py against the JAX package's
scripts/perf_gate.py on the CPU.

The port's gate is the reference's: on the JAX package's committed
results/serving.jsonl (read only) and on synthetic histories with and
without a breach, ``load_rows``, ``comparable_history`` and ``gate`` give
the same rows and verdict dicts. Its default history is the port's
results/torch/serving.jsonl, which has no gateable rows yet.
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_HISTORY = os.path.join(ROOT, "results", "serving.jsonl")


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gates():
    return (_load("scripts/perf_gate.py", "ref_perf_gate"),
            _load("scripts_torch/perf_gate.py", "port_perf_gate"))


def _verdicts(mod, rows, stage, **kw):
    kw = dict(dict(tolerance_frac=0.25, mad_k=4.0, min_history=2), **kw)
    return mod.gate(rows, metrics=mod._STAGE_METRICS.get(stage, mod._GATED),
                    **kw)


def test_the_specs_are_the_reference_ones(gates):
    ref, port = gates
    assert port._STAGE_METRICS == ref._STAGE_METRICS
    assert port._DEFAULT_STAGES == ref._DEFAULT_STAGES
    assert port._LEGACY_KEY == ref._LEGACY_KEY


@pytest.mark.parametrize("stage", ["bench_streaming", "multi_tenant",
                                   "fleet_incremental", "serving_kernel",
                                   "host_tax", "delta_compaction", "serve"])
def test_committed_reference_history_gives_the_same_verdicts(gates, stage):
    ref, port = gates
    rows = port.load_rows(REF_HISTORY, stage)
    assert rows == ref.load_rows(REF_HISTORY, stage) and rows
    assert (port.comparable_history(rows, rows[-1])
            == ref.comparable_history(rows, rows[-1]))
    for kw in ({}, {"tolerance_frac": 0.01, "mad_k": 0.5},
               {"min_history": 1}):
        assert _verdicts(port, rows, stage, **kw) == _verdicts(
            ref, rows, stage, **kw)


def _history(newest_eps, newest_p99, digest="d1"):
    rows = [{"stage": "bench_streaming", "value": v, "config_digest": digest,
             "insert_latency_p99_ms": p, "run_id": f"r{i}"}
            for i, (v, p) in enumerate([(10000, 5.0), (10400, 5.2),
                                        (9800, 4.9), (10100, 5.1)])]
    rows.append({"stage": "bench_streaming", "value": newest_eps,
                 "config_digest": digest, "run_id": "new",
                 "insert_latency_p99_ms": newest_p99})
    # a row of another config never joins the history
    rows.insert(1, {"stage": "bench_streaming", "value": 1.0,
                    "config_digest": "other", "insert_latency_p99_ms": 99})
    return rows


@pytest.mark.parametrize("newest,ok", [((10050, 5.05), True),
                                       ((6000, 5.0), False),
                                       ((10000, 9.0), False)])
def test_synthetic_histories_give_the_same_verdicts(gates, newest, ok):
    ref, port = gates
    rows = _history(*newest)
    v = _verdicts(port, rows, "bench_streaming")
    assert v == _verdicts(ref, rows, "bench_streaming")
    assert v["ok"] is ok and v["n_history"] == 4


@pytest.mark.parametrize("mode,rc", [("warn", 0), ("fail", 1)])
def test_main_on_a_breach_is_the_reference_main(gates, tmp_path, mode, rc):
    ref, port = gates
    hist = tmp_path / "serving.jsonl"
    hist.write_text("".join(json.dumps(r) + "\n"
                            for r in _history(6000, 5.0)))
    outs = []
    for mod, sub in ((ref, "ref"), (port, "port")):
        out = tmp_path / sub / "perf_gate.jsonl"
        with contextlib.redirect_stdout(io.StringIO()) as so, \
                contextlib.redirect_stderr(io.StringIO()):
            assert mod.main(["--history", str(hist), "--mode", mode,
                             "--stage", "bench_streaming",
                             "--out", str(out)]) == rc
        outs.append((json.loads(out.read_text()), json.loads(so.getvalue())))
    assert outs[0] == outs[1] and outs[1][0]["ok"] is False


def test_default_history_is_the_port_one(gates, tmp_path):
    _, port = gates
    assert port.RESULTS == os.path.join(ROOT, "results", "torch")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert port.main(["--mode", "fail"], results=str(tmp_path)) == 0
    assert "no history file" in err.getvalue()
    assert str(tmp_path / "serving.jsonl") in err.getvalue()
    # the committed port history holds serve rows only: nothing to gate
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert port.main(["--mode", "fail", "--out",
                          str(tmp_path / "v.jsonl")]) == 0
    assert err.getvalue().strip().splitlines()[-1] == (
        "PERF GATE: no gateable rows in "
        f"{os.path.join(ROOT, 'results', 'torch', 'serving.jsonl')!r}")
    assert not os.listdir(tmp_path)
