"""scripts_torch/streaming_smoke.py against the JAX package's
scripts/streaming_smoke.py on the CPU.

Both replay the same make_stream draws (numpy, seed 0), so the port's
exact AUC equals the reference's bit for bit. The sharded leg runs at a
smaller floor (SHARDED_MIN_EVENTS) on two workers of the CPU's worker
axis, its count-kernel index on the plain comparison count. Every output
goes to tmp_path.
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EVENTS = 1500


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smokes():
    return (_load("scripts/streaming_smoke.py", "ref_streaming_smoke"),
            _load("scripts_torch/streaming_smoke.py", "port_streaming_smoke"))


def _row(path):
    with open(path) as f:
        (row,) = [json.loads(x) for x in f if x.strip()]
    return row


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stderr(io.StringIO()):
        return fn(*a, **kw)


def test_plain_leg_matches_the_reference(smokes, tmp_path):
    ref, port = smokes
    assert port.REQUIRED_FIELDS == ref.REQUIRED_FIELDS
    assert _quiet(ref.main, ["--n-events", str(N_EVENTS), "--out",
                             str(tmp_path / "ref.jsonl")]) == 0
    assert _quiet(port.main, ["--n-events", str(N_EVENTS), "--device",
                              "cpu"], results=str(tmp_path / "port")) == 0
    assert os.listdir(tmp_path / "port") == ["serving_smoke.jsonl"]
    j = _row(tmp_path / "ref.jsonl")
    r = _row(tmp_path / "port" / "serving_smoke.jsonl")
    assert set(r) >= set(ref.REQUIRED_FIELDS) | {"stage", "card"}
    assert r["stage"] == j["stage"] == "ci_smoke"
    assert r["card"] is None and r["compactions"] >= 1
    # the same numpy draws: the exact statistic is equal bit for bit
    assert r["auc_exact"] == j["auc_exact"]
    assert r["auc_abs_err"] == 0.0


def test_sharded_leg_parity_and_bytes(smokes, tmp_path, monkeypatch):
    ref, port = smokes
    n = 2500
    monkeypatch.setattr(port, "SHARDED_MIN_EVENTS", n)
    # the floor lifts a shorter stream to SHARDED_MIN_EVENTS
    assert _quiet(port.main, ["--mesh-shards", "2", "--delta-fraction",
                              "0.25", "--n-events", "1000", "--count-kernel",
                              "--device", "cpu"],
                  results=str(tmp_path)) == 0
    r = _row(tmp_path / "serving_smoke_sharded.jsonl")
    assert r["stage"] == "ci_smoke_sharded_delta" and r["n_events"] == n
    assert r["count_kernel"]["parity"] == "bit-identical"
    assert r["count_kernel"]["calls"] >= 1
    assert 0 < r["bytes_per_compaction"] and r["bytes_h2d"] > 0
    assert r["major_merges"] >= 1 and r["auc_abs_err"] == 0.0
    # the delta engine's exact AUC is the reference's over the same stream
    assert _quiet(ref.main, ["--n-events", str(n), "--out",
                             str(tmp_path / "ref.jsonl")]) == 0
    assert r["auc_exact"] == _row(tmp_path / "ref.jsonl")["auc_exact"]


def test_a_broken_oracle_parity_fails(smokes, tmp_path, monkeypatch):
    _, port = smokes
    replay = port.replay

    def off_by_one(*a, **kw):
        rec = replay(*a, **kw)
        rec["auc_abs_err"] = 1.0
        return rec

    monkeypatch.setattr(port, "replay", off_by_one)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = port.main(["--n-events", "600", "--device", "cpu"],
                       results=str(tmp_path))
    assert rc == 1 and "SMOKE FAIL: auc_abs_err" in err.getvalue()
    assert not os.listdir(tmp_path)
