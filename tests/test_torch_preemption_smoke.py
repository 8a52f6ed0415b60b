"""scripts_torch/preemption_smoke.py against the JAX package's
scripts/preemption_smoke.py on the CPU.

The port's cycles are the reference's (the same CLI arguments, the same
kill at the 2nd checkpoint), read from the arguments the reference hands
its ``_cycle``. One cycle runs here with ``--device cpu`` (three CLI
children of the port): the resumed run equals the straight one bit for
bit. A kill that never comes fails the smoke.
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("scripts_torch/preemption_smoke.py",
                 "port_preemption_smoke")


def test_the_cycles_are_the_reference_ones(port, tmp_path, monkeypatch):
    ref = _load("scripts/preemption_smoke.py", "ref_preemption_smoke")
    calls = []
    monkeypatch.setattr(ref, "_cycle", lambda name, args, ck, fields:
                        calls.append((name, args, os.path.basename(ck),
                                      tuple(fields))) or {})
    with contextlib.redirect_stderr(io.StringIO()):
        assert ref.main(["--out", str(tmp_path / "ref.jsonl")]) == 0
    assert [(n, list(a), c, f) for n, a, c, f in port.CYCLES] == calls
    assert port._KILL_SPEC == ref._KILL_SPEC


def test_one_cycle_is_bit_identical_after_sigkill(port, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(port, "CYCLES", port.CYCLES[:1])
    with contextlib.redirect_stderr(io.StringIO()):
        assert port.main(["--device", "cpu"], results=str(tmp_path)) == 0
    assert os.listdir(tmp_path) == ["preemption_smoke.jsonl"]
    with open(tmp_path / "preemption_smoke.jsonl") as f:
        (row,) = [json.loads(x) for x in f]
    assert row["stage"] == "preemption_smoke" and row["ok"]
    assert row["card"] is None
    sgd = row["pairwise_sgd"]
    assert sgd["resumed_from"] == 4           # the 2nd checkpoint of 2
    assert set(sgd) == {"resumed_from", "params_sha256", "auc_test",
                        "loss_last"}


def test_a_kill_that_never_comes_fails(port, tmp_path, monkeypatch):
    monkeypatch.setattr(port, "CYCLES", port.CYCLES[:1])
    monkeypatch.setattr(port, "_KILL_SPEC", json.dumps({"faults": [
        {"point": "checkpoint", "on_call": 99, "action": "sigkill"}]}))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = port.main(["--device", "cpu"], results=str(tmp_path))
    assert rc == 1 and "expected SIGKILL death, got rc=0" in err.getvalue()
    # the checkpoints' temporary directory is gone, and no row was written
    assert not os.listdir(tmp_path)
