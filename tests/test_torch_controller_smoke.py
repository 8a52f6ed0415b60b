"""scripts_torch/controller_smoke.py against the JAX package's
scripts/controller_smoke.py on the CPU.

The port serves the reference's flash crowd (its T, S, queue, burst,
rounds, SLO and controller specs). At one round and a smaller wedge the
controlled run's per-tenant wins2 equal the reference's single-tenant
index over the admitted events (the oracle swapped for the JAX package's
``ExactAucIndex``), every actuation carries its signal and the doctor
attributes them all. Whether the controlled run stays healthy and the
twin breaches depends on the host's timing: that is asserted on the card
(chip_smoke.py phase 30), not here.
"""

import contextlib
import importlib.util
import io
import os

import pytest
import torch

from tuplewise_tpu.serving import ExactAucIndex as RefIndex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("scripts_torch/controller_smoke.py",
                 "port_controller_smoke")


@pytest.fixture
def small(port, monkeypatch):
    monkeypatch.setattr(port, "ROUNDS", 1)
    monkeypatch.setattr(port, "WEDGE", 20_000)
    monkeypatch.setattr(port, "DEVICE", torch.device("cpu"))
    return port


def test_the_scenario_is_the_reference_one(port):
    ref = _load("scripts/controller_smoke.py", "ref_controller_smoke")
    for k in ("T", "SHARDS", "QUEUE", "BURST", "ROUNDS", "SLO_SPEC",
              "CTL_SPEC"):
        assert getattr(port, k) == getattr(ref, k), k
    # the reference's wedge is spelled inline
    src = open(os.path.join(ROOT, "scripts", "controller_smoke.py")).read()
    assert "rng.standard_normal(100_000)" in src and port.WEDGE == 100_000


def test_controlled_run_parity_with_the_reference_oracle(small, tmp_path,
                                                         monkeypatch):
    port = small

    class Oracle(RefIndex):
        def __init__(self, device=None):
            super().__init__(engine="jax")

        def close(self):
            pass

    monkeypatch.setattr(port, "ExactAucIndex", Oracle)
    c = port.run(controlled=True, artifact_dir=str(tmp_path))
    assert c["parity"], c["wins_mismatch"]
    assert c["actuation_signals_nonnull"] == c["actuations"]
    assert sorted(os.listdir(tmp_path)) == ["flight.jsonl", "metrics.jsonl"]
    report = port.diagnose(run_dir=str(tmp_path), slo_spec=port.SLO_SPEC,
                           context={"queue_size": port.QUEUE})
    acts = report["actuations"] or {"total": 0, "attributed": 0}
    assert acts["attributed"] == acts["total"] == c["actuations"]


def test_uncontrolled_twin_keeps_parity(small):
    u = small.run(controlled=False)
    assert u["parity"] and u["actuations"] == 0
    assert u["tenant_throttled_total"] == 0


def test_a_lost_event_fails_the_smoke(small, tmp_path, monkeypatch):
    port = small

    def broken(controlled, artifact_dir=None):
        return {"slo_healthy": True, "slo": {}, "rejected_total": 0,
                "tenant_rejected_total": 0, "tenant_throttled_total": 5,
                "actuations": 1, "actuation_signals_nonnull": 1,
                "parity": False, "wins_mismatch": ["t3"]}

    monkeypatch.setattr(port, "run", broken)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = port.main(["--device", "cpu"], results=str(tmp_path))
    assert rc == 1 and "wins2 diverged from independents: ['t3']" in \
        err.getvalue()
    assert not os.listdir(tmp_path)
