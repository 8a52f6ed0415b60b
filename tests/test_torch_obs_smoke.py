"""scripts_torch/obs_smoke.py against the JAX package's
scripts/obs_smoke.py on the CPU.

The port's smoke runs the reference's chaos schedule, SLO spec and
exemplar threshold at the reference's size into tmp_path. Its wall-clock
outcomes (the count of periodic snapshots, the tail exemplars under the
60 ms delay) are not asserted here: MIN_SNAPSHOTS and MIN_EXEMPLARS are
lowered for the run; the card's run (chip_smoke.py phase 30) keeps them.
The reference's own checks accept the port's Chrome trace, spans, flight
dump and speedscope export, and the port's doctor gives the reference
doctor's verdict over the same files (the doctor leg of the reference's
CI).
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("metrics.jsonl", "obs_flight.jsonl", "obs_prof.collapsed",
             "obs_prof.speedscope.json", "obs_spans.jsonl", "obs_smoke.jsonl",
             "obs_trace.json")


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smokes():
    return (_load("scripts/obs_smoke.py", "ref_obs_smoke"),
            _load("scripts_torch/obs_smoke.py", "port_obs_smoke"))


@pytest.fixture(scope="module")
def run(smokes, tmp_path_factory):
    """The port's smoke at its 4000 events (fewer leave the 15th batch,
    and its scheduled crash, out), its wall-clock floors lowered."""
    _, port = smokes
    out = tmp_path_factory.mktemp("obs")
    mp = pytest.MonkeyPatch()
    mp.setattr(port, "MIN_SNAPSHOTS", 1)
    mp.setattr(port, "MIN_EXEMPLARS", 0)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            rc = port.main(["--device", "cpu"], results=str(out))
    finally:
        mp.undo()
    return rc, out


def test_the_scenario_is_the_reference_one(smokes):
    ref, port = smokes
    assert port.CHAOS == ref.CHAOS and port.SLO == ref.SLO
    assert port.TAIL_EXEMPLAR_MS == ref.TAIL_EXEMPLAR_MS
    assert (port.METRICS_EVERY_S, port.MIN_SNAPSHOTS, port.MIN_EXEMPLARS) \
        == (0.2, 2, 1)


def test_smoke_passes_and_writes_its_artifacts(run):
    rc, out = run
    assert rc == 0
    assert sorted(os.listdir(out)) == sorted(ARTIFACTS)
    with open(out / "obs_smoke.jsonl") as f:
        (row,) = [json.loads(x) for x in f]
    assert row["stage"] == "obs_smoke" and row["card"] is None
    assert row["n_events"] == 4000 and row["auc_abs_err"] == 0.0
    assert row["slo_healthy"] and row["stage_coverage"] >= 0.95
    assert abs(row["host_tax_coverage"] - 1.0) <= 1e-6


def test_reference_checks_accept_the_port_exports(smokes, run):
    ref, _ = smokes
    _, out = run
    with contextlib.redirect_stderr(io.StringIO()):
        assert ref._check_chrome(str(out / "obs_trace.json")) == 0
        assert ref._check_stage_sums(str(out / "obs_spans.jsonl")) == 0
        assert ref._check_speedscope(
            str(out / "obs_prof.speedscope.json")) == 0


def test_port_doctor_gives_the_reference_verdict(run, capsys):
    from tuplewise_tpu.harness.cli import main as ref_cli
    from tuplewise_tpu_torch.harness.cli import main as port_cli

    _, out = run
    args = ["doctor", "--metrics", str(out / "metrics.jsonl"), "--flight",
            str(out / "obs_flight.jsonl"), "--spans",
            str(out / "obs_spans.jsonl"), "--quiet"]
    verdicts = []
    for cli, extra in ((port_cli, ["--device", "cpu"]), (ref_cli, [])):
        assert cli(args + extra) == 0
        verdicts.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    port_v, ref_v = verdicts
    assert port_v == ref_v
    assert port_v["healthy"]
    assert port_v["faults"] == port_v["faults_resolved"] >= 4


def test_a_fault_that_never_fires_fails_the_smoke(smokes, tmp_path,
                                                  monkeypatch):
    _, port = smokes
    chaos = {"faults": port.CHAOS["faults"] + [
        {"point": "batcher", "on_call": 10 ** 6, "action": "error"}]}
    monkeypatch.setattr(port, "CHAOS", chaos)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = port.main(["--n-events", "1000", "--device", "cpu"],
                       results=str(tmp_path))
    assert rc == 1 and "chaos_inject events for 4 scheduled" in err.getvalue()
