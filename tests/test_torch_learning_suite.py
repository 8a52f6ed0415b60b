"""scripts_torch/learning_suite.py against the JAX package's
scripts/learning_suite.py on the CPU.

The quick gauss cell (N = 16, n_r = 5; cf. tests/test_torch_learner.py's
sim-learner case) and the mesh8 stage's instrument-overlap cell go
through both suites. Rows have the reference's keys plus the card stamp;
the two packages draw partitions from different generators, so the
final held-out AUCs agree statistically: the mean finals of S seeds
within 4 standard errors of their difference. Inside the port the
overlap cell holds its sim replicas to its mesh trainer within
rel 1e-4 / abs 1e-6 (tests/test_torch_mesh_trainers.py's tolerance).
Both write into tmp_path.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def suites():
    return (_load("scripts/learning_suite.py", "ref_learning_suite"),
            _load("scripts_torch/learning_suite.py", "port_learning_suite"))


@pytest.fixture
def outdirs(suites, tmp_path, monkeypatch):
    ref, port = suites
    for mod, sub in ((ref, "ref"), (port, "port")):
        monkeypatch.setattr(mod, "RESULTS", str(tmp_path / sub))
        monkeypatch.setattr(mod, "QUICK", True)
        monkeypatch.setattr(mod, "_touched", set())
        os.makedirs(tmp_path / sub)
    monkeypatch.setattr(port, "DEVICE", torch.device("cpu"))
    return tmp_path / "ref", tmp_path / "port"


def _finalized(mod, d, name):
    with contextlib.redirect_stderr(io.StringIO()):
        mod.finalize_outputs()
    with open(d / name) as f:
        return [json.loads(x) for x in f]


def test_quick_gauss_cell_matches_the_reference(suites, outdirs):
    ref, port = suites
    d_ref, d_port = outdirs
    S = 8
    with contextlib.redirect_stderr(io.StringIO()):
        for mod, extra in ((ref, {"platform": "cpu"}), (port, {})):
            data, scorer, p0, base, _, steps = mod._gauss_cells(True)
            cfg = dataclasses.replace(base, n_workers=16,
                                      repartition_every=5)
            mod.run_config(scorer, p0, data, cfg, n_seeds=S,
                           eval_every=steps // 20 or 1, dataset="gaussians",
                           out_name="learning_gauss.jsonl", **extra)
    (j,) = _finalized(ref, d_ref, "learning_gauss_quick.jsonl")
    (r,) = _finalized(port, d_port, "learning_gauss_quick.jsonl")
    assert set(r) == set(j) | {"card"}
    assert r["platform"] == "cpu" and r["card"] is None and r["quick"]
    for k in ("kernel", "lr", "steps", "n_workers", "n_r", "comm_events",
              "eval_steps", "n_train", "n_test", "m_per_worker", "n_seeds"):
        assert r[k] == j[k], k
    # the init point is shared: equal up to float32 scoring
    assert abs(r["auc_mean"][0] - j["auc_mean"][0]) < 1e-4
    gap = abs(r["final_auc_mean"] - j["final_auc_mean"])
    assert gap < 4 * max(np.hypot(r["final_auc_se"], j["final_auc_se"]),
                         1e-4)
    assert r["final_auc_mean"] > r["auc_mean"][0]


def test_mesh8_overlap_cell_matches_the_reference(suites, outdirs):
    ref, port = suites
    d_ref, d_port = outdirs
    with contextlib.redirect_stderr(io.StringIO()):
        ref.stage_mesh8(True, "cpu")
        port.stage_mesh8(True)
    for name in ("learning_throughput_quick.jsonl",
                 "learning_mesh_overlap_quick.jsonl"):
        want = _finalized(ref, d_ref, name)
        got = _finalized(port, d_port, name)
        assert [set(r) for r in got] == [set(r) | {"card"} for r in want]
    (j,) = want
    (r,) = got
    for k in ("cell", "n_workers", "n_r", "steps", "n_seeds"):
        assert r[k] == j[k], k
    sim, mesh = np.asarray(r["sim_final_auc"]), np.asarray(
        r["mesh_final_auc"])
    np.testing.assert_allclose(mesh, sim, rtol=port.OVERLAP_RTOL,
                               atol=port.OVERLAP_ATOL)
    assert r["max_abs_delta"] <= 1e-4
    # two seeds a side: the mean finals within 4 se of their difference
    # (the seed spread, floored at 2e-3 for a pair of seeds)
    jj = np.asarray(j["sim_final_auc"])
    se = np.hypot(sim.std(ddof=1), jj.std(ddof=1)) / np.sqrt(2)
    assert abs(sim.mean() - jj.mean()) < 4 * max(se, 2e-3)


def test_overlap_cell_raises_when_the_instruments_disagree(suites, outdirs,
                                                           monkeypatch):
    _, port = suites
    from tuplewise_tpu_torch.models import pairwise_sgd

    real = pairwise_sgd.evaluate_auc
    calls = {"n": 0}

    def skewed(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw) + (0.01 if calls["n"] > 2 else 0.0)

    monkeypatch.setattr(pairwise_sgd, "evaluate_auc", skewed)
    data, scorer, p0, base, *_ = port._gauss_cells(True)
    cfg = dataclasses.replace(base, n_workers=8, repartition_every=1,
                              steps=10)
    with pytest.raises(AssertionError, match="disagree"):
        port.overlap_cell(scorer, p0, data, cfg, 2)


def test_gauss_chip_holds_a_device_against_its_twin(suites, outdirs,
                                                   monkeypatch):
    """gauss-chip's cells carry their twin's mean final AUC, standard
    error and seconds; a run held against itself agrees (z = 0), and a
    disagreement past TWIN_Z raises."""
    _, port = suites
    _, d_port = outdirs
    with contextlib.redirect_stderr(io.StringIO()):
        port.gauss_against(True, torch.device("cpu"))
    rows = _finalized(port, d_port, "learning_gauss_chip_quick.jsonl")
    assert [r["n_r"] for r in rows] == [1, None]
    for r in rows:
        assert r["twin_device"] == "cpu" and r["twin_wallclock_s"] >= 0
        assert r["twin_final_auc_mean"] == r["final_auc_mean"]
        assert r["twin_final_auc_se"] == r["final_auc_se"] > 0
        assert port.twin_z(r, {"final_auc_mean": r["twin_final_auc_mean"],
                               "final_auc_se": r["twin_final_auc_se"]}) == 0
    assert port.twin_z({"final_auc_mean": 0.8, "final_auc_se": 0.003},
                       {"final_auc_mean": 0.78, "final_auc_se": 0.004}) \
        == pytest.approx(4.0)
    monkeypatch.setattr(port, "TWIN_Z", -1.0)
    with contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(AssertionError, match="disagree"):
            port.gauss_against(True, torch.device("cpu"))


def test_gauss_chip_and_trace_need_the_card(suites, outdirs):
    _, port = suites
    with pytest.raises(SystemExit, match="card"):
        port.stage_gauss_chip(True)
    # a CPU run's trace holds no device work: the digest refuses it
    with contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(ValueError, match="CPU-only"):
            port.stage_trace(True)


def test_main_runs_every_stage_on_one_device(suites, tmp_path, monkeypatch):
    """No platform split: the sim, mesh and throughput stages run in one
    invocation; without a card and without --device, main exits 2."""
    _, port = suites
    with contextlib.redirect_stderr(io.StringIO()):
        assert port.main(["--quick", "--stages", "designs,chip",
                          "--device", "cpu"], results=str(tmp_path)) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["learning_designs_quick.jsonl",
                     "learning_throughput_chip_quick.jsonl"]
    with open(tmp_path / names[1]) as f:
        rows = [json.loads(x) for x in f]
    assert [r["label"] for r in rows] == [
        f"chip_n2048_nr{nr}{lf}" for nr in ("1", "10", "inf")
        for lf in ("", "_lossfree")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(SystemExit) as e:
            port.main(["--quick", "--stages", "chip"], results=str(tmp_path))
    assert e.value.code == 2
