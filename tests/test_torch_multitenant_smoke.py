"""scripts_torch/multitenant_smoke.py against the JAX package's
scripts/multitenant_smoke.py on the CPU.

Both run the same scenario (T, S, the streams' seeds). At a smaller T and
stream (module constants) the fleet-vs-independents leg of each gives the
same summary (tenants, one count a coalesced apply), with and without the
count kernel (the port's plain comparison count here). Then the port's
whole smoke runs into tmp_path, and a monkeypatched defect fails it.
"""

import contextlib
import importlib.util
import io
import json
import os

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
def smokes():
    return (_load("scripts/multitenant_smoke.py", "ref_multitenant_smoke"),
            _load("scripts_torch/multitenant_smoke.py",
                  "port_multitenant_smoke"))


@pytest.fixture
def small(smokes, monkeypatch):
    ref, port = smokes
    assert (port.T, port.SHARDS, port.N_EVENTS) == (ref.T, ref.SHARDS,
                                                    ref.N_EVENTS)
    for mod in smokes:
        monkeypatch.setattr(mod, "T", 12)
        monkeypatch.setattr(mod, "N_EVENTS", 1200)
    monkeypatch.setattr(port, "DEVICE", torch.device("cpu"))
    return smokes


@pytest.mark.parametrize("count_kernel", [False, True])
def test_fleet_vs_independent_matches_the_reference(small, count_kernel):
    ref, port = small
    j = ref.fleet_vs_independent(count_kernel=count_kernel)
    r = port.fleet_vs_independent(count_kernel=count_kernel)
    assert r["parity"] == j["parity"] == "bit-identical"
    assert r["tenants"] == j["tenants"] == 12
    assert r["count_calls"] == j["count_calls"]
    if count_kernel:
        # one count a coalesced apply, each a kernel call
        assert r["kernel_calls"] == j["kernel_calls"] == r["count_calls"]


def test_whole_smoke_into_its_results_directory(small, tmp_path, capsys):
    ref, port = small
    with contextlib.redirect_stderr(io.StringIO()):
        assert port.main(["--count-kernel", "--device", "cpu"],
                         results=str(tmp_path)) == 0
    assert os.listdir(tmp_path) == ["multitenant_smoke.jsonl"]
    with open(tmp_path / "multitenant_smoke.jsonl") as f:
        (row,) = [json.loads(x) for x in f]
    assert json.loads(capsys.readouterr().out.strip()) == row
    assert set(row) == {"stage", "tenants", "mesh_shards", "n_events",
                        "card", "independent_parity", "count_kernel",
                        "engine", "admission", "whale"}
    assert row["card"] is None and row["tenants"] == 12
    e = row["engine"]
    assert e["slo_healthy"] and e["slo_series"] == 12
    assert 0 < e["fleet_count_calls"] <= e["batches"]
    assert e["tenant_auc_max_abs_err"] == 0.0
    assert row["admission"] == {"rejected_tenant": "flood"}
    w = row["whale"]
    assert w["promotions"] >= 1 and w["parity"] == "bit-identical"
    assert w["pack_partial_replaces"] > 0
    assert w["shipped_fraction_of_full"] < 0.5


def test_a_broken_fleet_count_fails(small, tmp_path, monkeypatch):
    _, port = small
    wins2 = port.TenantFleetIndex.wins2
    monkeypatch.setattr(port.TenantFleetIndex, "wins2",
                        lambda self, t: wins2(self, t) + 1)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = port.main(["--device", "cpu"], results=str(tmp_path))
    assert rc == 1 and "fleet/independent mismatch" in err.getvalue()
    assert not os.listdir(tmp_path)
