"""scripts_torch/mesh8_cpu.py against the JAX package's
scripts/mesh8_cpu.py on the CPU.

A small run (module constants) checks the wiring and the rows' schema:
the reference's configs and keys, plus the card stamp. The committed card
rows (results/torch/mesh8_cpu.jsonl, mesh8_2d_cpu.jsonl) are held against
the reference's committed rows (results/mesh8_cpu.jsonl,
mesh8_2d_cpu.jsonl), config by config: the means within 4 standard errors
of their difference. Both files are read only.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("mesh8_cpu.jsonl", "mesh8_2d_cpu.jsonl")
# the keys of the reference's configs (its committed rows predate the
# design and fix_data fields, which both harnesses now carry)
REF_KEYS = ("kernel", "scheme", "backend", "n_pos", "n_neg", "dim",
            "separation", "n_workers", "n_rounds", "n_pairs",
            "partition_scheme", "n_reps", "seed")


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def _cfg(row):
    return {k: row["config"][k] for k in REF_KEYS}


@pytest.fixture(scope="module")
def port():
    return _load("scripts_torch/mesh8_cpu.py", "port_mesh8_cpu")


def test_small_run_has_the_reference_schema(port, tmp_path, monkeypatch,
                                            capsys):
    for k, v in dict(N=256, M=8, CHUNK=4, RAGGED=(261, 251), SCATTER_N=64,
                     TRIPLET_N=16).items():
        monkeypatch.setattr(port, k, v)
    assert port.main(["--device", "cpu"], results=str(tmp_path)) == 0
    assert sorted(os.listdir(tmp_path)) == sorted(FILES)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(printed) == 13
    for name in FILES:
        got = _rows(tmp_path / name)
        want = _rows(os.path.join(ROOT, "results", name))
        assert len(got) == len(want)
        for r, j in zip(got, want):
            assert set(r) >= set(j) | {"card", "wallclock_s"}
            assert r["card"] is None and r["vmapped"] is True
            assert r["devices"] == "cpu" and r["n_reps"] == 8
            assert r.get("mesh") == j.get("mesh")
            small = dict(_cfg(j), n_reps=8)
            for k, v in (("n_pos", 256), ("n_neg", 256)):
                if j["config"][k] == 8192:
                    small[k] = v
            if j["config"]["n_pos"] == 8197:
                small.update(n_pos=261, n_neg=251)
            if j["config"]["kernel"] == "scatter":
                small.update(n_pos=64, n_neg=64)
            if j["config"]["kernel"].startswith("triplet"):
                small.update(n_pos=16, n_neg=16)
            assert _cfg(r) == small
            assert np.isfinite(r["mean"]) and r["variance"] > 0


@pytest.mark.parametrize("name", FILES)
def test_committed_card_rows_agree_with_the_reference_rows(name):
    got = _rows(os.path.join(ROOT, "results", "torch", name))
    want = _rows(os.path.join(ROOT, "results", name))
    assert len(got) == len(want) > 0
    for r, j in zip(got, want):
        assert _cfg(r) == _cfg(j) and r.get("mesh") == j.get("mesh")
        assert r["card"] and r["card"].startswith("NVIDIA H100")
        assert r["devices"].startswith("cuda") and r["n_reps"] == 100
        gap = abs(r["mean"] - j["mean"])
        assert gap < 4 * np.hypot(r["std_error"], j["std_error"]), (
            _cfg(r), r["mean"], j["mean"])
