"""scripts_torch/northstar.py against the JAX package's
scripts/northstar.py on the CPU.

One row of each scheme goes through each module's ``run`` (the 1e6
stage's function) and the ``exact`` stage runs at --quick sizes in both.
The rows have the same file names, the reference's keys plus the card
stamp, and the same config dicts but for the backend. The two draw from
different generators, so their values agree statistically, the bound of
tests/test_torch_harness.py's diff cases: the means within 4 standard
errors of their difference, and the ratio of the Monte-Carlo variances of
M reps inside the two-sided 1e-4 band of F(M - 1, M - 1). Both write into
tmp_path (the reference's module RESULTS, the port's results=).
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy.stats import f as f_dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEMES = {"complete": "variance_n1e6.jsonl", "local": "variance_n1e6.jsonl",
           "repartitioned": "rounds_n1e6.jsonl",
           "incomplete": "pairs_n1e6.jsonl"}


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def drivers():
    return (_load("scripts/northstar.py", "ref_northstar"),
            _load("scripts_torch/northstar.py", "port_northstar"))


def _agree(r, j, M):
    gap = abs(r["mean"] - j["mean"])
    assert gap < 4 * np.hypot(r["std_error"], j["std_error"]), (gap, r, j)
    lo, hi = f_dist.ppf(1e-4, M - 1, M - 1), f_dist.ppf(1 - 1e-4, M - 1,
                                                         M - 1)
    assert lo < r["variance"] / j["variance"] < hi


def _same_config(port_cfg, ref_cfg):
    assert port_cfg["backend"] == "torch" and ref_cfg["backend"] == "jax"
    assert dict(port_cfg, backend="jax") == ref_cfg


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_run_rows_match_the_reference(drivers, scheme, tmp_path,
                                      monkeypatch):
    ref, port = drivers
    kw = dict(scheme=scheme, n_pos=200, n_neg=200, n_workers=4, n_rounds=2,
              n_pairs=500, n_reps=32, seed=0)
    for mod, sub in ((ref, "ref"), (port, "port")):
        monkeypatch.setattr(mod, "RESULTS", str(tmp_path / sub))
        os.makedirs(tmp_path / sub)
    monkeypatch.setattr(port, "DEVICE", torch.device("cpu"))
    with contextlib.redirect_stderr(io.StringIO()):
        j = ref.run(ref.VarianceConfig(**kw), SCHEMES[scheme])
        r = port.run(port.VarianceConfig(**kw), SCHEMES[scheme])
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "ref")
    with open(tmp_path / "port" / SCHEMES[scheme]) as f:
        assert json.loads(f.read()) == r
    assert set(r) == set(j) | {"card"}
    assert r["card"] is None and r["platform"] == "cpu"
    assert r["vmapped"] is True and r["recovery"] == j["recovery"]
    _same_config(r["config"], j["config"])
    assert r["population_value"] == j["population_value"]
    _agree(r, j, 32)


def test_exact_stage_matches_the_reference(drivers, tmp_path, monkeypatch):
    ref, port = drivers
    monkeypatch.setattr(ref, "RESULTS", str(tmp_path / "ref"))
    monkeypatch.setattr(sys, "argv", ["northstar.py", "--quick", "--stages",
                                      "exact"])
    with contextlib.redirect_stderr(io.StringIO()):
        ref.main()
        assert port.main(["--quick", "--stages", "exact", "--device", "cpu"],
                         results=str(tmp_path / "port")) == 0
    names = sorted(n for n in os.listdir(tmp_path / "ref")
                   if n.endswith(".jsonl"))
    assert names == ["exact_n1e6_quick.jsonl", "exact_n1e7_quick.jsonl"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name, M in zip(names, (8, 4)):
        with open(tmp_path / "ref" / name) as f:
            (j,) = [json.loads(x) for x in f]
        with open(tmp_path / "port" / name) as f:
            (r,) = [json.loads(x) for x in f]
        assert set(r) == set(j) | {"card"} and r["n_reps"] == M
        # one dispatch a rep, looped on the host
        assert r["vmapped"] is False
        _same_config(r["config"], j["config"])
        _agree(r, j, M)


def test_exact_reps_are_the_rank_auc_of_their_draws(drivers, monkeypatch):
    """A rep's value is the exact rank AUC of its two draws, and the same
    rep draws the same data whatever the series around it."""
    _, port = drivers
    from tuplewise_tpu_torch.models.metrics import auc_score
    from tuplewise_tpu_torch.utils.rng import generator

    monkeypatch.setattr(port, "DEVICE", torch.device("cpu"))
    g = generator(0, "mc_rep", 3, "data", device="cpu")
    s1 = torch.randn(500, generator=g) + 1.0
    s2 = torch.randn(500, generator=g)
    assert port.exact_rep(500, 3) == auc_score(s1.numpy(), s2.numpy())
    assert port.exact_series(500, 5)[0][3] == port.exact_rep(500, 3)


def test_unknown_stage_and_no_card_exit_2(drivers, tmp_path, monkeypatch):
    _, port = drivers
    with contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(SystemExit) as e:
            port.main(["--stages", "nope", "--device", "cpu"],
                      results=str(tmp_path))
        assert e.value.code == 2
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            port.main(["--quick", "--stages", "exact"], results=str(tmp_path))
        assert e.value.code == 2
    assert not os.listdir(tmp_path)
