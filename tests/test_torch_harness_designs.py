"""The distinct designs in the port's estimator and harness, the rest of
the harness (fix_data, degree 3, checkpoint/resume, the trade-off curves,
write_jsonl) and the key audit, on the CPU.

Tolerances: designed estimates are held to the complete statistic within
5 standard errors of their Monte-Carlo mean; the conditional variances
to their exact closed forms within 20 % (M = 800: the sampling error of
a variance is 5 %) or 25 % (degree 3, M = 400: 7 %); swor / swr at
B = G/2 in [0.4, 0.6] (the exact ratio is 0.50005). A chunked and
resumed run equals a straight one bit for bit (per-rep chains; on the
CPU every row's sum is taken in the same order whatever rows share the
batch). The looped degree-3 complete rows equal the JAX
harness's ``_estimate_once`` on the same numpy data within rel 1e-5
(float32 distances in different orders).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tuplewise_tpu.estimators.estimator import Estimator as JEstimator
from tuplewise_tpu.harness import variance as JH
from tuplewise_tpu_torch import Estimator
from tuplewise_tpu_torch.data import make_gaussians
from tuplewise_tpu_torch.estimators.variance import (
    conditional_incomplete_variance,
)
from tuplewise_tpu_torch.harness import variance as H
from tuplewise_tpu_torch.ops.kernels import get_kernel
from tuplewise_tpu_torch.ops.pair_tiles import triplet_stats
from tuplewise_tpu_torch.utils.checkpoint import load_checkpoint
from tuplewise_tpu_torch.utils.rng import audit_keys, derive_seed


@pytest.fixture(scope="module")
def scores():
    X, Y = make_gaussians(400, 400, dim=1, separation=1.0, seed=6)
    return X[:, 0], Y[:, 0]


def _spread(fn, M):
    vals = np.asarray([fn(m) for m in range(M)])
    return vals.mean(), vals.std(ddof=1) / np.sqrt(M), vals


# --------------------------------------------------------------------- #
# Estimator.incomplete                                                  #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("design", ["swor", "bernoulli"])
def test_designed_incomplete_unbiased_and_as_the_host_oracle(scores,
                                                             design):
    """Two-sample: unbiased for the complete AUC, and the same
    distribution as the JAX numpy backend's host oracle (means within
    joint SE)."""
    s1, s2 = scores
    u_n = Estimator("auc", device="cpu").complete(s1, s2)
    est = Estimator("auc", device="cpu")
    mean, se, got = _spread(lambda m: est.incomplete(
        s1, s2, n_pairs=4000, seed=m, design=design), 40)
    assert abs(mean - u_n) < 5 * se + 1e-6
    ref = JEstimator("auc", backend="numpy")
    _, se_r, want = _spread(lambda m: ref.incomplete(
        s1, s2, n_pairs=4000, seed=m, design=design), 40)
    assert abs(mean - want.mean()) < 5 * np.hypot(se, se_r) + 1e-7


@pytest.mark.parametrize("kernel,design", [
    ("scatter", "swor"), ("scatter", "bernoulli"),
    ("triplet_indicator", "swor"), ("triplet_hinge", "bernoulli")])
def test_one_sample_and_triplet_designs_unbiased(kernel, design):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((60, 3))
    B = None if kernel == "scatter" else rng.standard_normal((40, 3))
    est = Estimator(kernel, device="cpu")
    u_n = est.complete(A) if B is None else est.complete(A, B)
    mean, se, vals = _spread(lambda m: est.incomplete(
        A, B, n_pairs=1500, seed=m, design=design), 40)
    assert abs(mean - u_n) < 5 * se + 1e-6
    assert len(set(vals.tolist())) > 1


def test_swor_variance_reduction_near_the_full_grid():
    """B = 0.8 G (the device bound): swor's variance falls well below
    swr's, whose extra Var(h)/B term the distinct design removes."""
    X, Y = make_gaussians(32, 32, dim=1, separation=1.0, seed=8)
    est = Estimator("auc", device="cpu")
    B = int(0.8 * 32 * 32)
    swor = [est.incomplete(X[:, 0], Y[:, 0], n_pairs=B, seed=m,
                           design="swor") for m in range(300)]
    swr = [est.incomplete(X[:, 0], Y[:, 0], n_pairs=B, seed=m)
           for m in range(300)]
    assert np.var(swor) < 0.6 * np.var(swr)


# --------------------------------------------------------------------- #
# the harness                                                           #
# --------------------------------------------------------------------- #

def _cfg(**kw):
    base = dict(kernel="auc", scheme="incomplete", n_pos=300, n_neg=250,
                n_workers=4, n_rounds=2, n_pairs=2000, n_reps=64, seed=3)
    return H.VarianceConfig(**dict(base, **kw))


@pytest.mark.parametrize("design", ["swor", "bernoulli"])
def test_harness_designed_incomplete_unbiased(design):
    r = H.run_variance_experiment(_cfg(design=design), device="cpu")
    assert abs(r["mean"] - r["population_value"]) < 5 * r["std_error"]
    ratio = r["variance"] / r["closed_form_variance"]
    assert 0.45 < ratio < 1.85, ratio
    assert r["batched"] and r["recovery"] == {"resumed_from": 0}


def test_fix_data_swor_halves_swr_at_half_the_grid():
    """fix_data, n = 100 a class, B = G/2 = 5000, M = 800: each design's
    variance matches the exact conditional form, and swor / swr = 0.5."""
    out = {}
    for design in ("swr", "swor", "bernoulli"):
        cfg = _cfg(n_pos=100, n_neg=100, n_pairs=5000, n_reps=800,
                   design=design, fix_data=True)
        r = H.run_variance_experiment(cfg, device="cpu")
        s1, s2 = H.fixed_dataset(cfg, device="cpu")
        u = Estimator("auc", device="cpu").complete(s1, s2)
        want = conditional_incomplete_variance(
            u * (1 - u), 100 * 100, n_pairs=5000, design=design)
        assert r["closed_form_variance"] == pytest.approx(want, rel=1e-9)
        assert abs(r["variance"] / want - 1) < 0.2, (design, r["variance"])
        assert abs(r["mean"] - u) < 5 * r["std_error"]
        out[design] = r["variance"]
    assert 0.4 < out["swor"] / out["swr"] < 0.6


@pytest.mark.parametrize("design", ["swr", "swor", "bernoulli"])
def test_degree3_runner_conditional_variance(design):
    """The batched degree-3 incomplete runner: fix_data clouds, the
    triplet indicator's variance over design redraws against the exact
    form with s^2 = U(1-U), G = n1 (n1 - 1) n2."""
    cfg = _cfg(kernel="triplet_indicator", n_pos=20, n_neg=18, dim=3,
               separation=0.4, n_pairs=2000, n_reps=400, design=design,
               fix_data=True)
    r = H.run_variance_experiment(cfg, device="cpu")
    X, Y = H.fixed_dataset(cfg, device="cpu")
    assert X.shape == (20, 3) and Y.shape == (18, 3)
    s, c = triplet_stats(get_kernel("triplet_indicator"),
                         torch.as_tensor(X), torch.as_tensor(Y))
    u = float(s) / float(c)
    want = conditional_incomplete_variance(u * (1 - u), 20 * 19 * 18,
                                           n_pairs=2000, design=design)
    assert abs(r["variance"] / want - 1) < 0.25, (design, r["variance"])
    assert abs(r["mean"] - u) < 5 * r["std_error"]
    assert r["batched"] and r["closed_form_variance"] is None


@pytest.mark.parametrize("cfg", [
    _cfg(scheme="complete"), _cfg(scheme="local"),
    _cfg(scheme="repartitioned"), _cfg(design="swr"), _cfg(design="swor"),
    _cfg(design="bernoulli"), _cfg(design="swor", fix_data=True),
    _cfg(kernel="hinge", scheme="complete"),
    _cfg(kernel="logistic", design="bernoulli"),
    _cfg(kernel="triplet_indicator", n_pos=40, n_neg=30, dim=2,
         n_pairs=500, design="swor"),
    _cfg(kernel="triplet_hinge", scheme="local", n_pos=24, n_neg=20,
         dim=2, n_workers=2)], ids=lambda c: f"{c.kernel}-{c.scheme}-"
                                           f"{c.design}-{c.fix_data}")
def test_chunked_and_resumed_equals_straight(tmp_path, cfg):
    """12 reps straight, against 8 reps in chunks of 3 with a checkpoint
    and a resume grown to 12 in chunks of 3: the same estimates, bit for
    bit, and the resume reports where it started."""
    cfg = dataclasses.replace(cfg, n_reps=12)
    straight = str(tmp_path / "straight.npz")
    H.run_variance_experiment(cfg, checkpoint_path=straight, device="cpu")
    cut = str(tmp_path / "cut.npz")
    H.run_variance_experiment(dataclasses.replace(cfg, n_reps=8),
                              checkpoint_path=cut, checkpoint_every=3,
                              device="cpu")
    assert load_checkpoint(cut)["step"] == 8
    r = H.run_variance_experiment(cfg, checkpoint_path=cut,
                                  checkpoint_every=3, device="cpu")
    assert r["recovery"]["resumed_from"] == 8
    a = load_checkpoint(straight)["extra"]["estimates"]
    b = load_checkpoint(cut)["extra"]["estimates"]
    assert a.shape == (12,) and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="config mismatch"):
        H.run_variance_experiment(dataclasses.replace(cfg, seed=9),
                                  checkpoint_path=cut, device="cpu")


def test_looped_degree3_complete_rows_equal_reference(tmp_path):
    """The looped complete degree-3 scheme draws numpy clouds from
    make_gaussians(seed * 1_000_003 + rep), as the JAX harness does: its
    rows equal the reference's _estimate_once on the same data."""
    cfg = _cfg(kernel="triplet_indicator", scheme="complete", n_pos=30,
               n_neg=25, dim=3, n_reps=4, seed=2)
    path = str(tmp_path / "ck.npz")
    r = H.run_variance_experiment(cfg, checkpoint_path=path, device="cpu")
    rows = load_checkpoint(path)["extra"]["estimates"]
    jcfg = JH.VarianceConfig(**dict(cfg.to_json(), backend="jax"))
    jest = JEstimator("triplet_indicator", backend="jax", n_workers=4)
    want = np.asarray([JH._estimate_once(jest, jcfg, rep) for rep in range(4)])
    np.testing.assert_allclose(rows, want, rtol=1e-5)
    assert len(set(rows.tolist())) == 4
    assert not r["batched"] and r["closed_form_variance"] is None
    for scheme in ("local", "repartitioned"):
        rl = H.run_variance_experiment(
            dataclasses.replace(cfg, scheme=scheme), device="cpu")
        assert abs(rl["mean"] - r["mean"]) < 0.05


def test_tradeoff_curves_and_write_jsonl(tmp_path):
    cfg = _cfg(n_reps=16)
    rounds = H.tradeoff_vs_rounds(cfg, rounds=(1, 2, 4), device="cpu")
    assert [r["config"]["n_rounds"] for r in rounds] == [1, 2, 4]
    assert {r["config"]["scheme"] for r in rounds} == {"repartitioned"}
    pairs = H.tradeoff_vs_pairs(cfg, pairs=(100, 1000), device="cpu")
    assert [r["config"]["n_pairs"] for r in pairs] == [100, 1000]
    assert pairs[0]["closed_form_variance"] > pairs[1]["closed_form_variance"]
    workers = H.tradeoff_vs_workers(cfg, workers=(2, 8), device="cpu")
    assert [(r["config"]["scheme"], r["config"]["n_workers"])
            for r in workers] == [("local", 2), ("local", 8)]
    assert (workers[0]["closed_form_variance"]
            < workers[1]["closed_form_variance"])
    with pytest.raises(ValueError, match=r"\[400\]"):
        # validated up front: no cell of the sweep runs
        H.tradeoff_vs_workers(cfg, workers=(2, 400), device="cpu")
    path = tmp_path / "rows.jsonl"
    H.write_jsonl(rounds, str(path))
    H.write_jsonl(pairs[:1], str(path))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 4 and lines[-1]["config"]["n_pairs"] == 100
    assert lines[0] == json.loads(json.dumps(rounds[0]))


def test_unported_options_and_errors_raise():
    cfg = _cfg(n_reps=4)
    with pytest.raises(NotImplementedError, match="slice 8"):
        H.run_variance_experiment(cfg, trace_dir="t", device="cpu")
    with pytest.raises(NotImplementedError, match="slice 7"):
        H.run_variance_experiment(cfg, chaos=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 7"):
        H.run_variance_experiment(cfg, heal_retries=2, device="cpu")
    with pytest.raises(ValueError, match="unknown sampling design"):
        H.run_variance_experiment(_cfg(design="nope"), device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        H.run_variance_experiment(_cfg(n_pos=10, n_neg=10, n_pairs=90,
                                       design="swor"), device="cpu")


def test_audit_keys_raises_on_a_repeated_chain():
    with audit_keys():
        derive_seed(0, "design", 1)
        derive_seed(0, "design", 2)
        with pytest.raises(AssertionError, match="derived twice"):
            derive_seed(0, "design", 1)
    derive_seed(0, "design", 1)          # outside the scope: no record
    with audit_keys():
        # one harness run derives every chain of its reps once
        H.run_variance_experiment(_cfg(scheme="repartitioned", n_reps=4),
                                  device="cpu")
