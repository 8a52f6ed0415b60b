"""The port's closed forms and Monte-Carlo harness.

The closed forms are the JAX package's formulas, and their plug-in zetas
are the same float64 sums taken in another order: they must agree to
rel 1e-12. The Monte-Carlo check runs M = 64 batched reps per scheme on
the CPU and holds the empirical variance to the closed form within the
chi-square band: s^2 / sigma^2 in [0.45, 1.85], the two-sided 1e-4
quantiles of chi2(63) / 63. sigma^2 comes from plug-in zetas of one
sample of the same size, whose own error (a few percent) the band
absorbs.
"""

import numpy as np
import pytest

from tuplewise_tpu.estimators import variance as jv
from tuplewise_tpu.harness import variance as JH
from tuplewise_tpu_torch.data import make_gaussians
from tuplewise_tpu_torch.estimators import variance as tv
from tuplewise_tpu_torch.harness.variance import (
    VarianceConfig, run_variance_experiment,
)


@pytest.fixture(scope="module")
def sample():
    X, Y = make_gaussians(700, 500, dim=2, separation=1.0, seed=8)
    return X, Y


@pytest.mark.parametrize("name", ["auc", "hinge", "logistic"])
def test_two_sample_closed_forms_match_jax(sample, name):
    X, Y = sample
    s1, s2 = X[:, 0], Y[:, 0]
    zt = tv.two_sample_zetas(name, s1, s2)
    zj = jv.two_sample_zetas(name, s1, s2)
    np.testing.assert_allclose(zt, zj, rtol=1e-12)
    kw = dict(n_workers=5)
    for fn, extra in [
        ("two_sample_variance", {}),
        ("local_average_variance", kw),
        ("repartitioned_variance", dict(kw, n_rounds=3)),
        ("incomplete_variance", dict(n_pairs=1000)),
    ]:
        np.testing.assert_allclose(
            getattr(tv, fn)(name, s1, s2, **extra),
            getattr(jv, fn)(name, s1, s2, **extra), rtol=1e-12)
    for design in ("swr", "swor", "bernoulli"):
        assert tv.incomplete_variance_from_zetas(
            zj, 700, 500, n_pairs=999, design=design
        ) == jv.incomplete_variance_from_zetas(
            zj, 700, 500, n_pairs=999, design=design)
    assert tv.conditional_incomplete_variance(
        0.2, 10_000, n_pairs=500, design="swor"
    ) == jv.conditional_incomplete_variance(
        0.2, 10_000, n_pairs=500, design="swor")


def test_one_sample_closed_form_matches_jax(sample):
    X, _ = sample
    A = X[:300]
    np.testing.assert_allclose(tv.one_sample_variance("scatter", A),
                               jv.one_sample_variance("scatter", A),
                               rtol=1e-12)


@pytest.mark.parametrize("scheme",
                         ["complete", "local", "repartitioned", "incomplete"])
def test_monte_carlo_variance_in_chi_square_band(scheme):
    cfg = VarianceConfig(kernel="auc", scheme=scheme, n_pos=400, n_neg=400,
                         n_workers=4, n_rounds=3, n_pairs=500, n_reps=64,
                         seed=1)
    r = run_variance_experiment(cfg, device="cpu")
    ratio = r["variance"] / r["closed_form_variance"]
    assert 0.45 < ratio < 1.85, (scheme, ratio)
    assert abs(r["mean"] - r["population_value"]) < 5 * r["std_error"]
    assert r["n_reps"] == 64 and r["device"] == "cpu"


def test_config_validation():
    with pytest.raises(ValueError, match="scheme"):
        run_variance_experiment(VarianceConfig(scheme="nope"), device="cpu")
    with pytest.raises(ValueError, match="n_workers"):
        run_variance_experiment(
            VarianceConfig(scheme="local", n_pos=4, n_neg=4, n_workers=8),
            device="cpu")


@pytest.mark.parametrize("scheme", ["complete", "incomplete", "local"])
def test_scatter_loops_the_estimator_as_the_reference(scheme):
    """The one-sample pair-feature kernel (``scatter``) loops the public
    Estimator rep by rep over numpy clouds, as the JAX harness does.
    complete is deterministic given the data: the means agree to rel
    1e-6 (float32 against float64 sums). The sampled schemes draw from
    different generators: the means agree within 4 standard errors of
    their difference, and the variance ratio of M = 32 reps lies in the
    two-sided 1e-4 band of F(31, 31), [0.247, 4.05]."""
    kw = dict(kernel="scatter", scheme=scheme, n_pos=200, n_neg=200,
              dim=2, n_workers=4, n_pairs=400, n_reps=32, seed=3)
    r = run_variance_experiment(VarianceConfig(**kw), device="cpu")
    j = JH.run_variance_experiment(JH.VarianceConfig(**kw, backend="jax"))
    assert not r["batched"] and r["closed_form_variance"] is None
    if scheme == "complete":
        np.testing.assert_allclose(r["mean"], j["mean"], rtol=1e-6)
        np.testing.assert_allclose(r["variance"], j["variance"], rtol=1e-4)
        return
    gap = abs(r["mean"] - j["mean"])
    assert gap < 4 * np.hypot(r["std_error"], j["std_error"]), gap
    assert 0.247 < r["variance"] / j["variance"] < 4.05
