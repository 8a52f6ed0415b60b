"""The port's mesh Monte-Carlo (harness.mesh_mc, VarianceConfig(backend=
"mesh")) on the CPU worker axis, case for case with the mesh cases of
tests/test_harness.py:320-540.

* Every scheme, 1-D and 2-D, full and ragged, the scatter and triplet
  kernels and the distinct designs run on the mesh and are unbiased:
  the mean within 5 standard errors (+ the reference test's slack) of
  the population value.
* Against the JAX mesh runner on its 8-device CPU mesh: the same
  configuration's mean and variance agree within a stated two-sample
  bound. The two runners draw from different generators, so the mean
  difference is held to 5 sqrt(se1^2 + se2^2), and the variance ratio
  s1^2 / s2^2 to the F(M - 1, M - 1) distribution's two-sided 1e-4
  quantiles (scipy), the harness's chi2 band applied to a ratio.
* The complete value of a rep equals ``Estimator(backend="mesh")
  .complete`` on the same rows bit for bit; a chunked run equals a
  straight one bit for bit (reps drawn in blocks of 64).
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

from tuplewise_tpu.data import make_gaussians as jax_make_gaussians
from tuplewise_tpu.estimators.estimator import Estimator as JEstimator
from tuplewise_tpu.harness import variance as JH
from tuplewise_tpu_torch import Estimator
from tuplewise_tpu_torch.data import true_gaussian_auc
from tuplewise_tpu_torch.harness import mesh_mc
from tuplewise_tpu_torch.harness.variance import (
    VarianceConfig, fixed_dataset, run_variance_experiment,
)
from tuplewise_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

SCHEMES = ["complete", "local", "repartitioned", "incomplete"]


@pytest.fixture(autouse=True)
def one_thread():
    """The per-rep ops here are small: torch's thread pool only adds
    contention when the suite runs in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(**kw):
    base = dict(backend="mesh", n_pos=512, n_neg=512, n_workers=8,
                n_rounds=2, n_pairs=4096, n_reps=64)
    return run_variance_experiment(VarianceConfig(**dict(base, **kw)),
                                   device="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_unbiased_and_on_the_mesh(scheme):
    r = _run(scheme=scheme)
    assert r["batched"] and r["recovery"]["mesh_workers"] == 8
    assert abs(r["mean"] - true_gaussian_auc(1.0)) < (
        5 * r["std_error"] + 1e-3)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_ragged_sizes(scheme):
    """N does not divide n: the tail shards carry masked padding and the
    ring runs kernel 2's masked route."""
    r = _run(scheme=scheme, n_pos=515, n_neg=509, n_reps=48)
    assert abs(r["mean"] - true_gaussian_auc(1.0)) < (
        5 * r["std_error"] + 1e-3)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scatter_feature_kernel(scheme):
    """One-sample feature kernel: E h = E||X - X'||^2 / 2 = dim = 1 (the
    class shift cancels in differences)."""
    r = _run(kernel="scatter", scheme=scheme, n_reps=48)
    assert r["closed_form_variance"] is None
    assert abs(r["mean"] - 1.0) < 5 * r["std_error"] + 0.02


@pytest.mark.parametrize("design", ["swor", "bernoulli"])
def test_designed_incomplete(design):
    r = _run(scheme="incomplete", n_pos=96, n_neg=96, n_pairs=1000,
             design=design, n_reps=256)
    assert abs(r["mean"] - r["population_value"]) < 5 * r["std_error"]


def test_designed_one_sample():
    r = _run(kernel="scatter", scheme="incomplete", n_pos=96, n_neg=96,
             n_pairs=800, design="swor", n_reps=64)
    assert abs(r["mean"] - 1.0) < 5 * r["std_error"] + 0.02


def _triplet_reference(dim=3):
    """The numpy complete indicator on a large draw of the JAX runner's
    geometry (the class shift on the first feature)."""
    X, Y = jax_make_gaussians(400, 400, dim=dim, separation=1.0, seed=99)
    return JEstimator("triplet_indicator", backend="numpy").complete(X, Y)


def test_designed_triplet():
    r = _run(kernel="triplet_indicator", dim=3, n_pos=64, n_neg=48,
             n_pairs=600, design="swor", scheme="incomplete")
    assert abs(r["mean"] - _triplet_reference()) < 5 * r["std_error"] + 0.05


@pytest.mark.parametrize("scheme", SCHEMES)
def test_triplet_kernel(scheme):
    """Degree 3 runs mesh-native too: the double ring for complete,
    global-id anchor/positive exclusion elsewhere."""
    r = _run(kernel="triplet_indicator", scheme=scheme, n_pos=64, n_neg=56,
             dim=3, n_reps=24)
    assert abs(r["mean"] - _triplet_reference()) < (
        5 * r["std_error"] + 0.02)


@pytest.mark.parametrize("shape,n", [((2, 4), (512, 512)),
                                     ((4, 2), (515, 509))])
@pytest.mark.parametrize("scheme", ["complete", "local"])
def test_2d_mesh_runner(shape, n, scheme):
    cfg = VarianceConfig(backend="mesh", scheme=scheme, n_pos=n[0],
                         n_neg=n[1], n_workers=8, n_reps=16)
    ests = mesh_mc.make_mesh_mc_runner(
        cfg, mesh=make_mesh_2d(*shape, device="cpu"))(range(16))
    se = ests.std(ddof=1) / 4
    assert abs(ests.mean() - true_gaussian_auc(1.0)) < 5 * se + 1e-3
    if scheme == "complete":
        # the double ring equals the flat ring, rep for rep
        flat = mesh_mc.make_mesh_mc_runner(
            cfg, mesh=make_mesh(8, device="cpu"))(range(16))
        np.testing.assert_array_equal(ests, flat)


@pytest.mark.parametrize("scheme", ["local", "incomplete", "complete"])
def test_distribution_matches_the_jax_mesh_runner(scheme):
    M = 300
    base = dict(scheme=scheme, backend="mesh", n_pos=512, n_neg=512,
                n_workers=8, n_pairs=2048, n_reps=M, seed=4)
    rt = run_variance_experiment(VarianceConfig(**base), device="cpu")
    rj = JH.run_variance_experiment(JH.VarianceConfig(**base))
    se = np.hypot(rt["std_error"], rj["std_error"])
    assert abs(rt["mean"] - rj["mean"]) < 5 * se
    lo, hi = stats.f.ppf([5e-5, 1 - 5e-5], M - 1, M - 1)
    assert lo < rt["variance"] / rj["variance"] < hi, (
        rt["variance"], rj["variance"], lo, hi)


def _rep_rows(cfg, mesh, rep):
    """Rep ``rep``'s global rows, read back from the runner's shards."""
    a, *b = mesh_mc.worker_draws(cfg, mesh, ("mc_rep", rep // 64), 64)
    rows = [x[rep % 64].reshape((-1,) + x.shape[3:]) for x in [a] + b]
    sizes = (cfg.n_pos, cfg.n_neg)
    return [r[:n] for r, n in zip(rows, sizes)]


@pytest.mark.parametrize("kernel", ["auc", "hinge", "triplet_indicator",
                                    "scatter"])
@pytest.mark.parametrize("n", [(512, 512), (515, 509)])
def test_complete_equals_the_mesh_estimator(kernel, n):
    cfg = VarianceConfig(kernel=kernel, backend="mesh", n_pos=n[0],
                         n_neg=n[1], n_workers=8, dim=3,
                         n_reps=3, seed=9)
    if kernel == "triplet_indicator":
        cfg = dataclasses.replace(cfg, n_pos=n[0] // 8, n_neg=n[1] // 8)
    for mesh in (make_mesh(8, device="cpu"),
                 make_mesh_2d(2, 4, device="cpu")):
        run = mesh_mc.make_mesh_mc_runner(cfg, mesh=mesh)
        got = run(range(65, 68))
        est = Estimator(kernel, backend="mesh", mesh=mesh, device="cpu")
        for i, rep in enumerate(range(65, 68)):
            rows = _rep_rows(cfg, mesh, rep)
            want = est.complete(*rows[:1 if kernel == "scatter" else 2])
            assert got[i] == want, (kernel, rep)


def test_chunked_run_equals_straight_run(tmp_path):
    cfg = VarianceConfig(backend="mesh", scheme="repartitioned", n_pos=203,
                         n_neg=157, n_workers=4, n_rounds=2, n_reps=70,
                         seed=2)
    straight = run_variance_experiment(cfg, device="cpu")
    path = str(tmp_path / "mc.npz")
    run_variance_experiment(dataclasses.replace(cfg, n_reps=30),
                            checkpoint_path=path, checkpoint_every=7,
                            device="cpu")
    resumed = run_variance_experiment(cfg, checkpoint_path=path,
                                      checkpoint_every=11, device="cpu")
    assert resumed["recovery"]["resumed_from"] == 30
    assert resumed["mean"] == straight["mean"]
    assert resumed["variance"] == straight["variance"]


def test_fix_data_is_one_dataset_and_its_closed_form():
    """fix_data freezes the workers' rows (seed, "data_fixed", "shard",
    w): the complete scheme has zero variance, and the swor conditional
    variance sits near the exact form on that very dataset."""
    cfg = VarianceConfig(backend="mesh", scheme="complete", fix_data=True,
                         n_pos=60, n_neg=50, n_workers=4, n_reps=8)
    r = run_variance_experiment(cfg, device="cpu")
    assert r["variance"] == 0.0
    X, Y = fixed_dataset(cfg, "cpu")
    assert X.shape == (60,) and Y.shape == (50,)
    assert r["mean"] == Estimator("auc", device="cpu").complete(X, Y)
    inc = dataclasses.replace(cfg, scheme="incomplete", design="swor",
                              n_pairs=1500, n_reps=400)
    r = run_variance_experiment(inc, device="cpu")
    assert 0.7 < r["variance"] / r["closed_form_variance"] < 1.4


def test_runner_checks_its_mesh_and_fires_chaos():
    from tuplewise_tpu_torch.testing import FaultInjector

    cfg = VarianceConfig(backend="mesh", n_pos=64, n_neg=64, n_workers=4,
                         n_reps=130)
    with pytest.raises(ValueError, match="conflicts"):
        mesh_mc.make_mesh_mc_runner(cfg, mesh=make_mesh(2, device="cpu"))
    inj = FaultInjector()
    run = mesh_mc.make_mesh_mc_runner(cfg, chaos=inj, device="cpu")
    out = run(range(60, 130))             # blocks 0, 1 and 2
    assert out.shape == (70,) and inj.snapshot()["calls"]["mesh_mc"] == 3
    with pytest.raises(ValueError, match="unknown backend"):
        run_variance_experiment(dataclasses.replace(cfg, backend="jax"),
                                device="cpu")
