"""Estimator(backend="torch", device="cpu") against the JAX package.

Complete statistics are deterministic and compared value to value:
auc within 1e-6 absolute (the JAX rank form averages in float32, the
port's is exact), hinge and logistic within rel 1e-6 (float32 values,
Kahan float32 vs float64 sums), scatter within rel 1e-5 (the JAX moment
form runs in float32, where the moments cancel). Local rounds are
compared on the same numpy-made worker blocks. Schemes that draw their
own randomness (torch vs jax generators differ) are compared
statistically.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu import Estimator as JaxEstimator
from tuplewise_tpu.data import make_gaussians as j_make_gaussians
from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops import pair_tiles as jt
from tuplewise_tpu_torch import Estimator
from tuplewise_tpu_torch.data import make_gaussians
from tuplewise_tpu_torch.utils.state import from_numpy, to_numpy


@pytest.fixture(scope="module")
def data():
    X, Y = make_gaussians(600, 500, dim=2, separation=1.0, seed=3)
    return X, Y


def test_synthetic_data_is_a_copy():
    for a, b in zip(make_gaussians(50, 40, 3, 0.5, seed=9),
                    j_make_gaussians(50, 40, 3, 0.5, seed=9)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["auc", "hinge", "logistic", "scatter"])
def test_complete_matches_jax(data, name):
    X, Y = data
    if name == "scatter":
        args = (X[:200].astype(np.float32),)
    else:
        args = (X[:, 0].astype(np.float32), Y[:, 0].astype(np.float32))
    want = JaxEstimator(name, backend="jax").complete(*args)
    got = Estimator(name, backend="torch", device="cpu").complete(*args)
    if name == "auc":
        assert abs(got - want) < 1e-6
        plain = Estimator(name, device="cpu", auc_fast=False).complete(*args)
        assert plain == got                # pair sum == rank form, exactly
    else:
        tol = 1e-5 if name == "scatter" else 1e-6
        assert abs(got - want) / abs(want) < tol, (got, want)


def _jax_local(kernel, s1, s2, i1, i2, alive, ma=None, mb=None):
    vals = []
    for w in range(i1.shape[0]):
        kw = {}
        if ma is not None:
            kw = {"mask_a": jnp.asarray(ma[w]), "mask_b": jnp.asarray(mb[w])}
        s, c = jt.pair_stats(kernel, jnp.asarray(s1[i1[w]]),
                             jnp.asarray(s2[i2[w]]), tile_a=64, tile_b=64,
                             **kw)
        vals.append(float(s) / float(c))
    vals = np.asarray(vals)
    return float(np.sum(vals * alive) / np.sum(alive))


@pytest.mark.parametrize("dropped", [(), (1, 4)])
def test_local_round_from_blocks_matches_jax(data, dropped):
    from tuplewise_tpu_torch.parallel.faults import alive_mask

    X, Y = data
    s1, s2 = X[:, 0].astype(np.float32), Y[:, 0].astype(np.float32)
    rng = np.random.default_rng(0)
    i1 = rng.permutation(600)[:6 * 100].reshape(6, 100)
    i2 = rng.integers(0, 500, (6, 83))            # swr blocks
    alive = alive_mask(6, dropped)
    for name in ("auc", "hinge", "logistic"):
        be = Estimator(name, device="cpu").backend
        got = float(be.local_round_from_blocks(s1, s2, i1, i2, alive))
        want = _jax_local(jk.get_kernel(name), s1, s2, i1, i2, alive)
        assert abs(got - want) / abs(want) < 1e-6, (name, got, want)


def test_ragged_blocks_run_the_masked_sum(data):
    X, Y = data
    s1, s2 = X[:, 0].astype(np.float32), Y[:, 0].astype(np.float32)
    # 503 rows over 4 workers: blocks of 126/126/126/125, padded with -1
    perm = np.random.default_rng(1).permutation(503)
    i1 = np.full((4, 126), -1)
    for w, part in enumerate(np.array_split(perm, 4)):
        i1[w, :len(part)] = part
    i2 = np.random.default_rng(2).permutation(500)[:400].reshape(4, 100)
    alive = np.ones(4)
    ma = (i1 >= 0).astype(np.float32)
    mb = np.ones_like(i2, dtype=np.float32)
    for name in ("auc", "hinge", "logistic"):
        be = Estimator(name, device="cpu").backend
        got = float(be.local_round_from_blocks(s1, s2, i1, i2, alive))
        want = _jax_local(jk.get_kernel(name), s1, s2, np.maximum(i1, 0),
                          i2, alive, ma, mb)
        assert abs(got - want) / abs(want) < 1e-6, (name, got, want)


def test_drawn_rounds_take_the_unmasked_sum(data, monkeypatch):
    """draw_blocks never pads, so local and repartitioned rounds run the
    unmasked sum even where N does not divide n."""
    from tuplewise_tpu_torch.ops import pair_kernels

    def no_masked(*args, **kwargs):
        raise AssertionError("a drawn round reached masked_pair_sum")

    monkeypatch.setattr(pair_kernels, "masked_pair_sum", no_masked)
    X, Y = data
    est = Estimator("hinge", device="cpu", n_workers=7)
    full = est.complete(X[:, 0], Y[:, 0])
    assert abs(est.local_average(X[:, 0], Y[:, 0], seed=0) - full) < 0.05
    assert abs(est.repartitioned(X[:, 0], Y[:, 0], n_rounds=2, seed=0)
               - full) < 0.05


def _spread(fn, seeds):
    v = np.asarray([fn(s) for s in seeds])
    return v.mean(), v.std(ddof=1)


@pytest.mark.parametrize("scheme", ["local", "repartitioned", "incomplete"])
def test_randomized_schemes_agree_statistically(data, scheme):
    """Over 40 seeds, the port's and the JAX backend's estimates share
    their mean (within 5 standard errors of the difference) and their
    spread (ratio of standard deviations in [0.5, 2]: for two 40-sample
    estimates of one spread, an F(39, 39) test at a two-sided
    false-failure rate of about 3e-5)."""
    X, Y = data
    s1, s2 = X[:, 0].astype(np.float32), Y[:, 0].astype(np.float32)
    port = Estimator("hinge", device="cpu", n_workers=5)
    ref = JaxEstimator("hinge", backend="jax", n_workers=5)

    def call(est, seed):
        if scheme == "local":
            return est.local_average(s1, s2, seed=seed)
        if scheme == "repartitioned":
            return est.repartitioned(s1, s2, n_rounds=3, seed=seed)
        return est.incomplete(s1, s2, n_pairs=2000, seed=seed)

    seeds = range(40)
    pm, ps = _spread(lambda s: call(port, s), seeds)
    jm, js = _spread(lambda s: call(ref, s), seeds)
    se = np.sqrt((ps ** 2 + js ** 2) / 40)
    assert abs(pm - jm) < 5 * se, (pm, jm, se)
    assert 0.5 < ps / js < 2.0, (ps, js)
    complete = port.complete(s1, s2)
    assert abs(pm - complete) < 5 * ps / np.sqrt(40) + 1e-12


def test_unported_designs_raise(data):
    """Every design is ported; a distinct design raises only for a budget
    above 0.8 x the grid (the device sampler's contract)."""
    X, Y = data
    est = Estimator("auc", device="cpu")
    s1, s2 = X[:8, 0], Y[:8, 0]
    assert 0.0 <= est.incomplete(s1, s2, n_pairs=10, design="swor") <= 1.0
    with pytest.raises(ValueError, match="distinct"):
        est.incomplete(s1, s2, n_pairs=52, design="swor")
    tri = Estimator("triplet_hinge", device="cpu")
    assert tri.incomplete(X[:8], Y[:8], n_pairs=10, design="bernoulli") >= 0
    with pytest.raises(ValueError, match="distinct"):
        tri.incomplete(X[:4], Y[:4], n_pairs=39, design="bernoulli")


def test_state_round_trip():
    rng = np.random.default_rng(4)
    tree = {"w": rng.normal(size=(3, 2)), "b": (np.float64(1.5),
            [np.arange(4, dtype=np.int32), "tag"])}
    t = from_numpy(tree, "cpu")
    assert t["w"].dtype == torch.float32
    assert t["b"][1][0].dtype == torch.int32
    assert t["b"][1][1] == "tag" and isinstance(t["b"], tuple)
    back = to_numpy(t)
    np.testing.assert_array_equal(back["w"], tree["w"].astype(np.float32))
    np.testing.assert_array_equal(back["b"][1][0], tree["b"][1][0])
    assert float(back["b"][0]) == 1.5
    t64 = from_numpy(tree, "cpu", dtype=torch.float64)
    np.testing.assert_array_equal(to_numpy(t64)["w"], tree["w"])


def test_generator_chains_are_distinct_and_reproducible():
    from tuplewise_tpu_torch.utils.rng import PURPOSES, derive_seed, generator

    seeds = {derive_seed(7, p, *ix) for p in PURPOSES for ix in ((), (0,), (1,))}
    assert len(seeds) == 3 * len(PURPOSES)
    a = torch.rand(5, generator=generator(7, "mc_rep", 3))
    b = torch.rand(5, generator=generator(7, "mc_rep", 3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="purpose"):
        derive_seed(7, "no_such_purpose")


@pytest.mark.parametrize("batch", [(), (3,)])
def test_draw_blocks_swor_is_disjoint_and_swr_in_range(batch):
    from tuplewise_tpu_torch.parallel.device_partition import draw_blocks
    from tuplewise_tpu_torch.utils.rng import generator

    gen = generator(0, "partition")
    idx = draw_blocks(gen, 103, 4, "swor", batch=batch)
    assert idx.shape == (*batch, 4, 25)
    flat = idx.reshape(-1, 100)
    for row in flat:
        assert row.unique().numel() == 100 and int(row.max()) < 103
    swr = draw_blocks(gen, 103, 4, "swr", batch=batch)
    assert swr.shape == (*batch, 4, 25) and int(swr.min()) >= 0
    assert int(swr.max()) < 103
    with pytest.raises(ValueError, match="scheme"):
        draw_blocks(gen, 10, 2, "stratified")
