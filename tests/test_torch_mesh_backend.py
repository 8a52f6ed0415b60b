"""Estimator(backend="mesh", device="cpu") of the port against the JAX
mesh backend on the 8 virtual CPU devices (tests/conftest.py), case for
case with tests/test_mesh_backend.py.

Complete statistics are compared value to value on the same numpy
inputs: auc exactly where n1 n2 < 2^23 (the JAX ring carries float32
sums, exact for such counts of halves, and divides in float32: the
port's float64 value rounded to float32 equals it), hinge and logistic
within rel 1e-5 (the JAX float32 carry), scatter within rel 1e-5 (the
JAX moment form runs in float32), the triplet indicator within 1e-6
(the JAX test's bound). The port is also held to its own single-device backend:
exact for auc and the indicator. Schemes that draw (torch and jax
generators differ) are held to the complete value statistically, as the
JAX tests hold theirs.
"""

import jax
import numpy as np
import pytest
import torch

from tuplewise_tpu import Estimator as JaxEstimator
from tuplewise_tpu.data import make_gaussians
from tuplewise_tpu_torch import Estimator, MeshBackend
from tuplewise_tpu_torch.backends.torch_backend import TorchBackend
from tuplewise_tpu_torch.ops import pair_tiles
from tuplewise_tpu_torch.parallel.device_partition import draw_blocks
from tuplewise_tpu_torch.parallel.faults import alive_mask
from tuplewise_tpu_torch.utils.rng import generator

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


@pytest.fixture(scope="module")
def scores():
    X, Y = make_gaussians(2000, 1600, dim=1, separation=1.0, seed=7)
    return X[:, 0].astype(np.float32), Y[:, 0].astype(np.float32)


@pytest.fixture(scope="module")
def mesh_est():
    return Estimator("auc", backend="mesh", n_workers=8, device="cpu")


def _jax(name, **kw):
    return JaxEstimator(name, backend="mesh", impl="xla", tile_a=128,
                        tile_b=128, **kw)


def _single(name):
    return Estimator(name, device="cpu")


class TestRingInvariance:
    @pytest.mark.parametrize("name", ["auc", "hinge", "logistic"])
    def test_complete_matches_jax_mesh(self, scores, name):
        s1, s2 = scores
        got = Estimator(name, backend="mesh", n_workers=8,
                        device="cpu").complete(s1, s2)
        want = _jax(name, n_workers=8).complete(s1, s2)
        single = _single(name).complete(s1, s2)
        if name == "auc":
            assert np.float32(got) == np.float32(want) and got == single
        else:
            assert abs(got - want) <= 1e-5 * abs(want)
            assert abs(got - single) <= 1e-12 * abs(single)

    @pytest.mark.parametrize("n_workers", [2, 3, 5, 7])
    def test_complete_any_worker_count(self, scores, n_workers):
        s1, s2 = scores
        got = Estimator("auc", backend="mesh", n_workers=n_workers,
                        device="cpu").complete(s1, s2)
        assert got == _single("auc").complete(s1, s2)
        want = _jax("auc", n_workers=n_workers).complete(s1, s2)
        assert np.float32(got) == np.float32(want)

    @pytest.mark.parametrize("name", ["auc", "hinge"])
    def test_complete_ragged_sizes(self, scores, mesh_est, name):
        """Sizes not divisible by 8: padding and masks in the ring (the
        masked kernel's route)."""
        s1, s2 = scores
        s1, s2 = s1[:1237], s2[:1011]
        got = Estimator(name, backend="mesh", n_workers=8,
                        device="cpu").complete(s1, s2)
        want = _jax(name, n_workers=8).complete(s1, s2)
        if name == "auc":
            assert np.float32(got) == np.float32(want)
            assert got == _single("auc").complete(s1, s2)
        else:
            assert abs(got - want) <= 1e-5 * abs(want)

    def test_one_sample_complete(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((300, 3)).astype(np.float32)
        got = Estimator("scatter", backend="mesh", n_workers=8,
                        device="cpu").complete(A)
        want = _jax("scatter", n_workers=8).complete(A)
        assert abs(got - want) / abs(want) < 1e-5
        single = _single("scatter").complete(A)
        assert abs(got - single) <= 1e-12 * abs(single)

    @pytest.mark.parametrize("name", ["triplet_indicator", "triplet_hinge"])
    def test_triplet_complete_double_ring(self, name):
        rng = np.random.default_rng(1)
        X = rng.standard_normal((48, 3)).astype(np.float32)
        Y = rng.standard_normal((40, 3)).astype(np.float32)
        got = Estimator(name, backend="mesh", n_workers=8,
                        device="cpu").complete(X, Y)
        want = JaxEstimator(name, backend="mesh", n_workers=8,
                            triplet_tile=8).complete(X, Y)
        single = _single(name).complete(X, Y)
        if name == "triplet_indicator":
            assert abs(got - want) < 1e-6 and got == single
        else:
            assert abs(got - want) <= 1e-5 * abs(want)
            assert abs(got - single) <= 1e-6 * abs(single)

    def test_impl_plain_equals_kernel_route_on_the_cpu(self, scores):
        s1, s2 = scores
        for name in ("auc", "hinge"):
            a = Estimator(name, backend="mesh", n_workers=8,
                          device="cpu").complete(s1[:999], s2)
            b = Estimator(name, backend="mesh", n_workers=8, device="cpu",
                          impl="plain").complete(s1[:999], s2)
            assert a == b


class TestDistributedSchemes:
    def test_local_average_unbiased(self, scores, mesh_est):
        s1, s2 = scores
        u_n = mesh_est.complete(s1, s2)
        vals = [mesh_est.local_average(s1, s2, seed=m) for m in range(40)]
        se = np.std(vals) / np.sqrt(len(vals))
        assert abs(np.mean(vals) - u_n) < 4 * se + 1e-4

    def test_repartitioned_runs_and_unbiased(self, scores, mesh_est):
        s1, s2 = scores
        u_n = mesh_est.complete(s1, s2)
        vals = [mesh_est.repartitioned(s1, s2, n_rounds=4, seed=m)
                for m in range(25)]
        se = np.std(vals) / np.sqrt(len(vals))
        assert abs(np.mean(vals) - u_n) < 4 * se + 1e-4

    @pytest.mark.parametrize("design", ["swr", "swor", "bernoulli"])
    def test_incomplete_unbiased(self, scores, mesh_est, design):
        s1, s2 = scores
        u_n = mesh_est.complete(s1, s2)
        vals = [mesh_est.incomplete(s1, s2, n_pairs=4000, seed=m,
                                    design=design) for m in range(60)]
        se = np.std(vals) / np.sqrt(len(vals))
        assert abs(np.mean(vals) - u_n) < 4 * se + 1e-4

    def test_local_round_equals_the_single_device_round(self, scores,
                                                        mesh_est):
        """The mesh's round is TorchBackend's round on the same blocks,
        dropped workers included (drop and renormalize)."""
        s1, s2 = scores
        for dropped in ((), (6,), (0, 3, 7)):
            got = mesh_est.local_average(s1, s2, seed=3,
                                         dropped_workers=dropped)
            g = generator(3, "local_average")
            i1 = draw_blocks(g, len(s1), 8)
            i2 = draw_blocks(g, len(s2), 8)
            want = float(TorchBackend("auc", device="cpu")
                         .local_round_from_blocks(s1, s2, i1, i2,
                                                  alive_mask(8, dropped)))
            assert abs(got - want) <= 1e-15

    def test_mismatched_workers_raises(self, scores, mesh_est):
        s1, s2 = scores
        with pytest.raises(ValueError, match="mesh backend has 8 shards"):
            mesh_est.local_average(s1, s2, n_workers=4)
        with pytest.raises(ValueError, match="conflicts with the mesh"):
            Estimator("auc", backend="mesh", device="cpu",
                      mesh=mesh_est.backend.mesh, n_workers=4)

    def test_one_sample_local_average_unbiased(self):
        """One-sample worker blocks reuse ONE partition (same ids both
        sides): an independent second draw would count self-pairs."""
        rng = np.random.default_rng(5)
        A = rng.standard_normal((320, 3)).astype(np.float32)
        est = Estimator("scatter", backend="mesh", n_workers=8,
                        device="cpu")
        u_n = est.complete(A)
        vals = [est.local_average(A, seed=m) for m in range(30)]
        se = np.std(vals) / np.sqrt(len(vals)) + 1e-6
        assert abs(np.mean(vals) - u_n) < 5 * se
        vals = [est.incomplete(A, n_pairs=2000, seed=m) for m in range(30)]
        se = np.std(vals) / np.sqrt(len(vals)) + 1e-6
        assert abs(np.mean(vals) - u_n) < 5 * se

    def test_local_average_ragged_n_unbiased(self):
        """n not divisible by N drops a RANDOM remainder each round, not
        a fixed tail: a planted extreme tail point participates."""
        X, Y = make_gaussians(1001, 993, dim=1, separation=1.0, seed=9)
        s1, s2 = X[:, 0].astype(np.float32), Y[:, 0].astype(np.float32)
        s1[-1] = 50.0
        est = Estimator("auc", backend="mesh", n_workers=8, device="cpu")
        u_n = _single("auc").complete(s1, s2)
        vals = [est.local_average(s1, s2, seed=m) for m in range(40)]
        se = np.std(vals) / np.sqrt(len(vals)) + 1e-6
        assert abs(np.mean(vals) - u_n) < 5 * se

    def test_small_n_raises_not_nan(self, mesh_est):
        with pytest.raises(ValueError, match="too small"):
            mesh_est.local_average(np.arange(5.0), np.arange(20.0), seed=0)

    def test_incomplete_small_n_raises(self, mesh_est):
        """swr packs each side into N shards first: n < N raises, as the
        JAX packing does."""
        with pytest.raises(ValueError, match="too small"):
            mesh_est.incomplete(np.arange(5.0), np.arange(20.0),
                                n_pairs=10, seed=0)

    def test_incomplete_rounds_budget_up(self, scores, mesh_est,
                                         monkeypatch):
        """n_pairs not divisible by N: every shard draws ceil(B / N) (one
        draw batched over the 8 workers), so at least B tuples in all."""
        s1, s2 = scores
        drawn = []
        real = pair_tiles.sample_pair_indices

        def spy(gen, n1, n2, n_pairs, one_sample, batch=()):
            drawn.append((n_pairs, batch))
            return real(gen, n1, n2, n_pairs, one_sample, batch)

        monkeypatch.setattr(pair_tiles, "sample_pair_indices", spy)
        v = mesh_est.incomplete(s1, s2, n_pairs=101, seed=0)
        assert 0.0 <= v <= 1.0
        assert drawn == [(13, (8,))] and 13 * 8 >= 101

    def test_triplet_schemes_unbiased(self):
        rng = np.random.default_rng(2)
        X = rng.standard_normal((96, 3)).astype(np.float32)
        Y = (rng.standard_normal((80, 3)) + 0.3).astype(np.float32)
        est = Estimator("triplet_indicator", backend="mesh", n_workers=8,
                        device="cpu")
        u_n = est.complete(X, Y)
        for scheme in ("local", "repartitioned", "swr", "swor"):
            vals = []
            for m in range(30):
                if scheme == "local":
                    vals.append(est.local_average(X, Y, seed=m))
                elif scheme == "repartitioned":
                    vals.append(est.repartitioned(X, Y, n_rounds=2, seed=m))
                else:
                    vals.append(est.incomplete(X, Y, n_pairs=3000, seed=m,
                                               design=scheme))
            se = np.std(vals) / np.sqrt(len(vals)) + 1e-6
            assert abs(np.mean(vals) - u_n) < 5 * se, scheme

    def test_designed_budget_above_the_bound_raises(self, mesh_est):
        with pytest.raises(ValueError):
            mesh_est.incomplete(np.arange(10.0), np.arange(10.0),
                                n_pairs=90, design="swor")


def test_mesh_backend_needs_a_device_or_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshBackend("auc", n_workers=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Estimator("auc", backend="mesh", n_workers=8)
    with pytest.raises(ValueError, match="impl"):
        MeshBackend("auc", n_workers=8, device="cpu", impl="xla")


def test_heal_retries_is_not_ported():
    """heal_retries was the unported option; it now arms a healer that
    keeps the mesh's width (tests/test_torch_preemption.py drives it)."""
    est = Estimator("auc", backend="mesh", n_workers=8, device="cpu",
                    heal_retries=2)
    assert est._healer.fixed_width == 8
    assert est._healer.mesh is est.backend.mesh


@pytest.mark.cuda
def test_mesh_backend_kernels_match_plain_on_card():
    """Every scheme on the card's worker axis against impl="plain" on
    the same inputs and draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    s1 = torch.randn(20003, generator=g, device="cuda") + 0.5
    s2 = torch.randn(16000, generator=g, device="cuda")
    for name in ("auc", "hinge", "logistic"):
        est = Estimator(name, backend="mesh", n_workers=8)
        plain = Estimator(name, backend="mesh", n_workers=8, impl="plain")
        for call in (lambda e: e.complete(s1, s2),
                     lambda e: e.complete(s1[:20000], s2),
                     lambda e: e.local_average(s1, s2, seed=1),
                     lambda e: e.repartitioned(s1, s2, n_rounds=2, seed=1),
                     lambda e: e.incomplete(s1, s2, n_pairs=5000, seed=1)):
            got, want = call(est), call(plain)
            if name == "auc":
                assert got == want
            else:
                assert abs(got - want) <= 1e-5 * abs(want)
