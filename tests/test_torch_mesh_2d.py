"""The port's 2-D (dcn, w) mesh on the CPU worker axis, case for case
with tests/test_mesh_2d.py: the (2, 4) double ring's complete statistic
equals the 1-D value and the single-device value (auc and the triplet
indicator exactly) and the JAX (2, 4) mesh's (auc to its float32
division, hinge within rel 1e-5, its float32 carry); every scheme stays
unbiased; axis names come from the mesh; a 3-D mesh is rejected.
"""

import jax
import numpy as np
import pytest

from tuplewise_tpu import Estimator as JaxEstimator
from tuplewise_tpu.data import make_gaussians
from tuplewise_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from tuplewise_tpu_torch import Estimator
from tuplewise_tpu_torch.parallel.comm import LocalComm
from tuplewise_tpu_torch.parallel.mesh import Mesh, make_mesh_2d

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


@pytest.fixture(scope="module")
def mesh2d():
    return make_mesh_2d(2, 4, device="cpu")


@pytest.fixture(scope="module")
def scores():
    X, Y = make_gaussians(1600, 1300, dim=1, separation=1.0, seed=21)
    return X[:, 0].astype(np.float32), Y[:, 0].astype(np.float32)


@pytest.fixture(scope="module")
def est2d(mesh2d):
    return Estimator("auc", backend="mesh", mesh=mesh2d, device="cpu")


def _jax2d(name, **kw):
    return JaxEstimator(name, backend="mesh", mesh=jax_make_mesh_2d(2, 4),
                        impl="xla", tile_a=64, tile_b=64, **kw)


class TestDoubleRingInvariance:
    @pytest.mark.parametrize("ragged", [False, True])
    def test_complete_matches_oracle(self, scores, est2d, ragged):
        s1, s2 = scores
        if ragged:
            s1, s2 = s1[:1237], s2[:1011]
        got = est2d.complete(s1, s2)
        assert got == Estimator("auc", device="cpu").complete(s1, s2)
        assert got == Estimator("auc", backend="mesh", n_workers=8,
                                device="cpu").complete(s1, s2)
        assert np.float32(got) == np.float32(_jax2d("auc").complete(s1, s2))

    def test_complete_hinge_matches_jax(self, scores, mesh2d):
        s1, s2 = scores
        s1, s2 = s1[:1237], s2[:1011]
        got = Estimator("hinge", backend="mesh", mesh=mesh2d,
                        device="cpu").complete(s1, s2)
        want = _jax2d("hinge").complete(s1, s2)
        assert abs(got - want) <= 1e-5 * abs(want)
        single = Estimator("hinge", device="cpu").complete(s1, s2)
        assert abs(got - single) <= 1e-12 * abs(single)

    def test_one_sample_complete(self, mesh2d):
        rng = np.random.default_rng(2)
        A = rng.standard_normal((300, 3)).astype(np.float32)
        got = Estimator("scatter", backend="mesh", mesh=mesh2d,
                        device="cpu").complete(A)
        want = _jax2d("scatter").complete(A)
        assert abs(got - want) / abs(want) < 1e-5

    def test_triplet_complete_hier_double_ring(self, mesh2d):
        rng = np.random.default_rng(1)
        X = rng.standard_normal((48, 3)).astype(np.float32)
        Y = rng.standard_normal((40, 3)).astype(np.float32)
        got = Estimator("triplet_indicator", backend="mesh", mesh=mesh2d,
                        device="cpu").complete(X, Y)
        assert got == Estimator("triplet_indicator",
                                device="cpu").complete(X, Y)
        want = JaxEstimator("triplet_indicator", backend="mesh",
                            mesh=jax_make_mesh_2d(2, 4),
                            triplet_tile=8).complete(X, Y)
        assert abs(got - want) < 1e-6

    def test_triplet_complete_hier_ragged(self, mesh2d):
        rng = np.random.default_rng(4)
        X = rng.standard_normal((37, 3)).astype(np.float32)
        Y = rng.standard_normal((29, 3)).astype(np.float32)
        got = Estimator("triplet_hinge", backend="mesh", mesh=mesh2d,
                        device="cpu").complete(X, Y)
        want = JaxEstimator("triplet_hinge", backend="mesh",
                            mesh=jax_make_mesh_2d(2, 4),
                            triplet_tile=8).complete(X, Y)
        assert abs(got - want) / max(abs(want), 1) < 1e-5


class TestSchemesOn2D:
    def test_local_average_unbiased(self, scores, est2d):
        s1, s2 = scores
        u_n = est2d.complete(s1, s2)
        vals = [est2d.local_average(s1, s2, seed=m) for m in range(30)]
        se = np.std(vals) / np.sqrt(len(vals)) + 1e-6
        assert abs(np.mean(vals) - u_n) < 5 * se

    def test_repartitioned_runs(self, scores, est2d):
        s1, s2 = scores
        v = est2d.repartitioned(s1, s2, n_rounds=3, seed=0)
        assert 0.0 < v < 1.0
        # the same draws as the 1-D worker axis of the same size
        flat = Estimator("auc", backend="mesh", n_workers=8, device="cpu")
        assert v == flat.repartitioned(s1, s2, n_rounds=3, seed=0)

    @pytest.mark.parametrize("design", ["swr", "bernoulli"])
    def test_incomplete_unbiased(self, scores, est2d, design):
        s1, s2 = scores
        u_n = est2d.complete(s1, s2)
        vals = [est2d.incomplete(s1, s2, n_pairs=4000, seed=m,
                                 design=design) for m in range(40)]
        se = np.std(vals) / np.sqrt(len(vals)) + 1e-6
        assert abs(np.mean(vals) - u_n) < 5 * se

    def test_dropped_workers(self, scores, est2d):
        s1, s2 = scores
        full = est2d.local_average(s1, s2, seed=0)
        drop = est2d.local_average(s1, s2, seed=0, dropped_workers=(6,))
        assert full != drop

    def test_n_workers_is_total_shards(self, est2d):
        assert est2d.n_workers == 8

    def test_arbitrary_axis_names(self, scores):
        """The backend takes the axis names from the mesh itself."""
        s1, s2 = scores
        mesh = Mesh((2, 4), ("hosts", "chips"), make_mesh_2d(
            2, 4, device="cpu").device, LocalComm((2, 4)))
        est = Estimator("auc", backend="mesh", mesh=mesh, device="cpu")
        assert est.complete(s1, s2) == Estimator(
            "auc", device="cpu").complete(s1, s2)

    def test_3d_mesh_rejected(self, mesh2d):
        mesh = Mesh((2, 2, 2), ("a", "b", "c"), mesh2d.device,
                    LocalComm((2, 2, 2)))
        with pytest.raises(ValueError, match="1-D or 2-D"):
            Estimator("auc", backend="mesh", mesh=mesh, device="cpu")

    def test_mesh_and_communicator_must_agree(self, mesh2d):
        with pytest.raises(ValueError, match="differ in length"):
            Mesh((2, 4), ("w",), mesh2d.device, LocalComm((2, 4)))
        with pytest.raises(ValueError, match="communicator"):
            Mesh((8,), ("w",), mesh2d.device, LocalComm((2, 4)))
