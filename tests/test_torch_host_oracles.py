"""The port's host oracles, ``backend="numpy"`` (``backends/
numpy_backend.py``) and ``backend="cpp"`` (``backends/cpp_backend.py``
with ``native/pair_sum.cpp``), against the JAX package's.

Both packages draw partitions and tuple designs from the same numpy
streams and evaluate the built-in kernels with the same float64 numpy
(or C++) operations, so every scheme's value equals the JAX backend's of
the same name exactly: counts and sums alike. The cpp backend equals the
numpy one within the reference's own tolerance (rel 1e-12: the C++ folds
rows in another order), and the complete statistics equal the port's
``torch`` backend on the CPU (float32 inputs: exact for the AUC, rel 1e-5
for the float sums). Mirrors tests/test_numpy_estimators.py and
tests/test_cpp_backend.py of the JAX package."""

import numpy as np
import pytest
import torch

from tuplewise_tpu import Estimator as JaxEstimator
from tuplewise_tpu.ops.kernels import Kernel as JaxKernel
from tuplewise_tpu_torch import Estimator
from tuplewise_tpu_torch.data import make_gaussians, true_gaussian_auc
from tuplewise_tpu_torch.estimators.variance import (
    incomplete_variance, two_sample_variance,
)
from tuplewise_tpu_torch.models.metrics import auc_score
from tuplewise_tpu_torch.native import load_pair_lib
from tuplewise_tpu_torch.ops.kernels import Kernel

DIFF = ("auc", "hinge", "logistic")
TRIPLET = ("triplet_indicator", "triplet_hinge")


@pytest.fixture(scope="module")
def scores():
    X, Y = make_gaussians(400, 300, dim=1, separation=1.0, seed=7)
    return X[:, 0], Y[:, 0]


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(11)
    return rng.standard_normal((40, 4)), rng.standard_normal((36, 4)) + 0.3


def brute_force_auc(s1, s2):
    total = 0.0
    for a in s1:
        for b in s2:
            total += float(a > b) + 0.5 * float(a == b)
    return total / (len(s1) * len(s2))


def _schemes(est, A, B):
    """Every scheme of one estimator on (A, B) (B None: one-sample)."""
    return [est.complete(A, B),
            est.local_average(A, B, seed=3),
            est.local_average(A, B, seed=4, scheme="swr"),
            est.repartitioned(A, B, n_rounds=3, seed=1),
            est.local_average(A, B, seed=5, dropped_workers=(1,)),
            est.incomplete(A, B, n_pairs=700, seed=2),
            est.incomplete(A, B, n_pairs=300, seed=2, design="swor"),
            est.incomplete(A, B, n_pairs=300, seed=6, design="bernoulli")]


# --------------------------------------------------------------------- #
# parity with the JAX package                                            #
# --------------------------------------------------------------------- #

class TestParity:
    @pytest.mark.parametrize("backend", ["numpy", "cpp"])
    @pytest.mark.parametrize("kern", DIFF)
    def test_diff_kernels_equal_the_jax_backend(self, scores, backend,
                                                kern):
        s1, s2 = scores
        ours = Estimator(kern, backend=backend, n_workers=4, block_size=128)
        theirs = JaxEstimator(kern, backend=backend, n_workers=4,
                              block_size=128)
        assert _schemes(ours, s1, s2) == _schemes(theirs, s1, s2)

    @pytest.mark.parametrize("backend", ["numpy", "cpp"])
    @pytest.mark.parametrize("kern", TRIPLET)
    def test_triplet_kernels_equal_the_jax_backend(self, feats, backend,
                                                   kern):
        X, Y = feats
        ours = Estimator(kern, backend=backend, n_workers=3)
        theirs = JaxEstimator(kern, backend=backend, n_workers=3)
        assert _schemes(ours, X, Y) == _schemes(theirs, X, Y)

    @pytest.mark.parametrize("backend", ["numpy", "cpp"])
    def test_scatter_equals_the_jax_backend(self, backend):
        A = np.random.default_rng(12).standard_normal((90, 3))
        ours = Estimator("scatter", backend=backend, n_workers=3,
                         block_size=32)
        theirs = JaxEstimator("scatter", backend=backend, n_workers=3,
                              block_size=32)
        assert _schemes(ours, A, None) == _schemes(theirs, A, None)

    def test_counts_equal_the_jax_backend(self, scores):
        from tuplewise_tpu.backends.numpy_backend import (
            NumpyBackend as JaxNumpy,
        )
        from tuplewise_tpu_torch.backends.numpy_backend import NumpyBackend

        s1, s2 = scores
        ids = np.arange(len(s1)) % 17
        for kern in DIFF:
            ours = NumpyBackend(kern, block_size=50)._pair_stats(
                s1, s1, ids, ids)
            theirs = JaxNumpy(kern, block_size=50)._pair_stats(
                s1, s1, ids, ids)
            assert ours == theirs and isinstance(ours[1], int)

    @pytest.mark.parametrize("kern", DIFF + ("scatter",) + TRIPLET)
    def test_complete_equals_the_torch_backend_on_cpu(self, scores, feats,
                                                      kern):
        if kern in DIFF:
            A, B = scores
        elif kern == "scatter":
            A, B = feats[0], None
        else:
            A, B = feats
        A32 = np.asarray(A, dtype=np.float32)
        B32 = None if B is None else np.asarray(B, dtype=np.float32)
        host = Estimator(kern, backend="numpy").complete(A32, B32)
        dev = Estimator(kern, device="cpu").complete(A32, B32)
        if kern in ("auc", "triplet_indicator"):
            assert host == dev
        else:
            assert host == pytest.approx(dev, rel=1e-5)

    def test_tensors_and_lists_are_host_copies(self, scores):
        s1, s2 = scores
        est = Estimator("auc", backend="numpy")
        want = est.complete(s1, s2)
        assert est.complete(torch.from_numpy(s1), list(s2)) == want
        assert est.complete(s1[:, None], s2[:, None]) == want


# --------------------------------------------------------------------- #
# the numpy oracle's semantics                                           #
# --------------------------------------------------------------------- #

class TestComplete:
    def test_matches_brute_force(self, scores):
        s1, s2 = scores
        est = Estimator("auc", backend="numpy", block_size=64)
        np.testing.assert_allclose(
            est.complete(s1[:50], s2[:40]), brute_force_auc(s1[:50], s2[:40])
        )

    def test_matches_rank_auc(self, scores):
        s1, s2 = scores
        est = Estimator("auc", backend="numpy", block_size=128)
        np.testing.assert_allclose(
            est.complete(s1, s2), auc_score(s1, s2), atol=1e-12
        )

    def test_close_to_population_auc(self):
        X, Y = make_gaussians(4000, 4000, separation=1.0, seed=3)
        est = Estimator("auc", backend="numpy")
        auc = est.complete(X[:, 0], Y[:, 0])
        assert abs(auc - true_gaussian_auc(1.0)) < 0.02

    def test_one_sample_scatter_brute_force(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((30, 2))
        est = Estimator("scatter", backend="numpy", block_size=7)
        n = len(A)
        total = sum(0.5 * np.sum((A[i] - A[j]) ** 2)
                    for i in range(n) for j in range(n) if i != j)
        np.testing.assert_allclose(est.complete(A), total / (n * (n - 1)))

    def test_triplet_complete_brute_force(self):
        rng = np.random.default_rng(1)
        X = rng.standard_normal((12, 3))
        Y = rng.standard_normal((9, 3))
        est = Estimator("triplet_indicator", backend="numpy")
        total = 0.0
        for i in range(12):
            for j in range(12):
                if i == j:
                    continue
                for k in range(9):
                    dp = np.sum((X[i] - X[j]) ** 2)
                    dn = np.sum((X[i] - Y[k]) ** 2)
                    total += float(dn > dp)
        np.testing.assert_allclose(
            est.complete(X, Y), total / (12 * 11 * 9)
        )


class TestLocalAverage:
    def test_unbiased_over_partitions(self, scores):
        """Over swor partitions the local average has mean U_n: every
        pair is equally likely to land on one worker."""
        s1, s2 = scores
        s1, s2 = s1[:200], s2[:200]
        est = Estimator("auc", backend="numpy", n_workers=4)
        u_n = est.complete(s1, s2)
        vals = [est.local_average(s1, s2, seed=m) for m in range(200)]
        se = np.std(vals) / np.sqrt(len(vals))
        assert abs(np.mean(vals) - u_n) < 4 * se + 1e-6

    def test_higher_variance_than_complete(self):
        X, Y = make_gaussians(240, 240, separation=1.0, seed=11)
        s1, s2 = X[:, 0], Y[:, 0]
        est = Estimator("auc", backend="numpy", n_workers=8)
        vals = [est.local_average(s1, s2, seed=m) for m in range(150)]
        assert np.std(vals) > 1e-3


class TestRepartitioned:
    def test_variance_decays_like_one_over_T(self):
        """Rounds are i.i.d. given the data: Var(U_{N,T} | data) =
        Var(U_{N,1} | data) / T."""
        M = 200
        X, Y = make_gaussians(160, 160, separation=1.0, seed=21)
        s1, s2 = X[:, 0], Y[:, 0]
        est = Estimator("auc", backend="numpy", n_workers=8)
        var_by_T = {}
        for T in (1, 8):
            vals = [est.repartitioned(s1, s2, n_rounds=T, seed=3000 + m)
                    for m in range(M)]
            var_by_T[T] = np.var(vals)
        assert 4.0 < var_by_T[1] / var_by_T[8] < 16.0

    def test_swr_scheme_runs(self, scores):
        s1, s2 = scores
        est = Estimator("auc", backend="numpy", n_workers=4)
        v = est.repartitioned(s1, s2, n_rounds=3, seed=0, scheme="swr")
        assert 0.0 <= v <= 1.0

    def test_one_sample_swr_unbiased(self):
        """With-replacement blocks can hold one point twice; such pairs
        are excluded by original index, else E[U^loc] = (1-1/n) U_n."""
        rng = np.random.default_rng(3)
        A = rng.standard_normal((40, 2))
        est = Estimator("scatter", backend="numpy", n_workers=4)
        u_n = est.complete(A)
        vals = [est.local_average(A, seed=m, scheme="swr")
                for m in range(1500)]
        se = np.std(vals) / np.sqrt(len(vals))
        assert se < u_n / len(A) / 4  # the test can see the bias
        assert abs(np.mean(vals) - u_n) < 4 * se


class TestIncomplete:
    def test_unbiased(self, scores):
        s1, s2 = scores
        est = Estimator("auc", backend="numpy")
        u_n = est.complete(s1, s2)
        vals = [est.incomplete(s1, s2, n_pairs=500, seed=m)
                for m in range(300)]
        se = np.std(vals) / np.sqrt(len(vals))
        assert abs(np.mean(vals) - u_n) < 4 * se + 1e-6

    def test_variance_matches_formula(self, scores):
        """Given the data, the sampling variance is Var_pairs(h) / B."""
        s1, s2 = scores
        est = Estimator("auc", backend="numpy")
        B = 200
        vals = [est.incomplete(s1, s2, n_pairs=B, seed=m)
                for m in range(600)]
        pred = (incomplete_variance("auc", s1, s2, n_pairs=B)
                - two_sample_variance("auc", s1, s2))
        assert abs(np.var(vals) - pred) / pred < 0.25

    def test_one_sample_incomplete(self):
        A = np.random.default_rng(5).standard_normal((300, 3))
        est = Estimator("scatter", backend="numpy")
        u = est.complete(A)
        vals = [est.incomplete(A, n_pairs=400, seed=m) for m in range(200)]
        se = np.std(vals) / np.sqrt(len(vals))
        assert abs(np.mean(vals) - u) < 4 * se + 1e-6

    def test_triplet_incomplete_unbiased(self):
        rng = np.random.default_rng(6)
        X = rng.standard_normal((40, 3))
        Y = rng.standard_normal((30, 3))
        est = Estimator("triplet_indicator", backend="numpy")
        u = est.complete(X, Y)
        vals = [est.incomplete(X, Y, n_pairs=300, seed=m)
                for m in range(200)]
        se = np.std(vals) / np.sqrt(len(vals))
        assert abs(np.mean(vals) - u) < 4 * se + 1e-6


class TestValidation:
    def test_two_sample_requires_B(self):
        with pytest.raises(ValueError, match="two-sample"):
            Estimator("auc", backend="numpy").complete(np.zeros(3))

    def test_diff_kernel_rejects_features(self):
        with pytest.raises(ValueError, match="scalar scores"):
            Estimator("auc", backend="numpy").complete(
                np.zeros((3, 2)), np.zeros((3, 2)))

    def test_default_backend_is_torch(self):
        # a known divergence (ROADMAP.md Queue 3): the JAX Estimator's
        # default is its numpy oracle
        assert JaxEstimator("auc").backend_name == "numpy"
        assert Estimator("auc", device="cpu").backend_name == "torch"
        with pytest.raises(KeyError, match="numpy"):
            Estimator("auc", backend="nope")


# --------------------------------------------------------------------- #
# the C++ pair loop                                                      #
# --------------------------------------------------------------------- #

class TestCpp:
    def test_builds_into_the_package(self):
        lib = load_pair_lib()
        assert lib is not None and lib.native_num_threads() >= 1
        import tuplewise_tpu_torch.native as native

        built = [f for f in __import__("os").listdir(native._BUILD_DIR)
                 if f.startswith("pair_sum_") and f.endswith(".so")]
        assert built
        with open(native._SRC) as f, open(native._SRC.replace(
                "tuplewise_tpu_torch", "tuplewise_tpu")) as g:
            assert f.read() == g.read()    # a copy of the reference's

    def test_raises_without_the_library(self, monkeypatch):
        import tuplewise_tpu_torch.native as native

        monkeypatch.setattr(native, "load_pair_lib", lambda: None)
        with pytest.raises(RuntimeError, match="native pair library"):
            Estimator("auc", backend="cpp")

    @pytest.mark.parametrize("kern", DIFF)
    def test_complete_equals_numpy(self, scores, kern):
        s1, s2 = scores
        ref = Estimator(kern, backend="numpy").complete(s1, s2)
        got = Estimator(kern, backend="cpp").complete(s1, s2)
        assert got == pytest.approx(ref, rel=1e-12)

    def test_local_and_repartitioned_same_partitions(self, scores):
        s1, s2 = scores
        ref = Estimator("auc", backend="numpy", n_workers=4)
        got = Estimator("auc", backend="cpp", n_workers=4)
        for seed in range(3):
            assert got.local_average(s1, s2, seed=seed) == pytest.approx(
                ref.local_average(s1, s2, seed=seed), rel=1e-12)
        assert got.repartitioned(s1, s2, n_rounds=3, seed=1) == \
            pytest.approx(ref.repartitioned(s1, s2, n_rounds=3, seed=1),
                          rel=1e-12)

    def test_scatter_swr_duplicate_ids(self):
        A = np.random.default_rng(8).standard_normal((320, 3))
        ref = Estimator("scatter", backend="numpy", n_workers=4)
        got = Estimator("scatter", backend="cpp", n_workers=4)
        assert got.complete(A) == pytest.approx(ref.complete(A), rel=1e-12)
        assert got.local_average(A, seed=0, scheme="swr") == pytest.approx(
            ref.local_average(A, seed=0, scheme="swr"), rel=1e-12)

    @pytest.mark.parametrize("kern", TRIPLET)
    def test_triplet_equals_numpy(self, feats, kern):
        X, Y = feats
        ref = Estimator(kern, backend="numpy", n_workers=4)
        got = Estimator(kern, backend="cpp", n_workers=4)
        assert got.complete(X, Y) == pytest.approx(ref.complete(X, Y),
                                                   rel=1e-12)
        for seed in range(2):
            assert got.local_average(X, Y, seed=seed) == pytest.approx(
                ref.local_average(X, Y, seed=seed), rel=1e-12)

    def test_custom_kernel_falls_back(self):
        """A user kernel has no C++ or numpy body: both host backends run
        its torch body on the host, equal to the JAX oracle's numpy
        body."""
        k = Kernel(name="abs_diff", degree=2, two_sample=True, kind="diff",
                   diff_fn=lambda d: d.abs())
        jk = JaxKernel(name="abs_diff", degree=2, two_sample=True,
                       kind="diff", diff_fn=lambda d, xp: xp.abs(d))
        rng = np.random.default_rng(10)
        a, b = rng.standard_normal(200), rng.standard_normal(150)
        want = JaxEstimator(jk, backend="numpy").complete(a, b)
        for backend in ("numpy", "cpp"):
            got = Estimator(k, backend=backend).complete(a, b)
            assert got == pytest.approx(want, rel=1e-12)
