"""The port's degree-3 path end to end (Estimator(backend="torch") with the
triplet kernels, the MNIST-embedding loader and BASELINE config 4's
triplet_mnist_statistic) against the JAX package, on the CPU.

Tolerances: complete statistics see the same float32 inputs in both
packages and differ only by the rounding of the distance products and
the order of the sums: rel 1e-5. The loader is numpy in both packages
and must be equal bit for bit. Schemes that draw randomness use torch
generators in the port and jax keys in the reference, so they compare
statistically: within 4 standard errors, or within the spread a local
average has around the complete value.
"""

import gzip
import struct

import numpy as np
import pytest
import torch

from tuplewise_tpu import Estimator as JEstimator
from tuplewise_tpu.data import load_mnist_embeddings as j_load_mnist
from tuplewise_tpu.data import make_gaussians
from tuplewise_tpu.data.loaders import mnist_pca_embeddings as j_pca
from tuplewise_tpu.harness.triplet_experiment import (
    triplet_mnist_statistic as j_triplet_mnist,
)
from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops.pair_tiles import triplet_stats as j_triplet_stats
from tuplewise_tpu_torch import Estimator, triplet_mnist_statistic
from tuplewise_tpu_torch.data import load_mnist_embeddings, mnist_pca_embeddings
from tuplewise_tpu_torch.data.loaders import _read_idx
from tuplewise_tpu_torch.harness import triplet_experiment

NAMES = ("triplet_indicator", "triplet_hinge")


@pytest.fixture(scope="module")
def clouds():
    X, Y = make_gaussians(40, 32, 3, 1.0, seed=5)
    return X.astype(np.float32), Y.astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_complete_matches_jax_backends(clouds, name):
    X, Y = clouds
    got = Estimator(name, device="cpu").complete(X, Y)
    want_np = JEstimator(name, backend="numpy").complete(X, Y)
    want_jax = JEstimator(name, backend="jax", impl="pallas").complete(X, Y)
    for want in (want_np, want_jax):
        assert got == pytest.approx(want, rel=1e-5)
    # impl="plain" is the same plain version on the CPU
    assert Estimator(name, device="cpu", impl="plain").complete(X, Y) == got


@pytest.mark.parametrize("name", NAMES)
def test_local_round_from_blocks_matches_jax_with_global_ids(clouds, name):
    X, Y = clouds
    rng = np.random.default_rng(7)
    # swr blocks: a row may sit twice in a worker and must not pair with
    # itself (global ids); one worker padded with -1 and one dropped
    i1 = rng.integers(0, 40, (4, 9))
    i2 = rng.integers(0, 32, (4, 7))
    i1[0, 3] = i1[0, 5]
    i1[2, -2:] = -1
    alive = np.array([1.0, 1.0, 1.0, 0.0])
    be = Estimator(name, device="cpu").backend
    got = float(be.local_round_from_blocks(X, Y, i1, i2, alive=alive))
    vals = []
    for w in range(3):
        keep = i1[w] >= 0
        s, c = j_triplet_stats(jk.get_kernel(name), X[i1[w][keep]], Y[i2[w]],
                               ids_x=i1[w][keep], tile=8)
        vals.append(float(s) / float(c))
    assert got == pytest.approx(np.mean(vals), rel=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_schemes_agree_with_complete_statistically(clouds, name):
    X, Y = clouds
    est = Estimator(name, device="cpu", n_workers=4)
    full = est.complete(X, Y)
    loc = [est.local_average(X, Y, seed=s) for s in range(8)]
    rep = [est.repartitioned(X, Y, n_rounds=3, seed=s) for s in range(8)]
    swr = [est.local_average(X, Y, seed=s, scheme="swr") for s in range(8)]
    inc = [est.incomplete(X, Y, n_pairs=4000, seed=s) for s in range(8)]
    jinc = [JEstimator(name, backend="jax").incomplete(X, Y, n_pairs=4000,
                                                       seed=s)
            for s in range(8)]
    for vals in (loc, rep, swr, inc):
        se = np.std(vals, ddof=1) / np.sqrt(len(vals))
        # local averages are biased only through the id exclusion of
        # small blocks; all stay within 4 se (plus 5 % slack) of complete
        assert abs(np.mean(vals) - full) < 4 * se + 0.05 * abs(full), vals
    se = np.sqrt(np.var(inc, ddof=1) / 8 + np.var(jinc, ddof=1) / 8)
    assert abs(np.mean(inc) - np.mean(jinc)) < 4 * se
    assert len(set(loc)) > 1 and est.local_average(X, Y, seed=3) == loc[3]


def test_estimator_errors_and_no_card(clouds, monkeypatch):
    X, Y = clouds
    est = Estimator("triplet_hinge", device="cpu")
    with pytest.raises(ValueError, match="anchors and positives"):
        est.complete(X[:, 0], Y[:, 0])
    with pytest.raises(ValueError, match="two-sample"):
        est.complete(X)
    with pytest.raises(ValueError, match="distinct"):
        est.incomplete(X[:3], Y[:3], n_pairs=15, design="swor")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Estimator("triplet_indicator")
    with pytest.raises(RuntimeError, match="CUDA"):
        triplet_mnist_statistic(n=50)


def _write_idx(dirpath, n=30, side=28, gz=False):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(n, side, side), dtype=np.uint8)
    labels = (np.arange(n) % 10).astype(np.uint8)
    suffix = ".gz" if gz else ""
    op = gzip.open if gz else open
    with op(dirpath / f"train-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">HBBIII", 0, 0x08, 3, n, side, side))
        f.write(images.tobytes())
    with op(dirpath / f"train-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">HBBI", 0, 0x08, 1, n))
        f.write(labels.tobytes())
    return images, labels


class TestLoader:
    def test_surrogate_equals_jax_bit_for_bit(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TUPLEWISE_DATA_DIR", str(tmp_path / "empty"))
        for kw in (dict(n=500, seed=0), dict(n=97, dim=8, seed=3)):
            E, lab, meta = load_mnist_embeddings(**kw)
            Ej, labj, metaj = j_load_mnist(**kw)
            assert E.tobytes() == Ej.tobytes() and E.dtype == Ej.dtype
            assert np.array_equal(lab, labj) and meta == metaj
            assert meta["synthetic"] is True

    @pytest.mark.parametrize("gz", [False, True])
    def test_idx_pair_parsed_equal(self, tmp_path, monkeypatch, gz):
        images, labels = _write_idx(tmp_path, n=40, gz=gz)
        monkeypatch.setenv("TUPLEWISE_DATA_DIR", str(tmp_path))
        E, lab, meta = load_mnist_embeddings(n=30, dim=8, seed=0)
        Ej, labj, metaj = j_load_mnist(n=30, dim=8, seed=0)
        assert meta["synthetic"] is False and meta == metaj
        assert E.tobytes() == Ej.tobytes() and np.array_equal(lab, labj)
        suffix = ".gz" if gz else ""
        got = _read_idx(str(tmp_path / f"train-images-idx3-ubyte{suffix}"))
        assert np.array_equal(got, images)
        assert np.array_equal(mnist_pca_embeddings(images, 8),
                              j_pca(images, 8))

    def test_npz_and_bad_files(self, tmp_path):
        rng = np.random.default_rng(2)
        p = tmp_path / "emb.npz"
        np.savez(p, E=rng.normal(size=(50, 4)), labels=np.arange(50) % 10)
        E, lab, meta = load_mnist_embeddings(path=str(p), n=20, seed=1)
        Ej, labj, _ = j_load_mnist(path=str(p), n=20, seed=1)
        assert np.array_equal(E, Ej) and np.array_equal(lab, labj)
        assert meta == {"synthetic": False, "source": str(p)}
        bad = tmp_path / "train-images-idx3-ubyte"
        bad.write_bytes(b"\x00\x00")
        with pytest.raises(ValueError, match="IDX"):
            _read_idx(str(bad))
        bad.write_bytes(b"\x12\x34\x56\x78" + b"\x00" * 16)
        with pytest.raises(ValueError, match="IDX"):
            _read_idx(str(bad))


class TestTripletMnistStatistic:
    @pytest.mark.parametrize("name", NAMES)
    def test_complete_matches_jax_per_class(self, tmp_path, monkeypatch,
                                            name):
        monkeypatch.setenv("TUPLEWISE_DATA_DIR", str(tmp_path / "empty"))
        kw = dict(kernel=name, n=150, n_pairs=None, classes=[0, 3, 7])
        got = triplet_mnist_statistic(device="cpu", **kw)
        want = j_triplet_mnist(backend="numpy", **kw)
        assert sorted(got["per_class"]) == sorted(want["per_class"]) == [0, 3,
                                                                          7]
        for c, v in want["per_class"].items():
            assert got["per_class"][c] == pytest.approx(v, rel=1e-5)
        assert got["data_meta"] == want["data_meta"]
        assert got["backend"] == "torch" and got["recovery"] == {
            "resumed_from": 0}

    def test_incomplete_runs_and_resume_equals_straight(self, tmp_path,
                                                        monkeypatch):
        monkeypatch.setenv("TUPLEWISE_DATA_DIR", str(tmp_path / "empty"))
        kw = dict(n=200, n_pairs=3000, seed=4, device="cpu")
        straight = triplet_mnist_statistic(**kw)
        assert len(straight["per_class"]) == 10
        assert all(0.9 <= v <= 1.0 for v in straight["per_class"].values())
        # cut the sweep after its third class, then resume
        path = str(tmp_path / "ck.npz")
        calls = {"n": 0}
        real = triplet_experiment.Estimator.incomplete

        def dies_on_the_fourth(self, *a, **k):
            calls["n"] += 1
            if calls["n"] == 4:
                raise RuntimeError("preempted")
            return real(self, *a, **k)

        monkeypatch.setattr(triplet_experiment.Estimator, "incomplete",
                            dies_on_the_fourth)
        with pytest.raises(RuntimeError, match="preempted"):
            triplet_mnist_statistic(checkpoint_path=path, **kw)
        monkeypatch.setattr(triplet_experiment.Estimator, "incomplete", real)
        resumed = triplet_mnist_statistic(checkpoint_path=path, **kw)
        assert resumed["recovery"] == {"resumed_from": 3}
        assert resumed["per_class"] == straight["per_class"]
        with pytest.raises(ValueError, match="config mismatch"):
            triplet_mnist_statistic(checkpoint_path=path,
                                    **dict(kw, n_pairs=100))
