"""The port's triplet learner (models.triplet_sgd, the embedders of
models.scorers) against the JAX package, on the CPU.

Tolerances: one step on given blocks and triplet indices sees the same
float32 data in both packages, so the new parameters agree within rel
1e-5 (float32 sums in different orders). The held-out triplet accuracy
is the indicator statistic on embedded data: the JAX package embeds in
float64 numpy, the port in float32, which can flip near-tied triplets,
so accuracies agree within 1e-3 absolute (about 100 of the 124800 test
triplets). Training runs draw blocks and triplets from torch generators
in the port and jax keys in the reference, so the mirrored cases of
tests/test_triplet_sgd.py hold the port to the reference's own
thresholds, and runs of the port itself (chunked, resumed) must equal
each other bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.data import make_gaussians
from tuplewise_tpu.models import scorers as JS
from tuplewise_tpu.models import triplet_sgd as J
from tuplewise_tpu.ops.kernels import get_kernel as j_kernel
from tuplewise_tpu.utils.checkpoint import load_checkpoint
from tuplewise_tpu_torch.models import scorers as TS
from tuplewise_tpu_torch.models import triplet_sgd as T
from tuplewise_tpu_torch.ops.kernels import get_kernel
from tuplewise_tpu_torch.utils.state import params_to_state, state_to_params


@pytest.fixture(scope="module")
def rotated_clouds():
    X, Y = make_gaussians(160, 320, dim=8, separation=1.2, seed=0)
    q, _ = np.linalg.qr(np.random.default_rng(123).standard_normal((8, 8)))
    X, Y = (X @ q).astype(np.float32), (Y @ q).astype(np.float32)
    return X[:120], Y[:240], X[120:], Y[240:]


def _radial(seed, n=400):
    rng = np.random.default_rng(seed)

    def shell(m, r_lo, r_hi):
        v = rng.standard_normal((m, 8))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        r = rng.uniform(r_lo, r_hi, size=(m, 1))
        return (v * r).astype(np.float32)

    X, Y = shell(n, 0.5, 1.0), shell(2 * n, 1.8, 2.6)
    return X[:300], Y[:600], X[300:], Y[600:]


def _port_cfg(cfg):
    return T.TripletTrainConfig(**dataclasses.asdict(cfg))


def _train(*a, **kw):
    return T.train_triplet(*a, device="cpu", **kw)


def _equal(p, q):
    assert p.keys() == q.keys()
    for k in p:
        assert p[k].tobytes() == q[k].tobytes(), k


EMBEDDERS = [
    lambda m: m.LinearEmbed(dim=6, embed_dim=3),
    lambda m: m.MLPEmbed(dim=6, hidden=7, embed_dim=2),
]


class TestEmbedders:
    @pytest.mark.parametrize("make", EMBEDDERS)
    def test_init_forward_repr_match_jax(self, make):
        j, t = make(JS), make(TS)
        assert repr(t) == repr(j)
        for seed in (0, 4):
            jp, tp = j.init(seed), t.init(seed)
            assert jp.keys() == tp.keys()
            for k in jp:
                np.testing.assert_array_equal(jp[k], tp[k])
        t.load_state_dict(params_to_state(j.init(4)))
        X = np.random.default_rng(1).standard_normal((30, 6)).astype(np.float32)
        want = np.asarray(j.apply(
            {k: jnp.asarray(v, jnp.float32) for k, v in j.init(4).items()},
            jnp.asarray(X), jnp))
        got = t(torch.from_numpy(X)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        back = state_to_params(t.state_dict())
        for k, v in j.init(4).items():
            np.testing.assert_array_equal(back[k], v.astype(np.float32))

    def test_default_embedder_and_init_embed(self):
        p = T.init_embed(5, 3, seed=2)
        np.testing.assert_array_equal(p["W"], J.init_embed(5, 3, seed=2)["W"])
        assert repr(T.default_embedder(p)) == "LinearEmbed(dim=5, embed_dim=3)"
        with pytest.raises(ValueError, match="embedder"):
            T.default_embedder(TS.MLPEmbed(dim=5).init(0))


class TestStep:
    @pytest.mark.parametrize("make", [
        lambda m: m.LinearEmbed(dim=8, embed_dim=2),
        lambda m: m.MLPEmbed(dim=8, hidden=16, embed_dim=2),
    ])
    def test_four_worker_step_matches_jax_grad(self, rotated_clouds, make):
        Xc, Xo, _, _ = rotated_clouds
        rng = np.random.default_rng(6)
        A = Xc[rng.permutation(120)[:4 * 30]].reshape(4, 30, 8)
        B = Xo[rng.permutation(240)[:4 * 60]].reshape(4, 60, 8)
        i = rng.integers(0, 30, (4, 64))
        j = (i + rng.integers(1, 30, (4, 64))) % 30
        k = rng.integers(0, 60, (4, 64))
        je, te = make(JS), make(TS)
        p0 = {n: np.asarray(v, np.float32) for n, v in je.init(3).items()}
        jk = j_kernel("triplet_hinge")

        def loss(p):
            vals = []
            for w in range(4):
                ea = je.apply(p, jnp.asarray(A[w]), jnp)
                eb = je.apply(p, jnp.asarray(B[w]), jnp)
                vals.append(jnp.mean(jk.triplet_values(
                    ea[i[w]], ea[j[w]], eb[k[w]], jnp)))
            return jnp.mean(jnp.stack(vals))

        pj = {n: jnp.asarray(v) for n, v in p0.items()}
        want_loss, g = jax.value_and_grad(loss)(pj)
        cfg = T.TripletTrainConfig(lr=0.3, n_workers=4)
        new, got_loss = T.sgd_step(
            te, get_kernel("triplet_hinge"), cfg, params_to_state(p0),
            torch.from_numpy(A), torch.from_numpy(B),
            tuple(torch.from_numpy(a) for a in (i, j, k)))
        assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
        for n in p0:
            np.testing.assert_allclose(new[n].numpy(),
                                       np.asarray(pj[n] - 0.3 * g[n]),
                                       rtol=1e-5, atol=1e-6)

    def test_sampled_triplets_keep_i_and_j_apart(self):
        cfg = T.TripletTrainConfig(n_workers=3, triplets_per_worker=500)
        i, j, k = T.sample_triplets(cfg, 7, 4, 5, "cpu")
        assert i.shape == j.shape == k.shape == (3, 500)
        assert bool((i != j).all()) and int(k.max()) == 4
        again = T.sample_triplets(cfg, 7, 4, 5, "cpu")
        assert all(bool((a == b).all()) for a, b in zip((i, j, k), again))


class TestTripletSGD:
    """The cases of tests/test_triplet_sgd.py, on the port (CPU)."""

    def test_learns_through_bottleneck(self, rotated_clouds):
        Xc_tr, Xo_tr, Xc_te, Xo_te = rotated_clouds
        p0 = T.init_embed(8, 2, seed=1)
        a0 = T.evaluate_triplet_accuracy(p0, Xc_te, Xo_te, device="cpu")
        cfg = T.TripletTrainConfig(
            lr=0.1, steps=120, n_workers=4, repartition_every=10,
            triplets_per_worker=1024, seed=0, embed_dim=2)
        p1, hist = _train(p0, Xc_tr, Xo_tr, cfg)
        a1 = T.evaluate_triplet_accuracy(p1, Xc_te, Xo_te, device="cpu")
        assert a1 > a0 + 0.05, (a0, a1)
        assert hist["loss"][-1] < hist["loss"][0]
        assert p1["W"].dtype == np.float32 and hist["loss"].shape == (120,)

    def test_accuracy_matches_jax(self, rotated_clouds):
        _, _, Xc_te, Xo_te = rotated_clouds
        for p in (T.init_embed(8, 2, seed=1), T.init_embed(8, 3, seed=5)):
            got = T.evaluate_triplet_accuracy(p, Xc_te, Xo_te, device="cpu")
            want = J.evaluate_triplet_accuracy(p, Xc_te, Xo_te)
            assert abs(got - want) < 1e-3, (got, want)
        inc = T.evaluate_triplet_accuracy(p, Xc_te, Xo_te, n_triplets=20000,
                                          device="cpu")
        assert abs(inc - got) < 0.02

    def test_curve_chunking_matches_straight_run(self, rotated_clouds):
        Xc_tr, Xo_tr, Xc_te, Xo_te = rotated_clouds
        p0 = T.init_embed(8, 2, seed=2)
        cfg = T.TripletTrainConfig(
            lr=0.1, steps=40, n_workers=4, repartition_every=8,
            triplets_per_worker=256, seed=3, embed_dim=2)
        p_straight, h_straight = _train(p0, Xc_tr, Xo_tr, cfg)
        p_chunked, hist = _train(p0, Xc_tr, Xo_tr, cfg, eval_every=10,
                                 eval_data=(Xc_te, Xo_te))
        _equal(p_chunked, p_straight)
        assert hist["loss"].tobytes() == h_straight["loss"].tobytes()
        assert len(hist["test_acc"]) == 4
        assert list(hist["eval_steps"]) == [10, 20, 30, 40]

    def test_checkpoint_resume_exact(self, rotated_clouds, tmp_path):
        Xc_tr, Xo_tr, _, _ = rotated_clouds
        p0 = T.init_embed(8, 2, seed=4)
        cfg = T.TripletTrainConfig(
            lr=0.1, steps=30, n_workers=4, repartition_every=8,
            triplets_per_worker=256, seed=5, embed_dim=2)
        p_straight, h_straight = _train(p0, Xc_tr, Xo_tr, cfg)
        ckpt = str(tmp_path / "triplet.npz")
        _train(p0, Xc_tr, Xo_tr, dataclasses.replace(cfg, steps=10),
               checkpoint_path=ckpt)
        p_resumed, h_resumed = _train(p0, Xc_tr, Xo_tr, cfg,
                                      checkpoint_path=ckpt)
        _equal(p_resumed, p_straight)
        assert h_resumed["loss"].tobytes() == h_straight["loss"].tobytes()
        with pytest.raises(ValueError, match="config mismatch"):
            _train(p0, Xc_tr, Xo_tr, dataclasses.replace(cfg, lr=0.2),
                   checkpoint_path=ckpt)
        with pytest.raises(ValueError, match="past the requested"):
            _train(p0, Xc_tr, Xo_tr, dataclasses.replace(cfg, steps=20),
                   checkpoint_path=ckpt)

    def test_resume_preserves_eval_curve(self, rotated_clouds, tmp_path):
        Xc_tr, Xo_tr, Xc_te, Xo_te = rotated_clouds
        p0 = T.init_embed(8, 2, seed=6)
        cfg = T.TripletTrainConfig(
            lr=0.1, steps=30, n_workers=4, repartition_every=8,
            triplets_per_worker=256, seed=8, embed_dim=2)
        kw = dict(eval_every=10, eval_data=(Xc_te, Xo_te))
        _, h_straight = _train(p0, Xc_tr, Xo_tr, cfg, **kw)
        ckpt = str(tmp_path / "curve.npz")
        _train(p0, Xc_tr, Xo_tr, dataclasses.replace(cfg, steps=10),
               checkpoint_path=ckpt, **kw)
        _, h_resumed = _train(p0, Xc_tr, Xo_tr, cfg, checkpoint_path=ckpt,
                              **kw)
        np.testing.assert_array_equal(h_resumed["eval_steps"],
                                      h_straight["eval_steps"])
        assert h_resumed["test_acc"].tobytes() == \
            h_straight["test_acc"].tobytes()

    def test_rejects_indicator_wrong_kind_and_designs(self):
        def run(**kw):
            return _train(T.init_embed(4, 2), np.zeros((8, 4), np.float32),
                          np.zeros((8, 4), np.float32),
                          T.TripletTrainConfig(**kw))

        with pytest.raises(ValueError, match="zero gradient"):
            run(kernel="triplet_indicator")
        with pytest.raises(ValueError, match="degree-3"):
            run(kernel="hinge")
        with pytest.raises(NotImplementedError, match="swor"):
            run(triplet_design="swor")
        with pytest.raises(ValueError, match="unknown triplet design"):
            run(triplet_design="nope")
        with pytest.raises(ValueError, match="too small"):
            run(n_workers=5)


class TestEmbedderPlugin:
    def test_mlp_embedder_beats_linear_on_radial(self):
        Xc_tr, Xo_tr, Xc_te, Xo_te = _radial(0)
        cfg = T.TripletTrainConfig(
            lr=0.3, steps=400, n_workers=4, repartition_every=10,
            triplets_per_worker=1024, seed=0, embed_dim=2)
        finals = {}
        for name, emb in (("linear", TS.LinearEmbed(dim=8, embed_dim=2)),
                          ("mlp", TS.MLPEmbed(dim=8, hidden=32,
                                              embed_dim=2))):
            p1, _ = _train(emb.init(0), Xc_tr, Xo_tr, cfg, embedder=emb)
            finals[name] = T.evaluate_triplet_accuracy(
                p1, Xc_te, Xo_te, embedder=emb, device="cpu")
        assert finals["mlp"] > finals["linear"] + 0.05, finals

    def test_mlp_checkpoint_resume_and_mismatch(self, tmp_path):
        Xc_tr, Xo_tr, _, _ = _radial(1)
        emb = TS.MLPEmbed(dim=8, hidden=16, embed_dim=2)
        cfg = T.TripletTrainConfig(
            lr=0.1, steps=12, n_workers=4, repartition_every=4,
            triplets_per_worker=128, seed=2, embed_dim=2)
        p_straight, h_straight = _train(emb.init(1), Xc_tr, Xo_tr, cfg,
                                        embedder=emb)
        ckpt = str(tmp_path / "mlp.npz")
        _train(emb.init(1), Xc_tr, Xo_tr, dataclasses.replace(cfg, steps=6),
               embedder=emb, checkpoint_path=ckpt)
        p_res, h_res = _train(emb.init(1), Xc_tr, Xo_tr, cfg, embedder=emb,
                              checkpoint_path=ckpt)
        _equal(p_res, p_straight)
        assert h_res["loss"].tobytes() == h_straight["loss"].tobytes()
        other = TS.MLPEmbed(dim=8, hidden=32, embed_dim=2)
        with pytest.raises(ValueError, match="config mismatch"):
            _train(other.init(1), Xc_tr, Xo_tr, cfg, embedder=other,
                   checkpoint_path=ckpt)

    def test_bare_params_require_linear_shape(self):
        p_mlp = TS.MLPEmbed(dim=8, hidden=16, embed_dim=2).init(0)
        with pytest.raises(ValueError, match="embedder"):
            _train(p_mlp, np.zeros((16, 8), np.float32),
                   np.zeros((16, 8), np.float32), T.TripletTrainConfig())


@pytest.mark.parametrize("name", ["linear", "mlp"])
def test_jax_checkpoint_resumes_in_the_port(name, tmp_path):
    Xc_tr, Xo_tr, Xc_te, Xo_te = _radial(2, n=200)
    cfg = J.TripletTrainConfig(lr=0.2, steps=12, n_workers=4,
                               repartition_every=4, triplets_per_worker=128,
                               seed=3, embed_dim=2)
    if name == "linear":
        j_emb, t_emb = None, None
        p0 = J.init_embed(8, 2, seed=1)
    else:
        j_emb = JS.MLPEmbed(dim=8, hidden=16, embed_dim=2)
        t_emb = TS.MLPEmbed(dim=8, hidden=16, embed_dim=2)
        p0 = j_emb.init(1)
    path = str(tmp_path / "jax.npz")
    kw = dict(eval_every=3, eval_data=(Xc_te, Xo_te))
    pj, hj = J.train_triplet(p0, Xc_tr, Xo_tr,
                             dataclasses.replace(cfg, steps=6),
                             checkpoint_path=path, embedder=j_emb, **kw)
    pt, ht = _train(p0, Xc_tr, Xo_tr, _port_cfg(cfg), checkpoint_path=path,
                    embedder=t_emb, **kw)
    assert ht["loss"].shape == (12,) and np.isfinite(ht["loss"]).all()
    np.testing.assert_array_equal(ht["loss"][:6], hj["loss"])
    assert list(ht["eval_steps"]) == [3, 6, 9, 12]
    np.testing.assert_array_equal(ht["test_acc"][:2], hj["test_acc"])
    assert pt.keys() == pj.keys()
    ck = load_checkpoint(path)
    assert ck["step"] == 12
    want = dataclasses.asdict(cfg)
    if name == "mlp":
        want["embedder"] = repr(j_emb)
    assert ck["config"] == want
