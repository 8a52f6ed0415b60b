"""The port's learner (models.scorers, models.pairwise_sgd,
models.sim_learner, utils.checkpoint) against the JAX package, on the
same numpy-made data and the same initial parameters, on the CPU.

Tolerances: with one worker and all pairs, a step's gradient does not
depend on the permutation drawn, so the two packages' trajectories
differ only by float32 rounding: rtol 1e-4 after 20 steps. Runs that
draw worker blocks use torch generators in the port and jax keys in the
reference, so those compare statistically (within 4 standard errors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.data import make_gaussian_splits as j_splits
from tuplewise_tpu.models import pairwise_sgd as J
from tuplewise_tpu.models import scorers as JS
from tuplewise_tpu.models import sim_learner as JSim
from tuplewise_tpu.ops import pair_tiles as jt
from tuplewise_tpu.ops.kernels import get_kernel as j_kernel
from tuplewise_tpu_torch.data import make_gaussian_splits
from tuplewise_tpu_torch.models import pairwise_sgd as T
from tuplewise_tpu_torch.models import scorers as TS
from tuplewise_tpu_torch.models import sim_learner as TSim
from tuplewise_tpu_torch.ops import kernels as kernels_mod
from tuplewise_tpu_torch.ops.kernels import Kernel, get_kernel, register_kernel
from tuplewise_tpu_torch.utils.state import params_to_state, state_to_params


@pytest.fixture(scope="module")
def gauss():
    Xp, Xn, Xp_te, Xn_te = make_gaussian_splits(240, 300, dim=5,
                                                separation=1.2, seed=3)
    return Xp, Xn[:200], Xp_te, Xn_te


def _port_cfg(cfg):
    return T.TrainConfig(**dataclasses.asdict(cfg))


def _rel(p, q):
    diff = max(float(np.abs(np.asarray(p[k]) - np.asarray(q[k])).max())
               for k in q)
    return diff / max(float(np.abs(np.asarray(q[k])).max()) for k in q)


class TestScorers:
    @pytest.mark.parametrize("make", [
        lambda m: m.LinearScorer(dim=6),
        lambda m: m.MLPScorer(dim=6, hidden=7),
    ])
    def test_init_and_forward_match_jax(self, make):
        j, t = make(JS), make(TS)
        for seed in (0, 3):
            jp, tp = j.init(seed), t.init(seed)
            assert jp.keys() == tp.keys()
            for k in jp:
                np.testing.assert_array_equal(jp[k], tp[k])
        t.load_state_dict(params_to_state(j.init(3)))
        X = np.random.default_rng(1).standard_normal((40, 6)).astype(np.float32)
        want = np.asarray(j.apply(
            {k: jnp.asarray(v, jnp.float32) for k, v in j.init(3).items()},
            jnp.asarray(X), jnp))
        got = t(torch.from_numpy(X)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # batched params [S, ...] score [S, R, d] replica by replica
        P = {k: torch.stack([v, 2 * v]) for k, v in
             params_to_state(j.init(3)).items()}
        Xs = torch.from_numpy(np.stack([X, X[::-1].copy()]))
        batched = t.score(P, Xs)
        for s in range(2):
            one = t.score({k: v[s] for k, v in P.items()}, Xs[s])
            torch.testing.assert_close(batched[s], one, rtol=1e-6, atol=1e-6)

    def test_parameters_carry_over_both_ways(self):
        j = JS.MLPScorer(dim=4, hidden=5)
        t, p0 = TS.init_scorer("mlp", 4, seed=2, hidden=5)
        jparams = j.init(9)
        t.load_state_dict(params_to_state(jparams))
        back = state_to_params(t.state_dict())
        for k in jparams:
            assert back[k].dtype == np.float32
            np.testing.assert_array_equal(back[k],
                                          jparams[k].astype(np.float32))
        for k, v in p0.items():
            np.testing.assert_array_equal(v, j.init(2)[k])


class TestTrainPairwise:
    @pytest.mark.parametrize("kernel", ["hinge", "logistic"])
    @pytest.mark.parametrize("loss_every", [1, 3])
    def test_one_worker_matches_jax(self, gauss, kernel, loss_every):
        Xp, Xn, _, _ = gauss
        js = JS.LinearScorer(dim=5)
        p0 = js.init(0)
        cfg = J.TrainConfig(kernel=kernel, lr=0.5, steps=20, n_workers=1,
                            repartition_every=5, tile=128,
                            loss_every=loss_every)
        pj, hj = J.train_pairwise(js, dict(p0), Xp, Xn, cfg)
        pt, ht = T.train_pairwise(TS.LinearScorer(dim=5), p0, Xp, Xn,
                                  _port_cfg(cfg), device="cpu")
        assert _rel(pt, pj) < 1e-4
        rec = np.arange(20) % loss_every == 0
        assert np.isnan(ht["loss"][~rec]).all()
        np.testing.assert_allclose(ht["loss"][rec], hj["loss"][rec],
                                   rtol=1e-4)
        assert ht["loss"][rec][-1] < ht["loss"][0]

    @pytest.mark.parametrize("kernel", ["hinge", "logistic"])
    def test_one_four_worker_step_matches_jax_grad(self, gauss, kernel):
        Xp, Xn, _, _ = gauss
        rng = np.random.default_rng(6)
        A = Xp[rng.permutation(len(Xp))[:4 * 50]].reshape(4, 50, 5)
        B = Xn[rng.permutation(len(Xn))[:4 * 40]].reshape(4, 40, 5)
        js = JS.LinearScorer(dim=5)
        p0 = {k: np.asarray(v, np.float32) for k, v in js.init(1).items()}
        jk = j_kernel(kernel)

        def loss(p):
            vals = [jt.diff_pair_mean(jk, js.apply(p, jnp.asarray(A[w]), jnp),
                                      js.apply(p, jnp.asarray(B[w]), jnp),
                                      32, 32) for w in range(4)]
            return jnp.mean(jnp.stack(vals))

        pj = {k: jnp.asarray(v) for k, v in p0.items()}
        want_loss, g = jax.value_and_grad(loss)(pj)
        want = {k: np.asarray(pj[k] - 0.3 * g[k]) for k in pj}
        cfg = T.TrainConfig(kernel=kernel, lr=0.3, n_workers=4)
        new, got_loss = T.sgd_step(
            TS.LinearScorer(dim=5), get_kernel(kernel), cfg,
            {k: v[None] for k, v in params_to_state(p0).items()},
            torch.from_numpy(A[None].astype(np.float32)),
            torch.from_numpy(B[None].astype(np.float32)), [0], 0)
        assert got_loss.shape == (1,)
        assert abs(float(got_loss[0]) - float(want_loss)) < 1e-6
        for k in want:
            np.testing.assert_allclose(new[k][0].numpy(), want[k],
                                       rtol=1e-6, atol=1e-7)

    def test_chunked_run_equals_unchunked_exactly(self, gauss, tmp_path):
        Xp, Xn, _, _ = gauss
        s = TS.LinearScorer(dim=5)
        cfg = T.TrainConfig(kernel="logistic", lr=0.3, steps=10, n_workers=4,
                            repartition_every=4, loss_every=4)
        p_a, h_a = T.train_pairwise(s, s.init(5), Xp, Xn, cfg, device="cpu")
        p_b, h_b = T.train_pairwise(s, s.init(5), Xp, Xn, cfg, device="cpu",
                                    checkpoint_path=str(tmp_path / "ck.npz"),
                                    checkpoint_every=3)
        p_c, h_c = T.train_pairwise(
            s, s.init(5), Xp, Xn, dataclasses.replace(cfg, steps=7),
            device="cpu", checkpoint_path=str(tmp_path / "ck2.npz"))
        p_c, h_c = T.train_pairwise(s, s.init(5), Xp, Xn, cfg, device="cpu",
                                    checkpoint_path=str(tmp_path / "ck2.npz"))
        for p, h in [(p_b, h_b), (p_c, h_c)]:
            for k in p_a:
                assert p[k].tobytes() == p_a[k].tobytes()
            assert h["loss"].tobytes() == h_a["loss"].tobytes()
        # done: the checkpoint answers without training
        p_d, h_d = T.train_pairwise(s, s.init(5), Xp, Xn, cfg, device="cpu",
                                    checkpoint_path=str(tmp_path / "ck2.npz"))
        assert p_d["w"].tobytes() == p_a["w"].tobytes()

    def test_jax_checkpoint_resumes_in_the_port(self, gauss, tmp_path):
        Xp, Xn, _, _ = gauss
        js = JS.LinearScorer(dim=5)
        p0 = js.init(2)
        cfg = J.TrainConfig(kernel="hinge", lr=0.4, steps=16, n_workers=1,
                            repartition_every=4, tile=128, loss_every=2)
        path = str(tmp_path / "jax.npz")
        J.train_pairwise(js, dict(p0), Xp, Xn,
                         dataclasses.replace(cfg, steps=6),
                         checkpoint_path=path)
        pj, hj = J.train_pairwise(js, dict(p0), Xp, Xn, cfg)
        pt, ht = T.train_pairwise(TS.LinearScorer(dim=5), p0, Xp, Xn,
                                  _port_cfg(cfg), checkpoint_path=path,
                                  device="cpu")
        assert _rel(pt, pj) < 1e-4
        assert ht["loss"].shape == (16,)
        np.testing.assert_allclose(ht["loss"][::2], hj["loss"][::2],
                                   rtol=1e-4)
        # and a port checkpoint is a JAX checkpoint
        from tuplewise_tpu.utils.checkpoint import load_checkpoint

        ck = load_checkpoint(path)
        assert ck["step"] == 16 and ck["config"] == dataclasses.asdict(cfg)

    def test_budgeted_swr_path_learns_and_masks(self, gauss):
        Xp, Xn, Xp_te, Xn_te = gauss
        s = TS.LinearScorer(dim=5)
        p0 = s.init(7)
        cfg = T.TrainConfig(kernel="hinge", lr=0.2, steps=40, n_workers=4,
                            repartition_every=10, pairs_per_worker=256,
                            loss_every=2)
        p1, h = T.train_pairwise(s, p0, Xp, Xn, cfg, device="cpu")
        assert np.isnan(h["loss"][1::2]).all()
        assert np.isfinite(h["loss"][::2]).all()
        auc0 = T.evaluate_auc(s, p0, Xp_te, Xn_te, device="cpu")
        auc1 = T.evaluate_auc(s, p1, Xp_te, Xn_te, device="cpu")
        assert auc1 > max(auc0, 0.75)
        p2, _ = T.train_pairwise(s, p0, Xp, Xn,
                                 dataclasses.replace(cfg, loss_every=1),
                                 device="cpu")
        assert p1["w"].tobytes() == p2["w"].tobytes()

    def test_value_errors(self, gauss, tmp_path, monkeypatch):
        Xp, Xn, _, _ = gauss
        s = TS.LinearScorer(dim=5)
        p0 = s.init(0)

        def run(**kw):
            return T.train_pairwise(s, p0, Xp, Xn,
                                    T.TrainConfig(steps=2, **kw),
                                    device="cpu")

        with pytest.raises(ValueError, match="zero gradient"):
            run(kernel="auc")
        with pytest.raises(ValueError, match="score-difference"):
            run(kernel="scatter")
        # registered into a copy of the registry, restored after the test
        monkeypatch.setattr(kernels_mod, "_REGISTRY",
                            dict(kernels_mod._REGISTRY))
        register_kernel(Kernel(name="sq_no_grad", degree=2, two_sample=True,
                               kind="diff", diff_fn=lambda d: (1 - d) ** 2))
        with pytest.raises(ValueError, match="analytic gradient"):
            run(kernel="sq_no_grad", loss_every=2)
        run(kernel="sq_no_grad")            # autograd through the plain mean
        with pytest.raises(ValueError, match="too small"):
            run(n_workers=500)
        with pytest.raises(NotImplementedError, match="swor"):
            run(pairs_per_worker=8, pair_design="swor")
        with pytest.raises(ValueError, match="unknown pair design"):
            run(pairs_per_worker=8, pair_design="nope")
        path = str(tmp_path / "ck.npz")
        T.train_pairwise(s, p0, Xp, Xn, T.TrainConfig(steps=2), device="cpu",
                         checkpoint_path=path)
        with pytest.raises(ValueError, match="config mismatch"):
            T.train_pairwise(s, p0, Xp, Xn, T.TrainConfig(steps=2, lr=0.5),
                             device="cpu", checkpoint_path=path)
        with pytest.raises(ValueError, match="past the requested"):
            T.train_pairwise(s, p0, Xp, Xn, T.TrainConfig(steps=1),
                             device="cpu", checkpoint_path=path)

    def test_entry_points_need_a_card_unless_asked_for_the_cpu(
            self, gauss, monkeypatch):
        Xp, Xn, Xp_te, Xn_te = gauss
        s = TS.LinearScorer(dim=5)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = T.TrainConfig(steps=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            T.train_pairwise(s, None, Xp, Xn, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            TSim.train_curves(s, s.init(0), Xp, Xn, Xp_te, Xn_te, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            T.evaluate_auc(s, None, Xp_te, Xn_te)

    def test_evaluate_auc_and_split_by_label_match_jax(self, gauss):
        Xp, Xn, Xp_te, Xn_te = gauss
        js, ts = JS.LinearScorer(dim=5), TS.LinearScorer(dim=5)
        p = js.init(4)
        want = J.evaluate_auc(js, p, Xp_te, Xn_te)
        assert abs(T.evaluate_auc(ts, p, Xp_te, Xn_te, device="cpu")
                   - want) < 1e-4
        ts.load_state_dict(params_to_state(p))
        assert abs(T.evaluate_auc(ts, None, Xp_te, Xn_te, device="cpu")
                   - want) < 1e-4
        X = np.concatenate([Xp, Xn])
        y = np.r_[np.ones(len(Xp)), np.zeros(len(Xn))]
        for a, b in zip(T.split_by_label(X, y), J.split_by_label(X, y)):
            np.testing.assert_array_equal(a, b)


class TestSimLearner:
    def test_replicas_match_train_pairwise(self, gauss):
        Xp, Xn, Xp_te, Xn_te = gauss
        s = TS.LinearScorer(dim=5)
        p0 = s.init(0)
        cfg = T.TrainConfig(kernel="hinge", lr=0.3, steps=20, n_workers=8,
                            repartition_every=5, seed=11, loss_every=3)
        out = TSim.train_curves(s, p0, Xp, Xn, Xp_te, Xn_te, cfg, n_seeds=3,
                                eval_every=7, device="cpu")
        assert out["test_auc"].shape == (3, 4)
        assert out["loss"].shape == (3, 20)
        assert list(out["steps"]) == [0, 7, 14, 20]
        for r in range(3):
            p, h = T.train_pairwise(s, p0, Xp, Xn,
                                    dataclasses.replace(cfg, seed=11 + r),
                                    device="cpu")
            assert _rel({k: v[r] for k, v in out["final_params"].items()},
                        p) < 1e-4
            np.testing.assert_array_equal(np.isnan(out["loss"][r]),
                                          np.isnan(h["loss"]))
            m = np.isfinite(h["loss"])
            np.testing.assert_allclose(out["loss"][r][m], h["loss"][m],
                                       rtol=1e-4)

    def test_records_match_jax(self):
        rng = np.random.default_rng(0)
        loss = rng.random((4, 10)).astype(np.float32)
        loss[:, 1::3] = np.nan
        for le in (1, 3, 20):
            assert TSim.last_recorded_loss(loss, le) == \
                JSim.last_recorded_loss(loss, le)
        assert TSim.last_recorded_loss(np.zeros((2, 0)), 1) is None
        out = {"steps": np.array([0, 5, 10]),
               "test_auc": rng.random((4, 3)), "loss": loss}
        for S, nr in [(4, 5), (1, TSim.NEVER)]:
            cfg = T.TrainConfig(kernel="hinge", steps=10,
                                repartition_every=nr, loss_every=3)
            o = dict(out, test_auc=out["test_auc"][:S], loss=loss[:S])
            assert TSim.curve_record(cfg, o, S) == \
                JSim.curve_record(J.TrainConfig(**dataclasses.asdict(cfg)),
                                  o, S)
        assert TSim.NEVER == JSim.NEVER

    def test_final_auc_matches_jax_statistically(self):
        # the quick gauss cell of scripts/learning_suite.py
        Xp, Xn, Xp_te, Xn_te = j_splits(128, 2000, dim=10, separation=0.8,
                                        seed=0)
        cfg = J.TrainConfig(kernel="hinge", lr=0.3, steps=40, seed=1000,
                            n_workers=16, repartition_every=5)
        p0 = JS.LinearScorer(dim=10).init(0)
        j = JSim.train_curves(JS.LinearScorer(dim=10), p0, Xp, Xn, Xp_te,
                              Xn_te, cfg, n_seeds=8, eval_every=20)
        t = TSim.train_curves(TS.LinearScorer(dim=10), p0, Xp, Xn, Xp_te,
                              Xn_te, _port_cfg(cfg), n_seeds=8,
                              eval_every=20, device="cpu")
        np.testing.assert_allclose(t["test_auc"][:, 0], j["test_auc"][:, 0],
                                   atol=1e-4)
        fj, ft = j["test_auc"][:, -1], t["test_auc"][:, -1]
        se = np.sqrt(fj.var(ddof=1) / 8 + ft.var(ddof=1) / 8)
        assert abs(fj.mean() - ft.mean()) < 4 * max(se, 1e-4)
        assert ft.mean() > t["test_auc"][:, 0].mean()
