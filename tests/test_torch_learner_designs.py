"""The learners with the distinct designs, and the numpy oracle trainer,
on the CPU.

* ``train_pairwise_numpy`` is a numpy copy: equal to the JAX package's
  bit for bit (params and loss).
* The port's full-pair trainer at N = 1 follows the oracle within rel
  1e-4 after 20 steps (float32 against float64; with one worker the
  permutation drawn does not change a step's gradient).
* The budgeted learners draw their designs on the device with torch
  generators, the JAX learners with jax keys, so the two compare
  statistically: the same test AUC within 0.02 after 30 steps on the
  same data (the spread between designs and seeds here is under 0.005).
  On the Adult surrogate the JAX learner reaches a test AUC of 0.791 from
  0.578 in 20 steps (hinge, B = 4096, lr 0.1): the port must reach 0.75.
* Resume is exact: a chunked run with a checkpoint equals the straight
  run bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from tuplewise_tpu.models import pairwise_sgd as J
from tuplewise_tpu.models import scorers as JS
from tuplewise_tpu_torch.data import (
    load_adult_splits, make_gaussian_splits,
)
from tuplewise_tpu_torch.models import pairwise_sgd as T
from tuplewise_tpu_torch.models import sim_learner as TSim
from tuplewise_tpu_torch.models import triplet_sgd as TT
from tuplewise_tpu_torch.models.scorers import LinearScorer

DESIGNS = ["swor", "bernoulli"]


@pytest.fixture(scope="module")
def gauss():
    return make_gaussian_splits(240, 300, dim=5, separation=1.2, seed=3)


def _equal(p, q):
    assert p.keys() == q.keys()
    for k in p:
        assert np.asarray(p[k]).tobytes() == np.asarray(q[k]).tobytes(), k


@pytest.mark.parametrize("kernel", ["logistic", "hinge"])
@pytest.mark.parametrize("n_workers,scheme", [(1, "swor"), (3, "swor"),
                                              (3, "swr")])
def test_numpy_oracle_equals_reference(gauss, kernel, n_workers, scheme):
    Xp, Xn, _, _ = gauss
    kw = dict(kernel=kernel, lr=0.3, steps=12, n_workers=n_workers,
              repartition_every=4, scheme=scheme, seed=5)
    p0 = JS.LinearScorer(dim=5).init(0)
    pj, hj = J.train_pairwise_numpy(None, p0, Xp, Xn, J.TrainConfig(**kw))
    pt, ht = T.train_pairwise_numpy(None, p0, Xp, Xn, T.TrainConfig(**kw))
    _equal(pj, pt)
    assert hj["loss"].tobytes() == ht["loss"].tobytes()
    assert ht["loss"][-1] < ht["loss"][0]


@pytest.mark.parametrize("kernel", ["logistic", "hinge"])
def test_full_pair_trainer_follows_the_oracle(gauss, kernel):
    Xp, Xn, _, _ = gauss
    cfg = T.TrainConfig(kernel=kernel, lr=0.5, steps=20, n_workers=1,
                        repartition_every=5)
    s = LinearScorer(dim=5)
    p0 = s.init(0)
    want, hw = T.train_pairwise_numpy(s, p0, Xp, Xn, cfg)
    got, hg = T.train_pairwise(s, p0, Xp, Xn, cfg, device="cpu")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(hg["loss"], hw["loss"], rtol=1e-4)


@pytest.mark.parametrize("design", DESIGNS)
def test_budgeted_learner_as_the_jax_learner(gauss, design):
    Xp, Xn, Xp_te, Xn_te = gauss
    kw = dict(kernel="hinge", lr=0.3, steps=30, n_workers=1,
              repartition_every=5, pairs_per_worker=512, pair_design=design)
    js = JS.LinearScorer(dim=5)
    p0 = js.init(0)
    pj, _ = J.train_pairwise(js, dict(p0), Xp, Xn, J.TrainConfig(**kw))
    s = LinearScorer(dim=5)
    pt, ht = T.train_pairwise(s, p0, Xp, Xn, T.TrainConfig(**kw),
                              device="cpu")
    auc0 = T.evaluate_auc(s, p0, Xp_te, Xn_te, device="cpu")
    auc_t = T.evaluate_auc(s, pt, Xp_te, Xn_te, device="cpu")
    auc_j = J.evaluate_auc(js, pj, Xp_te, Xn_te)
    assert auc_t > auc0 + 0.05 and abs(auc_t - auc_j) < 0.02
    assert np.isfinite(ht["loss"]).all() and ht["loss"][-1] < ht["loss"][0]


@pytest.mark.parametrize("design", DESIGNS)
def test_budgeted_learner_on_the_adult_surrogate(design):
    Xtr, ytr, Xte, yte, meta = load_adult_splits()
    assert meta["synthetic"] and meta["split"] == "stratified"
    Xp, Xn = T.split_by_label(Xtr, ytr)
    Xp_te, Xn_te = T.split_by_label(Xte, yte)
    s = LinearScorer(dim=Xtr.shape[1])
    p0 = s.init(0)
    cfg = T.TrainConfig(kernel="hinge", lr=0.1, steps=20, n_workers=1,
                        pairs_per_worker=4096, pair_design=design)
    p, _ = T.train_pairwise(s, p0, Xp, Xn, cfg, device="cpu")
    before = T.evaluate_auc(s, p0, Xp_te, Xn_te, device="cpu")
    after = T.evaluate_auc(s, p, Xp_te, Xn_te, device="cpu")
    assert before < 0.6 and after >= 0.75, (before, after)


@pytest.mark.parametrize("design", DESIGNS)
def test_budgeted_resume_is_exact(gauss, tmp_path, design):
    Xp, Xn, _, _ = gauss
    cfg = T.TrainConfig(kernel="hinge", lr=0.3, steps=12, n_workers=4,
                        repartition_every=5, pairs_per_worker=200,
                        pair_design=design, loss_every=2)
    s = LinearScorer(dim=5)
    p_straight, h_straight = T.train_pairwise(s, s.init(0), Xp, Xn, cfg,
                                              device="cpu")
    path = str(tmp_path / "ck.npz")
    T.train_pairwise(s, s.init(0), Xp, Xn, dataclasses.replace(cfg, steps=7),
                     device="cpu", checkpoint_path=path, checkpoint_every=3)
    p_res, h_res = T.train_pairwise(s, s.init(0), Xp, Xn, cfg, device="cpu",
                                    checkpoint_path=path, checkpoint_every=3)
    _equal(p_straight, p_res)
    assert h_straight["loss"].tobytes() == h_res["loss"].tobytes()


@pytest.mark.parametrize("design", DESIGNS)
def test_sim_learner_curves_with_designs(gauss, design):
    """train_curves shares the step engine: replica 0 is train_pairwise
    at cfg.seed (to float rounding), and the row echoes the design."""
    Xp, Xn, Xp_te, Xn_te = gauss
    cfg = T.TrainConfig(kernel="hinge", lr=0.3, steps=10, n_workers=4,
                        repartition_every=5, pairs_per_worker=128,
                        pair_design=design, seed=2)
    s = LinearScorer(dim=5)
    out = TSim.train_curves(s, s.init(0), Xp, Xn, Xp_te, Xn_te, cfg,
                            n_seeds=3, eval_every=5, device="cpu")
    p1, _ = T.train_pairwise(s, s.init(0), Xp, Xn, cfg, device="cpu")
    for k in p1:
        np.testing.assert_allclose(out["final_params"][k][0], p1[k],
                                   rtol=1e-4, atol=1e-6)
    row = TSim.curve_record(cfg, out, 3)
    assert row["pair_design"] == design and row["pairs_per_worker"] == 128
    assert out["test_auc"].shape == (3, 3)
    assert (out["test_auc"][:, -1] > out["test_auc"][:, 0]).all()


@pytest.mark.parametrize("design", DESIGNS)
def test_triplet_learner_with_designs(tmp_path, design):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 8)).astype(np.float32)
    Y = (rng.normal(size=(600, 8)) + 0.5).astype(np.float32)
    cfg = TT.TripletTrainConfig(lr=0.1, steps=30, n_workers=4, embed_dim=2,
                                triplets_per_worker=512,
                                triplet_design=design)
    p0 = TT.init_embed(8, 2)
    kw = dict(eval_every=10, eval_data=(X[200:], Y[400:]), device="cpu")
    p, h = TT.train_triplet(p0, X[:200], Y[:400], cfg, **kw)
    acc0 = TT.evaluate_triplet_accuracy(p0, X[200:], Y[400:], device="cpu")
    assert h["test_acc"][-1] > acc0 and np.isfinite(h["loss"]).all()
    path = str(tmp_path / "ck.npz")
    TT.train_triplet(p0, X[:200], Y[:400], dataclasses.replace(cfg, steps=20),
                     checkpoint_path=path, **kw)
    p_res, h_res = TT.train_triplet(p0, X[:200], Y[:400], cfg,
                                    checkpoint_path=path, **kw)
    _equal(p, p_res)
    assert h["loss"].tobytes() == h_res["loss"].tobytes()
