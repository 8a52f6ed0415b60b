"""The plain references against the port's plain CPU path at tiny sizes:
the same rows, partitions and steps from the same seed."""

import numpy as np
import pytest
import torch

from benchmark.reference import auc_complete, auc_mc, pairwise_sgd as ref
from tuplewise_tpu_torch.harness.mesh_mc import (
    make_mesh_mc_runner, worker_draws,
)
from tuplewise_tpu_torch.harness.variance import VarianceConfig
from tuplewise_tpu_torch.models.pairwise_sgd import TrainConfig, train_pairwise
from tuplewise_tpu_torch.models.scorers import LinearScorer
from tuplewise_tpu_torch.parallel.mesh import make_mesh

SEED = 2**31 + 12345


def _cfg(n1, n2, **kw):
    return VarianceConfig(kernel="auc", backend="mesh", n_pos=n1, n_neg=n2,
                          n_workers=8, seed=SEED, **kw)


@pytest.mark.parametrize("n1,n2", [(1000, 1000), (1003, 995)])
def test_rep_rows_are_the_runners_draws(n1, n2):
    a, b = worker_draws(_cfg(n1, n2), make_mesh(8, "cpu"),
                        ("mc_rep", 7))
    ra, rb = auc_mc.rep_rows(SEED, 7, n1, n2, 8, 1.0, "cpu")
    assert torch.equal(a.reshape(-1)[:n1], ra)
    assert torch.equal(b.reshape(-1)[:n2], rb)


def test_twice_wins_counts_ties_once():
    a = torch.tensor([[1.0, 2.0, 2.0]])
    b = torch.tensor([[2.0, 0.0]])
    # (1, 2) 0, (1, 0) 2, (2, 2) 1, (2, 0) 2, twice
    assert auc_mc.twice_wins(a, b).tolist() == [8]


@pytest.mark.parametrize("scheme,n1,n2,rounds", [
    ("complete", 1000, 1000, 1), ("complete", 1003, 995, 1),
    ("repartitioned", 1000, 1000, 4), ("repartitioned", 1000, 1016, 3),
    ("local", 1000, 1000, 1), ("local", 1003, 995, 1)])
def test_estimates_match_the_runner(scheme, n1, n2, rounds):
    runner = {"scheme": scheme, "n_rounds": rounds}
    run = make_mesh_mc_runner(_cfg(n1=n1, n2=n2, **runner), device="cpu")
    got = run(range(3, 6))
    want = [auc_mc.estimate(runner, SEED, r, n1, n2, 8, 1.0, "cpu")
            for r in range(3, 6)]
    if scheme == "complete":
        assert got.tolist() == want
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_complete_is_exact_with_ties():
    g = torch.Generator().manual_seed(3)
    a = (torch.randn(3000, generator=g) * 4).round() / 4 + 0.5
    b = (torch.randn(2000, generator=g) * 4).round() / 4
    want = sum((x > y) + 0.5 * (x == y) for x in a.tolist()
               for y in b.tolist()) / (3000 * 2000)
    got = auc_complete.estimate(a, b, seed=SEED, rep=0, n_workers=8,
                                runner={})
    assert got == pytest.approx(want, abs=1e-15)


def test_bfloat16_rows_change_the_estimate():
    runner = {"scheme": "complete"}
    full = auc_mc.estimate(runner, SEED, 0, 4000, 4000, 8, 1.0, "cpu")
    low = auc_mc.estimate(runner, SEED, 0, 4000, 4000, 8, 1.0, "cpu",
                          dtype=torch.bfloat16)
    assert low != full and abs(low - full) < 1e-3


@pytest.mark.parametrize("surrogate,calls", [
    ("logistic", [1, 1, 1]), ("logistic", [1, 12]), ("hinge", [1, 12])])
def test_sgd_calls_follow_the_trainers_calls(surrogate, calls):
    # a call of 12 steps with repartition every 5 regathers at 5 and 10
    n1, n2, dim = 240, 760, 14
    Xp, Xn = ref.make_rows(SEED, n1, n2, dim, 0.8, "cpu")
    p0 = ref.init_params(SEED, dim, "cpu")
    plan = [(ref.call_seed(SEED, k), n) for k, n in enumerate(calls)]
    out = ref.sgd_calls(Xp, Xn, p0, plan, n_workers=8, lr=0.1,
                        repartition_every=5, surrogate=surrogate,
                        block_rows=7)
    scorer = LinearScorer(dim=dim)
    params = {k: v.numpy() for k, v in p0.items()}
    losses, at = [], 0
    for s, n in plan:
        cfg = TrainConfig(kernel=surrogate, lr=0.1, steps=n, n_workers=8,
                          repartition_every=5, seed=s)
        params, hist = train_pairwise(scorer, params, Xp, Xn, cfg,
                                      device="cpu")
        losses.extend(hist["loss"])
        at += n
        np.testing.assert_allclose(params["w"], out["params"][at]["w"].numpy(),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(losses, out["loss"], rtol=1e-6)
    if surrogate == "logistic":
        # the bias has no gradient: the reference's is round-off, far
        # under the thousandth of the median leaf's that leaves it out
        g = out["grad"][0]
        assert abs(float(g["b"])) < 1e-6 * float(g["w"].norm())


def test_sgd_calls_faults_change_the_steps():
    Xp, Xn = ref.make_rows(SEED, 240, 760, 14, 0.8, "cpu")
    p0 = ref.init_params(SEED, 14, "cpu")
    plan = [(ref.call_seed(SEED, 0), 12)]
    kw = dict(n_workers=8, lr=0.1, repartition_every=5)
    sound = ref.sgd_calls(Xp, Xn, p0, plan, **kw)
    stale = ref.sgd_calls(Xp, Xn, p0, plan, regather=False, **kw)
    frozen = ref.sgd_calls(Xp, Xn, p0, plan, update=False, **kw)
    # the first blocks stand until step 5
    assert stale["loss"][:5] == sound["loss"][:5]
    assert stale["loss"][5] != sound["loss"][5]
    assert frozen["loss"][0] == sound["loss"][0]
    assert frozen["loss"][1] != sound["loss"][1]
    assert torch.equal(frozen["params"][-1]["w"], p0["w"].double())


def test_leaf_gaps_leave_out_a_leaf_without_gradient():
    g = {"w": torch.tensor([3.0, 4.0]), "b": torch.tensor(1e-17)}
    prog = {"w": torch.tensor([3.0, 4.1]), "b": torch.tensor(5.0)}
    gap = ref.leaf_gaps(prog, g, g)
    assert gap == pytest.approx((float(prog["w"].norm()) - 5.0) / 5.0)
