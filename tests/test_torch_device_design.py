"""The port's device designs (ops.device_design) on the CPU: the cases of
tests/test_device_design.py and the design-distribution cases of
tests/test_sampling_designs.py. torch and jax generators give different
bits, so the port is held to the host oracle (parallel.partition), to
the JAX device sampler and to the exact closed forms statistically:

* sizes and per-cell inclusion counts within 4-5 standard deviations of
  their Binomial laws;
* the conditional variance over design redraws within 20 % (pairs, 800
  redraws: the sampling error of a variance is sqrt(2/800) = 5 %) or
  25 % (triplets, 600 redraws) of the exact finite-population form;
* means within 5 standard errors of the complete statistic.

Draws that must repeat bit for bit (swr against the learners' historical
sequence, a harness rep against any chunk that draws it) are compared
exactly. A test marked cuda runs the draws on the card under
torch.cuda.set_sync_debug_mode("error"): no draw may stop the host.
"""

from math import comb

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.ops.device_design import (
    draw_pair_design_device as j_pair_design,
)
from tuplewise_tpu_torch.estimators.variance import (
    conditional_incomplete_variance,
)
from tuplewise_tpu_torch.models.metrics import auc_score
from tuplewise_tpu_torch.ops import device_design as D
from tuplewise_tpu_torch.ops.kernels import get_kernel
from tuplewise_tpu_torch.ops.pair_tiles import (
    sample_pair_indices, triplet_stats,
)
from tuplewise_tpu_torch.parallel.partition import draw_pair_design
from tuplewise_tpu_torch.utils.rng import generator


def _gen(*idx):
    return generator(0, "design", *idx)


def _tuples(w, *cols):
    sel = w > 0
    return set(zip(*(c[sel].tolist() for c in cols)))


def test_swor_distinct_exact_budget():
    i, j, w = D.draw_pair_design_device(_gen(), 37, 53, 800, "swor",
                                        batch=(3,))
    assert i.shape == (3, 800) and w.dtype == torch.float32
    for r in range(3):
        assert float(w[r].sum()) == 800
        assert len(_tuples(w[r], i[r], j[r])) == 800
    assert int(i.min()) >= 0 and int(i.max()) < 37
    assert int(j.min()) >= 0 and int(j.max()) < 53


def test_bernoulli_realized_size_binomial():
    w = D.draw_pair_design_device(_gen(), 100, 100, 2000, "bernoulli",
                                  batch=(120,))[2]
    sizes = w.sum(1).numpy()
    # K ~ Binomial(1e4, 0.2): mean 2000, sd 40
    assert w.shape[1] == D.design_pad_len(2000, "bernoulli")
    assert abs(sizes.mean() - 2000) < 4 * 40 / np.sqrt(120)
    assert 25 < sizes.std() < 55


def test_bernoulli_small_grid_exact_binomial_pmf():
    """At G = 16 the realized size follows the EXACT Binomial(16, 1/4),
    atom by atom, k = 0 included."""
    G, B, M = 16, 4, 20000
    p = B / G
    w = D.draw_pair_design_device(_gen(), 4, 4, B, "bernoulli",
                                  batch=(M,))[2]
    sizes = w.sum(1).numpy().astype(int)
    pmf = np.array([comb(G, k) * p**k * (1 - p) ** (G - k)
                    for k in range(G + 1)])
    counts = np.bincount(sizes, minlength=G + 1)
    big = pmf * M >= 5
    for k in np.where(big)[0]:
        se = np.sqrt(M * pmf[k] * (1 - pmf[k]))
        assert abs(counts[k] - M * pmf[k]) < 4.5 * se, k
    q_tail = pmf[~big].sum()
    se_t = np.sqrt(M * q_tail * (1 - q_tail))
    assert abs(counts[~big].sum() - M * q_tail) < 4.5 * se_t
    assert counts[0] > 0
    # floor_one (estimation) never realizes an empty design
    w1 = D.draw_pair_design_device(_gen(1), 4, 4, B, "bernoulli",
                                   floor_one=True, batch=(2000,))[2]
    assert float(w1.sum(1).min()) >= 1


def test_bernoulli_empty_realization_is_zero_weight_step():
    """An empty draw prices as 0 through sum(vals * w) / max(sum(w), 1),
    and a trainer at a tiny per-worker grid stays finite."""
    from tuplewise_tpu_torch.data import make_gaussians
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer

    i, j, w = D.draw_pair_design_device(_gen(), 4, 4, 4, "bernoulli",
                                        batch=(500,))
    empty = torch.nonzero(w.sum(1) == 0)
    assert len(empty) > 0, "no empty draw in 500 rows (p ~ 1 % a row)"
    vals = torch.ones_like(w)
    loss = (vals * w).sum(1) / w.sum(1).clamp_min(1.0)
    assert float(loss[empty[0, 0]]) == 0.0
    Xp, Xn = make_gaussians(32, 32, dim=3, separation=1.0, seed=0)
    scorer = LinearScorer(dim=3)
    cfg = TrainConfig(kernel="hinge", lr=0.2, steps=50, n_workers=8,
                      repartition_every=10, pairs_per_worker=4,
                      pair_design="bernoulli")
    params, hist = train_pairwise(scorer, scorer.init(0), Xp, Xn, cfg,
                                  device="cpu")
    assert np.isfinite(params["w"]).all() and np.isfinite(hist["loss"]).all()


def test_one_sample_off_diagonal_distinct():
    i, j, w = D.draw_pair_design_device(_gen(), 40, 39, 500, "swor",
                                        one_sample=True)
    assert not bool((i[w > 0] == j[w > 0]).any())
    assert len(_tuples(w, i, j)) == 500 and int(j.max()) < 40


def test_swr_matches_legacy_sampler():
    """swr repeats sample_pair_indices' draws (the budgeted learner's
    historical sequence) and the triplet learner's i, j, k sequence."""
    i0, j0 = sample_pair_indices(_gen(7), 64, 48, 256, False, batch=(3,))
    i1, j1, w = D.draw_pair_design_device(_gen(7), 64, 48, 256, "swr",
                                          batch=(3,))
    assert torch.equal(i0, i1) and torch.equal(j0, j1)
    assert float(w.sum()) == 3 * 256
    g = _gen(11)
    i0, j0 = sample_pair_indices(g, 32, 32, 64, True)
    k0 = torch.randint(0, 48, (64,), generator=g)
    i1, j1, k1, w = D.draw_triplet_design_device(_gen(11), 32, 48, 64, "swr")
    assert torch.equal(i0, i1) and torch.equal(j0, j1) and torch.equal(k0, k1)


@pytest.mark.parametrize("design", ["swr", "swor", "bernoulli"])
def test_per_row_generators_repeat_each_row(design):
    """The harness draws each rep's design from the rep's own generator:
    a rep's estimate is the same bit for bit whatever chunk asks for it
    (with its neighbours, in the middle of the run, alone), pair and
    triplet grids."""
    from tuplewise_tpu_torch.harness.variance import (
        VarianceConfig, batched_estimates,
    )

    for kernel, n1, n2 in (("auc", 30, 40), ("triplet_indicator", 12, 9)):
        cfg = VarianceConfig(kernel=kernel, scheme="incomplete", n_pos=n1,
                             n_neg=n2, dim=2, n_pairs=300, design=design,
                             n_reps=70, seed=3)
        full = batched_estimates(cfg, "cpu")
        for lo, hi in ((60, 70), (3, 4), (64, 66)):
            part = batched_estimates(cfg, "cpu", range(lo, hi))
            assert torch.equal(part, full[lo:hi]), (kernel, lo, hi)


@pytest.mark.parametrize("scheme", ["complete", "repartitioned",
                                    "incomplete"])
def test_a_chunk_draws_only_its_own_reps(monkeypatch, scheme):
    """A chunk of reps derives the generators of its reps and of no
    other rep, and draws from each only one rep's rows (so the chunk
    size bounds the draws' memory and time)."""
    from tuplewise_tpu_torch.harness import variance

    seen, real = [], variance.generator

    def spy(seed, purpose, *idx, **kw):
        seen.append((purpose, *idx))
        return real(seed, purpose, *idx, **kw)

    real_draw = variance._draw_data
    sizes = []

    def draw_spy(cfg, g, batch=()):
        sizes.append(batch)
        return real_draw(cfg, g, batch)

    monkeypatch.setattr(variance, "generator", spy)
    monkeypatch.setattr(variance, "_draw_data", draw_spy)
    cfg = variance.VarianceConfig(scheme=scheme, n_pos=40, n_neg=30,
                                  n_workers=4, n_rounds=3, n_pairs=50,
                                  n_reps=200, seed=5)
    part = variance.batched_estimates(cfg, "cpu", range(70, 73))
    assert seen == [("mc_rep", r) for r in (70, 71, 72)]
    assert sizes == [(1,)] * 3
    monkeypatch.setattr(variance, "generator", real)
    for r in (70, 71, 72):
        alone = variance.batched_estimates(cfg, "cpu", range(r, r + 1))
        assert torch.equal(alone, part[r - 70:r - 69])


def test_rejects_unknown_and_oversized():
    """The 0.8 G contract: floor(0.8 G) draws, one more raises."""
    with pytest.raises(ValueError, match="unknown sampling design"):
        D.draw_pair_design_device(_gen(), 8, 8, 4, "x")
    for design in ("swor", "bernoulli"):
        D.draw_pair_design_device(_gen(), 8, 8, 51, design)
        with pytest.raises(ValueError, match="distinct"):
            D.draw_pair_design_device(_gen(), 8, 8, 52, design)
        with pytest.raises(ValueError, match="distinct"):
            D.draw_triplet_design_device(_gen(), 4, 4, 39, design)


def test_triplet_swor_distinct_off_diagonal():
    i, j, k, w = D.draw_triplet_design_device(_gen(3), 20, 15, 900, "swor")
    assert float(w.sum()) == 900
    assert not bool((i == j).any())
    assert len(_tuples(w, i, j, k)) == 900
    assert int(k.max()) < 15 and int(i.max()) < 20 and int(j.max()) < 20


def test_triplet_grid_above_int64_draws_distinct():
    """n1 (n1 - 1) n2 > 2^63: the dedup never linearizes the grid."""
    n = (1 << 21) + 5
    assert n * (n - 1) * n > 2 ** 63
    for design in ("swor", "bernoulli"):
        i, j, k, w = D.draw_triplet_design_device(_gen(5), n, n, 2000,
                                                  design, floor_one=True)
        assert len(_tuples(w, i, j, k)) == int(w.sum())
        assert not bool((i == j).any())
        assert int(max(i.max(), j.max(), k.max())) < n
    # a repeated tuple in the overdraw is marked as one
    cols = [torch.tensor([[3, 1, 3, 3]]), torch.tensor([[2, 2, 2, 2]]),
            torch.tensor([[n, 0, n, n - 1]])]
    order = D._lex_order(cols)
    assert [c.gather(-1, order).tolist() for c in cols] == [
        [[1, 3, 3, 3]], [[2, 2, 2, 2]], [[0, n - 1, n, n]]]


@pytest.mark.parametrize("design", ["swr", "swor", "bernoulli"])
def test_conditional_variance_matches_exact_form(design):
    """On FIXED scores the weighted mean's variance over design redraws
    matches conditional_incomplete_variance (s^2 = U(1-U)); at B = G/2
    swor halves swr."""
    rng = np.random.default_rng(1)
    s1 = torch.as_tensor(rng.normal(size=100).astype(np.float32)) + 1.0
    s2 = torch.as_tensor(rng.normal(size=100).astype(np.float32))
    u = auc_score(s1.numpy(), s2.numpy())
    G, B, M = 100 * 100, 5_000, 800
    i, j, w = D.draw_pair_design_device(_gen(), 100, 100, B, design,
                                        floor_one=True, batch=(M,))
    vals = D.weighted_mean((s1[i] > s2[j]).float(), w).numpy()
    pred = conditional_incomplete_variance(u * (1 - u), G, n_pairs=B,
                                           design=design)
    assert abs(vals.var(ddof=1) - pred) / pred < 0.2
    assert abs(vals.mean() - u) < 5 * np.sqrt(pred / M)


@pytest.mark.parametrize("design", ["swr", "swor", "bernoulli"])
def test_triplet_conditional_variance_matches_exact_form(design):
    k = get_kernel("triplet_indicator")
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.normal(size=(24, 3)).astype(np.float32))
    Y = torch.as_tensor(rng.normal(size=(20, 3)).astype(np.float32) + 0.4)
    s, c = triplet_stats(k, X, Y, tile=8)
    u = float(s) / float(c)
    G, B, M = 24 * 23 * 20, 5_000, 600
    i, j, n, w = D.draw_triplet_design_device(_gen(), 24, 20, B, design,
                                              floor_one=True, batch=(M,))
    vals = D.weighted_mean(k.triplet_values(X[i], X[j], Y[n]), w).numpy()
    pred = conditional_incomplete_variance(u * (1 - u), G, n_pairs=B,
                                           design=design)
    assert abs(vals.var(ddof=1) - pred) / pred < 0.25
    assert abs(vals.mean() - u) < 5 * np.sqrt(pred / M)


@pytest.mark.parametrize("design", ["swor", "bernoulli"])
def test_inclusion_counts_match_host_and_jax(design):
    """20 x 20 grid, B = 100, M = 400 draws: the per-cell inclusion
    counts of the port's device sampler, of its host oracle and of the
    JAX device sampler are each within 5 sd of Binomial(M, B/G) (about
    the empirical mean, since bernoulli's size varies), and each total
    within 5 sd of M B."""
    n1 = n2 = 20
    B, M = 100, 400
    p_cell = B / (n1 * n2)
    i, j, w = D.draw_pair_design_device(_gen(), n1, n2, B, design,
                                        batch=(M,))
    port = np.zeros((n1, n2))
    np.add.at(port, (i[w > 0].numpy(), j[w > 0].numpy()), 1)
    host = np.zeros((n1, n2))
    for t in range(M):
        ih, jh = draw_pair_design(np.random.default_rng(t), n1, n2, B, design)
        host[ih, jh] += 1
    f = jax.jit(jax.vmap(lambda kk: j_pair_design(kk, n1, n2, B, design)))
    ij, jj, wj = (np.asarray(x) for x in f(
        jax.vmap(jax.random.PRNGKey)(jnp.arange(M))))
    ref = np.zeros((n1, n2))
    np.add.at(ref, (ij[wj > 0], jj[wj > 0]), 1)
    sd = np.sqrt(M * p_cell * (1 - p_cell))
    for name, counts in (("port", port), ("host", host), ("jax", ref)):
        z = (counts - counts.mean()) / sd
        assert np.max(np.abs(z)) < 5.0, (name, np.max(np.abs(z)))
        tot_sd = np.sqrt(M * B * (1 - p_cell))
        assert abs(counts.sum() - M * B) < 5 * tot_sd, name


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["swr", "swor", "bernoulli"])
def test_draws_on_the_card_never_sync(design):
    """On the card the draws stop the host nowhere (sync debug mode
    "error" raises on a synchronizing call): config 3's pair grid at
    batch 64, a small grid, one-sample and a triplet grid; swor
    rows stay distinct and exactly B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = generator(0, "design", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        i, j, w = D.draw_pair_design_device(g, 10**6, 10**6, 10**4, design,
                                            batch=(64,))
        D.draw_pair_design_device(g, 100, 100, 5000, design,
                                  floor_one=True, batch=(8,))
        D.draw_pair_design_device(g, 1000, 999, 5000, design,
                                  one_sample=True, batch=(8,))
        D.draw_triplet_design_device(g, 32768, 32768, 20000, design,
                                     batch=(4,))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if design == "swor":
        assert bool((w.sum(1) == 10**4).all())
        code = (i * 10**6 + j).cpu()
        assert all(len(torch.unique(code[r])) == 10**4 for r in range(64))
