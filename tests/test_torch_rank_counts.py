"""The bodies that run sort-and-count kernels on the card
(``csrc/rank_count.cu`` via ``ops.rank_count``): the auc body of
``pair_sum`` (kernel 1) and the indicator combine of
``batched_masked_pair_sum`` (kernel 5), held against the JAX package on
the inputs where a rank count can go wrong.

On the CPU both wrappers run their plain versions, which the CUDA
kernels must equal on the card (the ``cuda``-marked tests, which skip
here). The JAX Pallas kernels run in interpret mode at small tiles, as
``tests/test_pallas_and_rank.py`` runs them. Every sum compared here is
an exact multiple of 0.5 or an integer, so the packages must agree
exactly: auc terms are 0, 0.5 or 1; the indicator runs on points with
small integer coordinates, whose float32 distances are exact integers in
both packages (and tie often). The edge values held against JAX leave
out subnormals: XLA on the CPU flushes a subnormal difference to zero,
where the port (and IEEE float32) keeps it; a port-only test pins that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops import pallas_pairs as jp
from tuplewise_tpu.ops.pallas_triplets import pallas_triplet_stats
from tuplewise_tpu.ops.rank_auc import rank_auc as j_rank_auc
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.ops import rank_count
from tuplewise_tpu_torch.ops import triplet_kernels as tk
from tuplewise_tpu_torch.ops.kernels import get_kernel
from tuplewise_tpu_torch.ops.rank_auc import rank_auc

INF, NAN = np.float32(np.inf), np.float32(np.nan)
EDGE_VALUES = np.array([INF, -INF, NAN, -NAN, 0.0, -0.0, 1.0, -1.0],
                       dtype=np.float32)
SUBNORMALS = np.array([1e-45, -1e-45], dtype=np.float32)


def edge_scores(rng, n, frac=0.3):
    """Normal scores with a fraction drawn from EDGE_VALUES (+-inf, NaN
    of both signs, +-0.0), a fifth rounded to integers."""
    x = rng.normal(size=n).astype(np.float32)
    pick = rng.random(n) < frac
    x[pick] = rng.choice(EDGE_VALUES, pick.sum())
    tie = rng.random(n) < 0.2
    x[tie] = np.round(x[tie])
    return x


def _cases():
    rng = np.random.default_rng(11)
    out = {
        "pm_inf_both": (np.array([INF, -INF, 0.5, 2.0], np.float32),
                        np.array([-INF, INF, 1.0], np.float32)),
        "equal_infinities": (np.array([INF, INF, -INF, 1.0], np.float32),
                             np.array([INF, -INF, -INF, 0.0], np.float32)),
        "nan_in_a": (np.array([NAN, -NAN, 0.3, 1.0], np.float32),
                     rng.normal(size=9).astype(np.float32)),
        "nan_in_b": (rng.normal(size=9).astype(np.float32),
                     np.array([NAN, 0.1, -NAN, -1.0], np.float32)),
        "neg_zero": (np.array([-0.0, 0.0, -0.0, 1.0], np.float32),
                     np.array([0.0, -0.0, -1.0], np.float32)),
        "heavy_ties": (np.round(rng.normal(size=200) * 2).astype(np.float32),
                       np.round(rng.normal(size=300) * 2).astype(np.float32)),
        "one_by_one": (np.array([1.0], np.float32),
                       np.array([1.0], np.float32)),
    }
    for n1, n2 in [(1, 7), (33, 1), (300, 517)]:
        out[f"edge_{n1}x{n2}"] = (edge_scores(rng, n1), edge_scores(rng, n2))
    return out


CASES = _cases()


def _pallas_auc(a, b):
    return float(jp.pallas_pair_sum_any(
        jnp.asarray(a), jnp.asarray(b), kernel=jk.get_kernel("auc"),
        tile_a=256, tile_b=512, interpret=True))


@pytest.mark.parametrize("case", sorted(CASES))
def test_auc_pair_sum_equals_pallas_on_edge_values(case):
    a, b = CASES[case]
    got = pk.pair_sum(torch.from_numpy(a), torch.from_numpy(b),
                      get_kernel("auc"))
    assert got.dtype == torch.float64
    assert float(got) == _pallas_auc(a, b), case


def test_auc_pair_sum_batches_equal_pallas_per_problem():
    rng = np.random.default_rng(12)
    a = np.stack([edge_scores(rng, 57) for _ in range(3)])
    b = np.stack([edge_scores(rng, 130) for _ in range(3)])
    got = pk.pair_sum(torch.from_numpy(a), torch.from_numpy(b),
                      get_kernel("auc"))
    assert got.shape == (3,)
    assert got.tolist() == [_pallas_auc(a[w], b[w]) for w in range(3)]


def test_rank_form_differs_on_equal_infinities():
    """The rank form counts equal infinities as ties; the body scores
    their NaN difference 0. Why the kernel searches with the body's
    predicate and not with raw comparisons."""
    a = np.array([INF, 1.0], np.float32)
    b = np.array([INF, 0.0], np.float32)
    want = 2.0           # (inf, inf) -> 0, (inf, 0) -> 1, (1, inf) -> 0, (1, 0) -> 1
    assert float(pk.pair_sum(torch.from_numpy(a), torch.from_numpy(b),
                             get_kernel("auc"))) == want
    assert _pallas_auc(a, b) == want
    port_rank = float(rank_auc(torch.from_numpy(a), torch.from_numpy(b))) * 4
    jax_rank = float(j_rank_auc(jnp.asarray(a), jnp.asarray(b))) * 4
    assert port_rank == jax_rank == 2.5
    a, b = CASES["edge_300x517"]
    exact = float(pk.pair_sum(torch.from_numpy(a), torch.from_numpy(b),
                              get_kernel("auc")))
    ranked = float(rank_auc(torch.from_numpy(a), torch.from_numpy(b)))
    assert ranked * a.size * b.size != exact == _pallas_auc(a, b)


def test_subnormal_differences_keep_gradual_underflow():
    """fl(1e-45 - -1e-45) is a subnormal, not 0: a win, not a tie (the
    kernels are built without fast-math for this). XLA on the CPU flushes
    it to 0 and scores a tie: the one place the port departs from the JAX
    package on the CPU, by keeping IEEE float32."""
    a, b = SUBNORMALS[:1], SUBNORMALS[1:]
    assert float(np.float32(a[0] - b[0])) > 0
    assert float(pk.pair_sum(torch.from_numpy(a), torch.from_numpy(b),
                             get_kernel("auc"))) == 1.0
    assert float(pk.pair_sum(torch.from_numpy(b), torch.from_numpy(b),
                             get_kernel("auc"))) == 0.5
    assert _pallas_auc(a, b) == 0.5


def test_cpu_tensors_take_the_plain_version():
    pk.reset_launch_counts()
    a, b = (torch.from_numpy(x) for x in CASES["heavy_ties"])
    got = pk.pair_sum(a, b, get_kernel("auc"))
    assert float(got) == float(pk.pair_sum_plain(a, b, get_kernel("auc")))
    comb = tk.triplet_combine_kernel(get_kernel("triplet_indicator"))
    A, B = a[None, :50].contiguous(), b[None, :70].contiguous()
    tk.batched_masked_pair_sum(A, B, torch.ones(1, 50),
                               torch.arange(50)[None], torch.tensor([3]),
                               torch.ones(1, 70), comb)
    assert sum(pk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("n, tile", [(1, 2048), (2048, 2048), (2049, 4096),
                                     (5000, 8192), (8193, 16384),
                                     (10 ** 6, 16384)])
def test_tile_size(n, tile):
    assert rank_count.tile_size(n) == tile


def _lattice(rng, n, d=3, lo=-2, hi=3):
    """Points with small integer coordinates: exact float32 distances in
    both packages, and many exact ties between them."""
    return rng.integers(lo, hi, size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_indicator_statistic_equals_pallas_on_ties(seed):
    rng = np.random.default_rng(seed)
    X = _lattice(rng, 40)
    X[20:30] = X[:10]                              # duplicated points
    Y = _lattice(rng, 35)
    Y[:8] = X[:8]                                  # negatives on positives
    mx = (rng.random(40) > 0.2).astype(np.float32)
    my = (rng.random(35) > 0.25).astype(np.float32)
    ids = (np.arange(40) % 17).astype(np.int32)    # colliding ids
    kw = dict(mask_x=mx, mask_y=my, ids_x=ids)
    sp, cp = pallas_triplet_stats(
        jk.get_kernel("triplet_indicator"), jnp.asarray(X), jnp.asarray(Y),
        anchor_chunk=16, tile_p=8, tile_k=128, interpret=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    s, c = tk.factorized_triplet_stats(
        get_kernel("triplet_indicator"), torch.from_numpy(X),
        torch.from_numpy(Y), **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert int(c) == int(cp)
    assert float(s) == float(sp)
    # the strict < is exercised: ties between d(a, p) and d(a, n) exist
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    d_pa, d_an = tk.sqdist_matrix(Xt, Xt), tk.sqdist_matrix(Xt, Yt)
    assert bool((d_pa[:, :, None] == d_an[:, None, :]).any())


def test_indicator_plain_on_edge_distances_counts_by_predicate():
    """The plain version on distances with NaN, +-inf and ties: a NaN or
    equal-infinity difference never counts, exactly as the kernel's
    search treats them."""
    comb = tk.triplet_combine_kernel(get_kernel("triplet_indicator"))
    A = torch.tensor([[INF, 1.0, NAN, -INF, 2.0]])
    B = torch.tensor([[INF, 1.0, 3.0, NAN, -INF]])
    got = tk.batched_masked_pair_sum(
        A, B, torch.ones(1, 5), torch.arange(5)[None], torch.tensor([9]),
        torch.ones(1, 5), comb)
    # A < B strictly, NaN and inf - inf never: inf: 0; 1.0: {3.0, inf};
    # NaN: 0; -inf: {1.0, 3.0, inf}; 2.0: {3.0, inf}
    assert got.tolist() == [7.0]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sort-and-count kernels have "
                    "no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _edge_on_card(gen, *shape):
    x = torch.randn(*shape, generator=gen, device="cuda")
    pool = torch.from_numpy(np.concatenate([EDGE_VALUES, SUBNORMALS])).cuda()
    at = torch.randint(0, len(pool), shape, generator=gen, device="cuda")
    x = torch.where(torch.rand(*shape, generator=gen, device="cuda") < 0.3,
                    pool[at], x)
    return torch.where(torch.rand(*shape, generator=gen, device="cuda") < 0.2,
                       x.round(), x)


@pytest.mark.cuda
def test_rank_auc_kernel_matches_plain_on_card(card):
    auc = get_kernel("auc")
    for W, n1, n2 in [(1, 1, 1), (3, 300, 517), (2, 20000, 17),
                      (2, 9000, 40000)]:
        a, b = _edge_on_card(card, W, n1), _edge_on_card(card, W, n2)
        pk.reset_launch_counts()
        got = pk.pair_sum(a, b, auc)
        assert pk.LAUNCHES["pair_sum[auc]"] == 1
        assert torch.equal(got, pk.pair_sum(a, b, auc, impl="plain"))
        got1 = pk.pair_sum(a[0], b[0], auc)
        assert got1.shape == () and float(got1) == float(got[0])


@pytest.mark.cuda
def test_rank_indicator_kernel_matches_plain_on_card(card):
    for margin in (0.0, 0.5):
        comb = tk.TripletCombine("indicator", margin)
        for C, G, P, K, frac in [(1, 1, 1, 1, False), (3, 2, 300, 517, False),
                                 (2, 2, 40, 20000, True)]:
            W = C * G
            A = _edge_on_card(card, W, P) + 3.0
            B = _edge_on_card(card, W, K) + 3.0
            B[:, :5] = A[:, :5]
            mp = (torch.rand(G, P, generator=card, device="cuda") > 0.3).float()
            mk = (torch.rand(G, K, generator=card, device="cuda") > 0.3).float()
            if frac:
                mp = mp * torch.rand(G, P, generator=card, device="cuda")
                mk = mk * torch.rand(G, K, generator=card, device="cuda")
            ip = (torch.arange(G * P, device="cuda") % 7).reshape(G, P)
            ia = torch.arange(W, device="cuda") % 5
            pk.reset_launch_counts()
            got = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C)
            assert pk.LAUNCHES[f"batched_masked_pair_sum[{comb.name}]"] == 1
            want = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C,
                                              impl="plain")
            if frac:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
            else:
                assert torch.equal(got, want)
