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

Kernel 1's auc merge route (both classes sorted whole, counted by merge)
is modelled here stage by stage as its kernels run it, at small blocks,
and held to the plain body with subnormals; ``auc_route``'s crossover is
pinned on both sides.
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


# --------------------------------------------------------------------- #
# kernel 1's auc merge route (csrc/rank_count.cu merge_runs_kernel,      #
# auc_merge_count_kernel), modelled on the CPU                           #
# --------------------------------------------------------------------- #

NAN_KEY, POS_INF_KEY, NEG_INF_KEY = 0xFFFFFFFF, 0xFF800000, 0x007FFFFF


def float_keys(x):
    """float_key of the source: the order-preserving uint32 key of each
    float32, -0.0 keyed as +0.0 and every NaN as NAN_KEY."""
    x = np.asarray(x, dtype=np.float32)
    u = x.view(np.uint32).copy()
    u[u == 0x80000000] = 0
    k = np.where(u >> 31, ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    k[np.isnan(x)] = NAN_KEY
    return k


def merge_count(a, b):
    """Stage 3 by searchsorted of the keys: the sum over a_i not NaN of
    #{b < a_i} + #{b <= a_i}, less the pairs of equal infinities."""
    ka, kb = float_keys(a), np.sort(float_keys(b))
    ka = ka[ka != NAN_KEY]
    lo = np.searchsorted(kb, ka, "left").sum()
    hi = np.searchsorted(kb, ka, "right").sum()
    inf_pairs = sum(int((ka == k).sum()) * int((kb == k).sum())
                    for k in (POS_INF_KEY, NEG_INF_KEY))
    return int(lo) + int(hi) - inf_pairs


def _plain_auc(a, b):
    return float(pk.pair_sum_plain(torch.from_numpy(a), torch.from_numpy(b),
                                   get_kernel("auc")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_count_equals_the_plain_body(case):
    a, b = CASES[case]
    assert 0.5 * merge_count(a, b) == _plain_auc(a, b), case


def _edge_draw(rng, n):
    """edge_scores with subnormals among the edge values (the port keeps
    gradual underflow on the CPU too)."""
    x = edge_scores(rng, n)
    pick = rng.random(n) < 0.05
    x[pick] = rng.choice(SUBNORMALS, pick.sum())
    return x


@pytest.mark.parametrize("seed", range(4))
def test_merge_count_equals_the_plain_body_on_edge_draws(seed):
    rng = np.random.default_rng(100 + seed)
    a, b = _edge_draw(rng, 700), _edge_draw(rng, 1100)
    assert 0.5 * merge_count(a, b) == _plain_auc(a, b)
    assert 0.5 * merge_count(b, a) == _plain_auc(b, a)


def warp_search(lo, hi, pred):
    """The source's warp_search: 32 probes a round, side by side; the
    first p in [lo, hi] where pred (true, then false) is false."""
    while lo < hi:
        at = [lo + (hi - lo) * (lane + 1) // 33 for lane in range(32)]
        holds = [bool(pred(x)) for x in at]
        assert holds == sorted(holds, reverse=True)    # a prefix of lanes
        t = sum(holds)
        if t > 0:
            lo = at[t - 1] + 1
        if t < 32:
            hi = at[t]
    return lo


def merge_split(A, la, B, lb, d):
    """The source's merge_split: A's keys among the first d of the merge,
    A's first among equal keys (a binary search)."""
    lo, hi = max(0, d - lb), min(d, la)
    while lo < hi:
        mid = (lo + hi) >> 1
        if A[mid] <= B[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def warp_merge_split(A, la, B, lb, d):
    return warp_search(max(0, d - lb), min(d, la),
                       lambda k: A[k] <= B[d - 1 - k])


def load_merge_part(A, la, B, lb, d0, d1):
    """The source's load_merge_part: (i0, j0, na, nb, s)."""
    i0, i1 = warp_merge_split(A, la, B, lb, d0), \
        warp_merge_split(A, la, B, lb, d1)
    j0 = d0 - i0
    s = np.concatenate([A[i0:i1], B[j0:d1 - i1]])
    return i0, j0, i1 - i0, (d1 - d0) - (i1 - i0), s


def merge_runs(src, run, block, items):
    """merge_runs_kernel on one sequence of keys, block by block and
    thread by thread: runs of `run` sorted keys into runs of 2 run."""
    n = len(src)
    dst = np.empty_like(src)
    for p0 in range(0, n, block):
        base = p0 // (2 * run) * (2 * run)
        la = min(run, n - base)
        lb = min(run, n - base - la)
        A, B = src[base:base + la], src[base + la:base + la + lb]
        d0 = p0 - base
        d1 = min(d0 + block, la + lb)
        _, _, na, nb, s = load_merge_part(A, la, B, lb, d0, d1)
        for t0 in range(0, na + nb, items):
            i = merge_split(s[:na], na, s[na:], nb, t0)
            j = t0 - i
            for k in range(min(items, na + nb - t0)):
                take_a = j >= nb or (i < na and s[i] <= s[na + j])
                dst[p0 + t0 + k] = s[i] if take_a else s[na + j]
                i, j = (i + 1, j) if take_a else (i, j + 1)
    return dst


def sort_whole(keys, tile, block, items):
    """Stages 1-2: tiles sorted, then merge passes until one run."""
    out = np.concatenate([np.sort(keys[c:c + tile])
                          for c in range(0, len(keys), tile)])
    run, passes = tile, 0
    while run < len(keys):
        out, run, passes = merge_runs(out, run, block, items), 2 * run, \
            passes + 1
    assert passes == max(0, (-(-len(keys) // tile) - 1).bit_length())
    return out


def gallop_upper(B, j, end, v):
    """The source's gallop_upper: the first p in [j, end] with p == end
    or B[p] > v, every key before j at most v."""
    step, hi = 1, j
    while hi < end and B[hi] <= v:
        j = hi + 1
        hi = j + step if end - j > step else end
        step <<= 1
    while j < hi:
        mid = (j + hi) >> 1
        if B[mid] <= v:
            j = mid + 1
        else:
            hi = mid
    return j


def merge_count_walk(A, B, block, items):
    """auc_merge_count_kernel over sorted keys A, B: the merge path of A
    against B (A's keys first among equal ones) in parts of `block`
    diagonals, each thread walking `items` of them; lo is the merge's
    count of B so far, hi lo or a gallop over B's run of v; then block
    0's correction for equal infinities from six warp searches."""
    n1, n2 = len(A), len(B)
    acc = 0
    for d0 in range(0, n1 + n2, block):
        d1 = min(d0 + block, n1 + n2)
        _, j0, na, nb, s = load_merge_part(A, n1, B, n2, d0, d1)
        for t0 in range(0, na + nb, items):
            i = merge_split(s[:na], na, s[na:], nb, t0)
            j = t0 - i
            last, last_hi = NAN_KEY, 0
            for _ in range(min(items, na + nb - t0)):
                if not (j >= nb or (i < na and s[i] <= s[na + j])):
                    j += 1
                    continue
                v = s[i]
                i += 1
                if v == NAN_KEY:
                    continue
                lo = j0 + j
                if v != last:
                    nxt = s[na + j] if j < nb else (B[lo] if lo < n2
                                                    else NAN_KEY)
                    last_hi = gallop_upper(B, lo, n2, v) if nxt == v else lo
                    last = v
                acc += lo + last_hi
    ends = [warp_search(0, len(K), (lambda k, K=K, v=v: K[k] <= v) if upper
                        else (lambda k, K=K, v=v: K[k] < v))
            for K in (A, B)
            for v, upper in ((NAN_KEY, False), (POS_INF_KEY, False),
                             (NEG_INF_KEY, True))]
    return acc - ((ends[0] - ends[1]) * (ends[3] - ends[4])
                  + ends[2] * ends[5])


def _gapped(rng, n, lo, hi):
    """Scores in separated bands: long stretches of one class's sorted
    keys with none of the other's between them."""
    return (rng.integers(lo, hi, n) * 100.0
            + rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("n1, n2, kind, seed", [
    (700, 1100, "edge", 0), (1100, 300, "edge", 1), (257, 2049, "edge", 2),
    (900, 900, "ties", 3), (600, 1500, "gaps", 4), (500, 500, "equal", 5)])
def test_merge_route_model_equals_the_plain_body(n1, n2, kind, seed):
    """The merge route's stages 2-3 as the kernels run them, at small
    blocks (tiles of 64, merge and count blocks of 32 keys, 4 a
    thread): the keys come out sorted, and the count is the plain body's
    twice."""
    rng = np.random.default_rng(seed)
    if kind == "edge":
        a, b = _edge_draw(rng, n1), _edge_draw(rng, n2)
    elif kind == "ties":
        a = np.round(rng.normal(size=n1) * 2).astype(np.float32)
        b = np.round(rng.normal(size=n2) * 2).astype(np.float32)
        a[:20], b[:30] = np.inf, np.inf
        a[20:25], b[30:50] = -np.inf, -np.inf
    elif kind == "gaps":
        a, b = _gapped(rng, n1, 0, 3), _gapped(rng, n2, 2, 6)
    else:
        a = b = np.full(n1, 1.5, np.float32)
    A, B = (sort_whole(float_keys(x), 64, 32, 4) for x in (a, b))
    assert np.array_equal(A, np.sort(float_keys(a)))
    assert np.array_equal(B, np.sort(float_keys(b)))
    got = merge_count_walk(A, B, 32, 4)
    assert got == merge_count(a, b)
    assert 0.5 * got == _plain_auc(a, b)


@pytest.mark.parametrize("n1, n2, route", [
    (10 ** 6, 1, "search"), (10 ** 6, 16384, "search"),
    (10 ** 7, 16385, "search"), (8, 10 ** 7, "search"),
    (70000, 140000, "search"), (560000, 140000, "search"),
    (262144, 262144, "search"), (327680, 327680, "merge"),
    (1 << 20, 1 << 20, "merge"), (1250000, 1250000, "merge"),
    (2160000, 540000, "merge"), (200000, 10 ** 7, "merge")])
def test_auc_route(n1, n2, route):
    assert rank_count.auc_route(n1, n2) == route


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


def _merge_inputs(gen, W, n1, n2):
    """Edge draws (+-inf, NaN of both signs, +-0.0, subnormals, integer
    ties) with more infinities on both sides and ties across b's tiles:
    a few values of b's first tile copied into its later tiles and into
    a."""
    a, b = _edge_on_card(gen, W, n1), _edge_on_card(gen, W, n2)
    inf = float("inf")
    a[:, ::97], b[:, ::89] = inf, inf
    a[:, 5::101], b[:, 7::83] = -inf, -inf
    src = b[:, 1:9].clone()
    for col in range(rank_count.MAX_TILE + 3, n2, rank_count.MAX_TILE):
        b[:, col:col + 8] = src[:, :n2 - col]
    a[:, 11:19] = src[:, :min(8, n1 - 11)]
    return a.contiguous(), b.contiguous()


def _route_on_card(gen, W, n1, n2, route):
    """pair_sum's auc on _merge_inputs, by the route the counter shows,
    equal to the plain version."""
    from tuplewise_tpu_torch.obs.tracing import COUNTS

    a, b = _merge_inputs(gen, W, n1, n2)
    auc = get_kernel("auc")
    before = COUNTS[f"auc_route[{route}]"]
    got = pk.pair_sum(a, b, auc)
    assert COUNTS[f"auc_route[{route}]"] == before + 1
    assert torch.equal(got, pk.pair_sum(a, b, auc, impl="plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("W, n1, n2", [
    (8, 330000, 330000),             # 21 tiles of b, 5 merge passes
    (1, 1 << 20, 1 << 20),
    (3, 600000, 20 * 16384 + 1000),  # a padded last tile
    (2, 1200000, 200000),            # n1 > n2
])
def test_auc_merge_route_matches_plain_on_card(card, W, n1, n2):
    _route_on_card(card, W, n1, n2, "merge")


@pytest.mark.cuda
@pytest.mark.parametrize("n, route", [(262144, "search"),
                                      (327680, "merge")])
def test_auc_route_at_the_crossover_on_card(card, n, route):
    """One shape on each side of auc_route's crossover: 16 and 20 tiles
    of b, 8 and 10 tile searches a key."""
    assert rank_count.auc_route(n, n) == route
    _route_on_card(card, 1, n, n, route)
