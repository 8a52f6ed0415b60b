"""The arithmetic of two CUDA kernel designs, emulated on the CPU and held
against the JAX package (and, on non-finite inputs, against the port's
plain versions, which follow the JAX bodies).

* Kernel 5's hinge route (``csrc/rank_count.cu`` ``hinge_kernel``): per
  anchor and tile of negatives, sort (distance, weight) pairs, form the
  float64 prefix sums of weight and of weight x distance, find each
  positive's prefix with the body's own float32 predicate
  fl(margin + fl(A - B)) > 0, and take (margin + A) * W - S; non-finite
  distances by the tile flags of rule 4 of the source's note.
* Kernel 1's logistic body (``csrc/pair_sum.cu`` ``logistic_sum_kernel``):
  per block of a row tile and a column tile, e^{-|d|} as the smaller of
  two products of per-score exponentials about a centre c when the
  block's scores are finite and span at most ``LOGISTIC_SPAN``, else
  expf(-|d|) per pair; log1p as s * P(s^2), s = x / (2 + x), with the
  kernel's coefficients ``LOG1P_COEFFS`` (checked against the built
  library when it loads).

The emulations run in the kernels' float32 (and float64) arithmetic; the
division of the log1p is correctly rounded here and a one-ulp reciprocal
on the card. Tolerance: rel 1e-5 of the JAX sums, the contract of the
kernels against their plain versions.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops import pallas_pairs as jp
from tuplewise_tpu.ops.pallas_triplets import (
    _batched_masked_pair_sum, _combine_kernel,
)
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.ops import rank_count
from tuplewise_tpu_torch.ops import triplet_kernels as tk
from tuplewise_tpu_torch.ops.kernels import get_kernel

INF, NAN = float("inf"), float("nan")
F32 = torch.float32
F64 = torch.float64


# --------------------------------------------------------------------- #
# kernel 5's hinge route                                                  #
# --------------------------------------------------------------------- #

def hinge_route(A, B, mp, ip, ia, mk, margin, C, tile):
    """Emulation of hinge_kernel: [W] float64 sums of max(0, margin +
    A[w,j] - B[w,k]) * mp[q,j] * 1{ip[q,j] != ia[w]} * mk[q,k], q = w // C,
    tile by tile of B. Also asserts that the predicate holds on a prefix
    of every sorted tile, which is what the kernel's binary search
    needs."""
    W, P = A.shape
    K = B.shape[1]
    m32 = torch.tensor(margin, dtype=F32)
    out = torch.zeros(W, dtype=F64)
    for w in range(W):
        q = w // C
        x = A[w]
        wj = torch.where(ip[q] != ia[w], mp[q], torch.zeros((), dtype=F32))
        for t0 in range(0, K, tile):
            b, m = B[w, t0:t0 + tile], mk[q, t0:t0 + tile]
            nan_b = bool(b.isnan().any())
            posinf_b = bool((b == INF).any())
            neginf_b = bool((b == -INF).any())
            # the signs of the finite and -inf values' weights (x = +inf)
            down = ~b.isnan() & (b != INF)
            zero_w = bool((down & ~((m < 0) | (m > 0))).any())
            neg_w = bool((down & (m < 0)).any())
            pos_w = bool((down & (m > 0)).any())
            # keys: -0.0 as +0.0, NaN to the top as a +inf slot
            v = torch.where(b.isnan(), torch.tensor(INF), b + 0.0)
            order = torch.argsort(v, stable=True)
            v, wt = v[order], m[order].clone()
            wt[v == INF] = 0.0
            zero = torch.zeros(1, dtype=F64)
            term = torch.where((wt == 0) & (v != -INF), zero,
                               wt.to(F64) * v.to(F64))
            Wp = torch.cat([zero, torch.cumsum(wt.to(F64), 0)])
            Sp = torch.cat([zero, torch.cumsum(term, 0)])
            holds = (m32 + (x[:, None] - v[None, :])) > 0
            c = holds.sum(1)
            prefix = torch.arange(len(v))[None, :] < c[:, None]
            assert torch.equal(holds, prefix), "predicate is not a prefix"
            inner = (margin + x.to(F64)) * Wp[c] - Sp[c]
            up_inf = (NAN if posinf_b or zero_w or (neg_w and pos_w)
                      else -INF if neg_w else INF)
            inner = torch.where(x == INF, up_inf, inner)
            inner = torch.where(x == -INF, NAN if neginf_b else 0.0, inner)
            inner = torch.where(x.isnan(), NAN, inner)
            part = (wj.to(F64) * inner).sum()
            out[w] += NAN if nan_b else part
    return out


def _jax_hinge_sums(A, B, mp, ip, ia, mk, margin, C):
    """The JAX Pallas kernel (interpret mode) per group: [W] float32
    per-anchor sums."""
    comb = _combine_kernel(jk.get_kernel("triplet_hinge").triplet_fn,
                           float(margin), False)
    W, P = A.shape
    K = B.shape[1]
    tp, tkk = 8, 128
    Pp, Kp = -(-P // tp) * tp, -(-K // tkk) * tkk
    out = []
    for q in range(W // C):
        rows = slice(q * C, (q + 1) * C)
        dpaT = np.zeros((Pp, C), np.float32)
        dpaT[:P] = A[rows].T
        dan = np.zeros((C, Kp), np.float32)
        dan[:, :K] = B[rows]
        mjT = np.zeros((Pp, C), np.float32)
        mjT[:P] = mp[q][:, None] * (ip[q][:, None] != ia[rows][None, :])
        mkp = np.zeros(Kp, np.float32)
        mkp[:K] = mk[q]
        out.append(np.asarray(_batched_masked_pair_sum(
            jnp.asarray(dpaT), jnp.asarray(dan), jnp.asarray(mjT),
            jnp.asarray(mkp), combine=comb, tile_p=tp, tile_k=tkk,
            interpret=True)))
    return np.concatenate(out).astype(np.float64)


def _hinge_inputs(rng, G, C, P, K, frac, lattice):
    W = G * C
    if lattice:
        # small integers: exact float32 distances and many ties, also
        # ties at the predicate's boundary margin + A - B = 0
        A = rng.integers(0, 12, (W, P)).astype(np.float32)
        B = rng.integers(0, 12, (W, K)).astype(np.float32)
        B[:, :3] = A[:, :3]
    else:
        A = (rng.gamma(4.0, 2.0, (W, P))).astype(np.float32)
        B = (rng.gamma(4.0, 2.0, (W, K)) + 0.5).astype(np.float32)
    mp = (rng.random((G, P)) > 0.2).astype(np.float32)
    mk = (rng.random((G, K)) > 0.25).astype(np.float32)
    if frac:
        mp *= rng.random((G, P)).astype(np.float32)
        mk *= rng.random((G, K)).astype(np.float32)
    ip = (np.arange(G * P) % 11).reshape(G, P).astype(np.int64)
    ia = (np.arange(W) % 7).astype(np.int64)        # colliding ids
    return A, B, mp, ip, ia, mk


@pytest.mark.parametrize("margin", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("G,C,P,K,tile,frac,lattice", [
    (1, 6, 40, 300, 2048, False, True),      # one group, one tile
    (3, 4, 25, 300, 128, True, True),        # several groups and tiles
    (2, 5, 33, 257, 64, True, False),        # ragged last tile
    (1, 3, 17, 130, 2048, False, False),
])
def test_hinge_route_matches_jax(margin, G, C, P, K, tile, frac, lattice):
    rng = np.random.default_rng(P * 100 + K + int(10 * margin))
    A, B, mp, ip, ia, mk = _hinge_inputs(rng, G, C, P, K, frac, lattice)
    got = hinge_route(*(torch.from_numpy(t) for t in (A, B, mp, ip, ia, mk)),
                      margin, C, tile)
    want = _jax_hinge_sums(A, B, mp, ip, ia, mk, margin, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the port's plain version sees the same float32 terms
    comb = tk.TripletCombine("hinge", margin)
    plain = tk.batched_masked_pair_sum(
        *(torch.from_numpy(t) for t in (A, B, mp, ip, ia, mk)), comb, C)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def _edge(rng, shape):
    """Distances with +-inf, NaN of both signs, +-0.0, subnormals and
    ties drawn in."""
    x = (rng.gamma(3.0, 1.5, shape)).astype(np.float32)
    pool = np.array([INF, -INF, NAN, -NAN, 0.0, -0.0, 1.0, 2.0, 1e-45,
                     -1e-45], np.float32)
    pick = rng.random(shape) < 0.08
    x[pick] = rng.choice(pool, pick.sum())
    return x


def _same_nonfinite(got, want, rtol):
    got, want = got.numpy(), want.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=1e-30)


@pytest.mark.parametrize("margin", [0.0, 0.5])
@pytest.mark.parametrize("seed,G,C,P,K,tile,frac", [
    (0, 1, 40, 12, 20, 2048, False),
    (1, 2, 30, 9, 40, 16, True),
    (2, 3, 25, 6, 7, 4, False),
])
def test_hinge_route_nonfinite_rules_match_plain(margin, seed, G, C, P, K,
                                                 tile, frac):
    """Rule 4 of the source's note: NaN positions equal the plain
    version's, infinities equal, finite sums within rel 1e-5."""
    rng = np.random.default_rng(seed)
    W = G * C
    A, B = _edge(rng, (W, P)), _edge(rng, (W, K))
    mp = (rng.random((G, P)) > 0.3).astype(np.float32)
    mk = (rng.random((G, K)) > 0.3).astype(np.float32)
    if frac:
        mp *= rng.random((G, P)).astype(np.float32)
        mk *= rng.random((G, K)).astype(np.float32)
    ip = (np.arange(G * P) % 5).reshape(G, P).astype(np.int64)
    ia = (np.arange(W) % 3).astype(np.int64)
    args = [torch.from_numpy(t) for t in (A, B, mp, ip, ia, mk)]
    got = hinge_route(*args, margin, C, tile)
    want = tk.batched_masked_pair_sum(*args, tk.TripletCombine("hinge",
                                                               margin), C)
    _same_nonfinite(got, want, 1e-5)
    # every kind of outcome occurs
    assert np.isnan(want.numpy()).any() and np.isfinite(want.numpy()).any()


def test_hinge_route_one_nonfinite_at_a_time():
    """Each rule alone, against the plain version: one finite row with
    a single non-finite distance or a zero weight placed in turn."""
    comb = tk.TripletCombine("hinge", 0.5)
    base_a = torch.tensor([[1.0, 2.0, 3.0]])
    base_b = torch.tensor([[1.5, 2.5, 0.5, 4.0]])
    ip, ia = torch.arange(3)[None], torch.tensor([7])
    cases = []
    for val in (INF, -INF, NAN):
        for j in range(3):
            a = base_a.clone()
            a[0, j] = val
            cases.append((a, base_b, torch.ones(1, 3), torch.ones(1, 4)))
        for k in range(4):
            b = base_b.clone()
            b[0, k] = val
            cases.append((base_a, b, torch.ones(1, 3), torch.ones(1, 4)))
            mk = torch.ones(1, 4)
            mk[0, (k + 1) % 4] = 0.0
            cases.append((base_a, b, torch.ones(1, 3), mk))
            mp = torch.ones(1, 3)
            mp[0, 1] = 0.0
            cases.append((base_a, b, mp, torch.ones(1, 4)))
    outcomes = set()
    for a, b, mp, mk in cases:
        got = hinge_route(a, b, mp, ip, ia, mk, 0.5, 1, 2048)
        want = tk.batched_masked_pair_sum(a, b, mp, ip, ia, mk, comb)
        _same_nonfinite(got, want, 1e-12)
        outcomes.add("nan" if math.isnan(want) else str(float(want)))
    assert {"nan", "inf"} <= outcomes and len(outcomes) > 3


def test_hinge_route_negative_weights_match_plain():
    """Weights of either sign (rule 4): one +inf or -inf distance placed
    in turn in A or B, and one negative weight (mp or mk, -1 or -0.5)
    placed in turn, or a mix of both signs: equal to plain, +inf, -inf and
    NaN all met. A +inf in A against negative weights mk gave +inf while
    the route assumed weights >= 0."""
    comb = tk.TripletCombine("hinge", 0.5)
    base_a = torch.tensor([[1.0, 2.0, 3.0]])
    base_b = torch.tensor([[1.5, 2.5, 0.5, 4.0]])
    ip, ia = torch.arange(3)[None], torch.tensor([7])
    outcomes = set()
    for val in (INF, -INF):
        for side, n in (("a", 3), ("b", 4)):
            for j in range(n):
                for neg in (-1.0, -0.5):
                    for which in ("mp", "mk", "all mk", "mixed mk"):
                        a, b = base_a.clone(), base_b.clone()
                        (a if side == "a" else b)[0, j] = val
                        mp, mk = torch.ones(1, 3), torch.ones(1, 4)
                        if which == "mp":
                            mp[0, j % 3] = neg
                        elif which == "mk":
                            mk[0, j % 4] = neg
                        elif which == "all mk":
                            mk[:] = neg
                        else:
                            mk[0, ::2] = neg
                        got = hinge_route(a, b, mp, ip, ia, mk, 0.5, 1, 2)
                        want = tk.batched_masked_pair_sum(a, b, mp, ip, ia,
                                                          mk, comb)
                        _same_nonfinite(got, want, 1e-12)
                        outcomes.add("nan" if math.isnan(want) else
                                     str(float(want)))
    assert {"nan", "inf", "-inf"} <= outcomes


@pytest.mark.parametrize("seed,G,C,P,K,tile", [(5, 2, 30, 9, 40, 16),
                                               (6, 3, 25, 6, 7, 4)])
def test_hinge_route_signed_weights_on_edge_values(seed, G, C, P, K, tile):
    """Random weights in (-1, 1) with zeros, on edge distances: NaN and
    infinities where plain has them, finite sums within rel 1e-5."""
    rng = np.random.default_rng(seed)
    W = G * C
    A, B = _edge(rng, (W, P)), _edge(rng, (W, K))
    mp = rng.uniform(-1, 1, (G, P)).astype(np.float32)
    mk = rng.uniform(-1, 1, (G, K)).astype(np.float32)
    mp[rng.random((G, P)) < 0.2] = 0.0
    mk[rng.random((G, K)) < 0.2] = 0.0
    ip = (np.arange(G * P) % 5).reshape(G, P).astype(np.int64)
    ia = (np.arange(W) % 3).astype(np.int64)
    args = [torch.from_numpy(t) for t in (A, B, mp, ip, ia, mk)]
    got = hinge_route(*args, 0.5, C, tile)
    want = tk.batched_masked_pair_sum(*args, tk.TripletCombine("hinge", 0.5),
                                      C)
    _same_nonfinite(got, want, 1e-5)
    assert np.isnan(want.numpy()).any() and np.isfinite(want.numpy()).any()


def test_hinge_tile_is_the_kernels():
    assert rank_count.HINGE_MAX_TILE == 8192
    assert rank_count.tile_size(32768, rank_count.HINGE_MAX_TILE) == 8192
    assert rank_count.tile_size(3000, rank_count.HINGE_MAX_TILE) == 4096
    assert rank_count.tile_size(32768) == rank_count.MAX_TILE


# --------------------------------------------------------------------- #
# kernel 1's logistic body                                                #
# --------------------------------------------------------------------- #

def log1p_unit(x):
    """float32 s * P(s^2), s = x / (2 + x), the kernel's coefficients."""
    s = x / (2.0 + x)
    z = s * s
    c = [torch.tensor(v, dtype=F32) for v in pk.LOG1P_COEFFS]
    p = c[4] * z + c[3]
    for ci in (c[2], c[1], c[0]):
        p = p * z + ci
    return s * p


def logistic_route(a, b, ma=None, mb=None, tile_a=64, tile_b=64):
    """Emulation of logistic_sum_kernel on [n1] x [n2] float32 scores:
    (float64 sum, factored blocks, per-pair blocks)."""
    span = torch.tensor(pk.LOGISTIC_SPAN, dtype=F32)
    total = torch.zeros((), dtype=F64)
    nf = npp = 0
    for i0 in range(0, len(a), tile_a):
        av = a[i0:i0 + tile_a]
        for j0 in range(0, len(b), tile_b):
            bv = b[j0:j0 + tile_b]
            vals = torch.cat([av, bv])
            lo, hi = vals.min(), vals.max()
            factored = bool(vals.isfinite().all()) and bool(hi - lo <= span)
            d = av[:, None] - bv[None, :]
            if factored:
                nf += 1
                if max(abs(float(lo)), abs(float(hi))) <= float(span) / 2:
                    c = torch.zeros((), dtype=F32)
                else:
                    c = torch.round(0.5 * (lo + hi))
                up, dn = torch.exp(av - c), torch.exp(c - av)
                p, q = torch.exp(bv - c), torch.exp(c - bv)
                x = torch.minimum(dn[:, None] * p[None, :],
                                  up[:, None] * q[None, :])
            else:
                npp += 1
                x = torch.exp(-d.abs())
            g = torch.clamp_min(-d, 0.0) + log1p_unit(x)
            if mb is not None:
                g = g * mb[None, j0:j0 + tile_b]
            if ma is not None:
                g = g * ma[i0:i0 + tile_a, None]
            total += g.sum(dtype=F64)
    return total, nf, npp


def _spread_scores(rng, n, shift):
    """Clustered scores (blocks that take the factored branch) and a
    spread of [-50, 50] (blocks that take the per-pair one), with ties
    and +-0.0: |d| reaches 100."""
    x = np.concatenate([rng.normal(shift, 2.0, n // 2),
                        rng.uniform(-50, 50, n - n // 2)]).astype(np.float32)
    x[::17] = np.round(x[::17])
    x[5], x[6] = 0.0, -0.0
    return x


@pytest.mark.parametrize("shift", [0.0, 200.0])
def test_logistic_route_matches_jax(shift):
    rng = np.random.default_rng(int(shift) + 1)
    s1 = _spread_scores(rng, 1536, shift + 1.0)
    s2 = _spread_scores(rng, 1024, shift)
    s1[:40] = s2[:40]                                   # exact ties
    got, nf, npp = logistic_route(torch.from_numpy(s1), torch.from_numpy(s2))
    assert nf > 0 and npp > 0, (nf, npp)                # both branches
    want = float(jp.pallas_pair_sum_any(
        jnp.asarray(s1), jnp.asarray(s2), kernel=jk.get_kernel("logistic"),
        tile_a=256, tile_b=512, interpret=True))
    assert abs(float(got) - want) <= 1e-5 * abs(want), (float(got), want)


def test_masked_logistic_route_matches_jax():
    rng = np.random.default_rng(11)
    a, b = _spread_scores(rng, 1237, 1.0), _spread_scores(rng, 1011, 0.0)
    ma = rng.integers(0, 2, 1237).astype(np.float32)
    mb = (rng.random(1011) * rng.integers(0, 2, 1011)).astype(np.float32)
    got, nf, npp = logistic_route(*(torch.from_numpy(t) for t in (a, b, ma,
                                                                  mb)))
    assert nf > 0 and npp > 0, (nf, npp)
    want = float(jp.pallas_masked_pair_sum(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma), jnp.asarray(mb),
        kernel=jk.get_kernel("logistic"), tile_a=256, tile_b=512,
        interpret=True))
    assert abs(float(got) - want) <= 1e-5 * abs(want), (float(got), want)


def test_log1p_polynomial_is_float32_accurate():
    """Within 4 units in 2^-24 of log1p on [0, 1], down to the smallest
    normal float32, with a correctly rounded division."""
    x = torch.cat([torch.linspace(0, 1, 200001, dtype=F32),
                   torch.logspace(-37.9, 0, 20001, dtype=F64).to(F32)])
    got = log1p_unit(x).to(F64)
    want = torch.log1p(x.to(F64))
    rel = ((got - want).abs() / want.clamp_min(1e-300))[want > 0]
    assert float(rel.max()) < 4 * 2.0 ** -24
    assert float(log1p_unit(torch.zeros(1))) == 0.0
    assert math.isnan(float(log1p_unit(torch.tensor([NAN]))))


@pytest.mark.parametrize("d", [0.0, -0.0, 1e-45, 3.5, -3.5, 80.0, -80.0,
                               100.0, -100.0])
def test_logistic_body_points(d):
    """The factored form (d = a - b split about c = 0 and c = 20) and the
    per-pair form against float64 softplus(-d), within rel 1e-6; at d =
    100 the value, e^-100, is a float32 subnormal, held to 2 units of the
    smallest one (float32 has no finer step there)."""
    want = math.log1p(math.exp(-abs(d))) + max(-d, 0.0)
    b = torch.tensor([0.0], dtype=F32)
    a = torch.tensor([d], dtype=F32)
    forms = [torch.exp(-(a - b).abs())]
    if abs(d) <= pk.LOGISTIC_SPAN:
        for c in (0.0, 20.0):
            c = torch.tensor(c, dtype=F32)
            forms.append(torch.minimum(torch.exp(c - a) * torch.exp(b - c),
                                       torch.exp(a - c) * torch.exp(c - b)))
    for x in forms:
        g = float(torch.clamp_min(-(a - b), 0.0) + log1p_unit(x))
        tol = 2 * 2.0 ** -149 if want < 2.0 ** -126 else 1e-6 * want
        assert abs(g - want) <= tol, (d, g, want)


def test_logistic_nonfinite_per_pair_form_matches_plain():
    """A block with a non-finite score takes the per-pair branch, whose
    form gives what the plain body gives: NaN, 0 for d = +inf, +inf for
    d = -inf."""
    a = torch.tensor([INF, -INF, NAN, 1.0, 0.0], dtype=F32)
    b = torch.tensor([1.0, INF, -INF, NAN, 0.0, -0.0], dtype=F32)
    d = a[:, None] - b[None, :]
    got = torch.clamp_min(-d, 0.0) + log1p_unit(torch.exp(-d.abs()))
    want = get_kernel("logistic").diff(d)
    np.testing.assert_array_equal(got.isnan().numpy(), want.isnan().numpy())
    fin = want.isfinite()
    assert torch.equal(got[~fin & ~want.isnan()], want[~fin & ~want.isnan()])
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=0)
    _, nf, npp = logistic_route(a, b)
    assert (nf, npp) == (0, 1)


# --------------------------------------------------------------------- #
# on the card: the kernels against their plain versions                  #
# --------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hinge and logistic kernels "
                    "have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _edge_on_card(gen, *shape, frac=0.3):
    """Normal values with a fraction frac drawn from +-inf, NaN of both
    signs, +-0.0 and subnormals, and 20 % rounded (heavy ties)."""
    x = torch.randn(*shape, generator=gen, device="cuda")
    pool = torch.tensor([INF, -INF, NAN, -NAN, 0.0, -0.0, 1.0, -1.0, 1e-45,
                         -1e-45], device="cuda")
    at = torch.randint(0, len(pool), shape, generator=gen, device="cuda")
    x = torch.where(torch.rand(*shape, generator=gen, device="cuda") < frac,
                    pool[at], x)
    return torch.where(torch.rand(*shape, generator=gen, device="cuda") < 0.2,
                       x.round(), x)


def _nonfinite_equal(got, want, rtol):
    """NaN positions equal, infinities equal, finite values within rtol."""
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    inf = want.isinf()
    assert torch.equal(got.isinf(), inf) and torch.equal(got[inf], want[inf])
    fin = want.isfinite()
    if fin.any():
        rel = (got[fin] - want[fin]).abs() / want[fin].abs().clamp_min(1e-30)
        assert float(rel.max()) < rtol


@pytest.mark.cuda
def test_hinge_and_logistic_pair_sums_on_edge_values_on_card(card):
    for name in ("hinge", "logistic"):
        k = get_kernel(name)
        # the last shape has a few non-finite scores: some blocks see one
        for W, n1, n2, frac in [(1, 1, 1, 0.3), (3, 300, 517, 0.3),
                                (2, 20000, 17, 0.3), (8, 3000, 5000, 1e-4)]:
            a = _edge_on_card(card, W, n1, frac=frac)
            b = _edge_on_card(card, W, n2, frac=frac)
            ma = (torch.rand(W, n1, generator=card, device="cuda") > 0.3).float()
            mb = (torch.rand(W, n2, generator=card, device="cuda") > 0.3).float()
            pk.reset_launch_counts()
            _nonfinite_equal(pk.pair_sum(a, b, k),
                             pk.pair_sum(a, b, k, impl="plain"), 1e-5)
            _nonfinite_equal(pk.masked_pair_sum(a, b, ma, mb, k),
                             pk.masked_pair_sum(a, b, ma, mb, k,
                                                impl="plain"), 1e-5)
            assert pk.LAUNCHES[f"pair_sum[{name}]"] == 1
            assert pk.LAUNCHES[f"masked_pair_sum[{name}]"] == 1


@pytest.mark.cuda
def test_logistic_kernel_takes_both_branches_on_card(card):
    """Scores up to |d| = 100 in one launch: blocks of a narrow range take
    the factored exponential, blocks of a wide one expf per pair; the
    sum equals the plain version within rel 1e-5 either way."""
    n = 1 << 14
    a = torch.cat([torch.randn(n, generator=card, device="cuda") + 300.0,
                   torch.rand(n, generator=card, device="cuda") * 100 - 50])
    b = torch.cat([torch.randn(n, generator=card, device="cuda") + 299.0,
                   torch.rand(n, generator=card, device="cuda") * 100 - 50])
    b[:64] = a[:64]
    factored, per_pair, got = pk.logistic_branch_blocks(a[None], b[None])
    assert factored > 0 and per_pair > 0, (factored, per_pair)
    want = pk.pair_sum(a[None], b[None], get_kernel("logistic"), impl="plain")
    _nonfinite_equal(got, want, 1e-5)


@pytest.mark.cuda
def test_rank_hinge_kernel_matches_plain_on_card(card):
    for margin in (0.0, 0.5, 1.0):
        comb = tk.TripletCombine("hinge", margin)
        for C, G, P, K, frac, edge in [(1, 1, 1, 1, False, True),
                                       (3, 2, 300, 517, False, True),
                                       (2, 2, 40, 20000, True, True),
                                       (64, 1, 2000, 9000, True, False),
                                       (3, 2, 300, 517, "signed", True)]:
            W = C * G
            if edge:
                A = _edge_on_card(card, W, P) + 3.0
                B = _edge_on_card(card, W, K) + 3.0
            else:                       # finite, many exact ties
                A = torch.randint(0, 40, (W, P), generator=card,
                                  device="cuda").float()
                B = torch.randint(0, 40, (W, K), generator=card,
                                  device="cuda").float()
            B[:, :5] = A[:, :5]
            mp = (torch.rand(G, P, generator=card, device="cuda") > 0.3).float()
            mk = (torch.rand(G, K, generator=card, device="cuda") > 0.3).float()
            if frac:
                mp = mp * torch.rand(G, P, generator=card, device="cuda")
                mk = mk * torch.rand(G, K, generator=card, device="cuda")
            if frac == "signed":        # weights of either sign (rule 4)
                mp = mp * torch.where(torch.rand(G, P, generator=card,
                                                 device="cuda") < 0.5, -1, 1)
                mk = mk * torch.where(torch.rand(G, K, generator=card,
                                                 device="cuda") < 0.5, -1, 1)
            ip = (torch.arange(G * P, device="cuda") % 7).reshape(G, P)
            ia = torch.arange(W, device="cuda") % 5
            pk.reset_launch_counts()
            got = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C)
            assert pk.LAUNCHES[f"batched_masked_pair_sum[{comb.name}]"] == 1
            want = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C,
                                              impl="plain")
            _nonfinite_equal(got, want, 1e-5)


@pytest.mark.cuda
def test_infinities_without_nan_on_card(card):
    """One kind of infinity a problem, so that +inf (not NaN) is the
    plain result: the hinge and logistic pair sums with -inf in a or +inf
    in b give +inf, +inf in a a term of 0; the triplet hinge with +inf in
    A or -inf in B gives +inf. A zero weight meeting the +inf makes NaN.
    With fmaxf in place of max.NaN a NaN difference scored 0; here the
    kernels must equal plain on every outcome."""
    a = torch.randn(4, 3000, generator=card, device="cuda")
    b = torch.randn(4, 5000, generator=card, device="cuda")
    a[1, 17], b[2, 4321], a[3, 2999] = -INF, INF, INF
    za, zb = torch.ones_like(a), torch.ones_like(b)
    za[1, 17], zb[2, 4321] = 0.0, 0.0
    for name in ("hinge", "logistic"):
        k = get_kernel(name)
        got, want = pk.pair_sum(a, b, k), pk.pair_sum(a, b, k, impl="plain")
        _nonfinite_equal(got, want, 1e-5)
        assert want.isinf().tolist() == [False, True, True, False]
        got = pk.masked_pair_sum(a, b, za, zb, k)
        want = pk.masked_pair_sum(a, b, za, zb, k, impl="plain")
        _nonfinite_equal(got, want, 1e-5)
        assert want.isnan().tolist() == [False, True, True, False]
    W, P, K = 4, 300, 517
    A = torch.rand(W, P, generator=card, device="cuda") * 20
    B = torch.rand(W, K, generator=card, device="cuda") * 20
    A[1, 7], B[2, 9], A[3, 5] = INF, -INF, -INF
    ip = 1000 + torch.arange(P, device="cuda")[None]   # no id collides
    ia = torch.arange(W, device="cuda")
    mp, mk = torch.ones(1, P, device="cuda"), torch.ones(1, K, device="cuda")
    comb = tk.TripletCombine("hinge", 1.0)
    for mk9, pattern in [(1.0, "inf"), (0.0, "nan")]:
        mk[0, 9] = mk9
        got = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb)
        want = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb,
                                          impl="plain")
        _nonfinite_equal(got, want, 1e-5)
        flags = want.isinf() if pattern == "inf" else want.isnan()
        assert flags.tolist() == [False, True, True, False]
    # +inf in A against weights mk all negative: -inf; of both signs: NaN
    mk = -torch.ones(1, K, device="cuda")
    A[2:] = torch.rand(2, P, generator=card, device="cuda") * 20
    B[2] = torch.rand(K, generator=card, device="cuda") * 20
    for mk0, row1 in [(-1.0, -INF), (1.0, NAN)]:
        mk[0, 0] = mk0
        got = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb)
        want = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb,
                                          impl="plain")
        _nonfinite_equal(got, want, 1e-5)
        assert math.isnan(want[1]) if math.isnan(row1) else want[1] == row1
