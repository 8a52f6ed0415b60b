"""The arithmetic of the two gradient-kernel designs (kernels 3-4),
emulated on the CPU and held against the JAX package's Pallas kernels in
interpret mode (and, on non-finite inputs, against the port's plain
versions, which follow the JAX bodies).

* The hinge route (``csrc/rank_count.cu`` ``tw_rank_hinge_grad``): both
  sides cut into tiles and sorted (keys: -0.0 as +0.0, NaN and padding
  as +inf slots past a tile's values); each a counts every tile of b with
  the predicate !(fl(a - b) < 1), a prefix of the sorted tile whose
  complement among the tile's values is the row's count; each b counts
  every tile of a with fl(a - b) < 1, a prefix; the loss of a finite a is
  c (1 - a) + the float64 suffix sum of the tile's finite values past
  the prefix, and non-finite scores follow the tile's counts of +inf and
  -inf values and its NaN flag.
* The logistic body (``csrc/pair_grad.cu``): per row tile and column
  tile, u = e^{-|d|} as the smaller of two products of per-score
  exponentials about a centre when the scores are finite and span at
  most ``LOGISTIC_SPAN``, else expf per pair (also in a chunk that holds
  padding); g' = -(d >= 0 ? u : 1) / (1 + u), g = max(-d, 0) +
  log1p(u) with the kernel's polynomial.

Tolerances: hinge row and col are integer counts, so equal; the hinge
loss within rel 1e-5 of the JAX loss (exact float64 arithmetic on the
float32 inputs against float32 terms); logistic row and col within rel
1e-4 and the loss within rel 1e-5, the contract of the kernels against
their plain versions on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops import pallas_pairs as jp
from tuplewise_tpu_torch.ops import pair_grad_kernels as pg
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.ops import rank_count
from tuplewise_tpu_torch.ops.kernels import get_kernel

INF, NAN = float("inf"), float("nan")
F32, F64 = torch.float32, torch.float64


# --------------------------------------------------------------------- #
# the hinge route                                                         #
# --------------------------------------------------------------------- #

def _sorted_tile(v, tile):
    """(values sorted, NaN and padding as +inf slots, padded to tile; the
    tile's values that are not NaN; its +inf values; its -inf values)."""
    nv = int((~v.isnan()).sum())
    s = torch.sort(torch.where(v.isnan(), torch.tensor(INF), v + 0.0)).values
    s = torch.cat([s, torch.full((tile - len(v),), INF)])
    return s, nv, int((v == INF).sum()), int((v == -INF).sum())


def _prefix(holds):
    """The length of the prefix on which holds is true, asserting that it
    is a prefix (what the kernel's binary search needs)."""
    p = holds.sum(-1)
    assert torch.equal(holds, torch.arange(holds.shape[-1]) < p[..., None]), \
        "predicate is not a prefix"
    return p


def _tile_loss(x, p, nv, npos, nneg, suffix):
    """hinge_grad_loss: the loss of each value x of a against one tile."""
    fin = x.abs() < INF
    out = (nv - p).to(F64) * (1.0 - x.to(F64)) + suffix[p]
    out = torch.where(fin & (npos > 0), INF, out)
    out = torch.where(x == INF, NAN if npos else 0.0, out)
    out = torch.where(x == -INF, NAN if nneg else (INF if nv else 0.0), out)
    return torch.where(x.isnan(), NAN, out)


def hinge_grad_route(a, b, tile_a, tile_b):
    """Emulation of tw_rank_hinge_grad on [W, n1] x [W, n2] float32:
    (loss [W] float64, row, col float32)."""
    W, n1 = a.shape
    n2 = b.shape[1]
    one = torch.tensor(1.0, dtype=F32)
    row = torch.zeros(W, n1, dtype=torch.int64)
    col = torch.zeros(W, n2, dtype=torch.int64)
    loss = torch.zeros(W, dtype=F64)
    for w in range(W):
        x = a[w]
        for t0 in range(0, n2, tile_b):
            v = b[w, t0:t0 + tile_b]
            s, nv, npos, nneg = _sorted_tile(v, tile_b)
            p = torch.clamp_max(_prefix(~((x[:, None] - s[None, :]) < one)),
                                nv)
            row[w] += nv - p
            fin = torch.where(s.abs() < INF, s, torch.zeros(()))
            suffix = torch.cat([torch.flip(torch.cumsum(
                torch.flip(fin.to(F64), [0]), 0), [0]), torch.zeros(1, dtype=F64)])
            part = _tile_loss(x, p, nv, npos, nneg, suffix).sum()
            loss[w] += NAN if bool(v.isnan().any()) else part
        y = b[w]
        for t0 in range(0, n1, tile_a):
            s, nv, _, _ = _sorted_tile(a[w, t0:t0 + tile_a], tile_a)
            col[w] += torch.clamp_max(
                _prefix((s[None, :] - y[:, None]) < one), nv)
    return loss, (-row).to(F32), (-col).to(F32)


def _jax_grad(s1, s2, name):
    """The JAX Pallas gradient kernels (interpret mode) on one problem:
    (loss, row, col) of pallas_pair_loss_grad and (row, col) of
    pallas_pair_grad_sums."""
    k = jk.get_kernel(name)
    jl, jr, jc = jp.pallas_pair_loss_grad(
        jnp.asarray(s1), jnp.asarray(s2), kernel=k, tile_a=256, tile_b=256,
        interpret=True)
    gr, gc = jp.pallas_pair_grad_sums(
        jnp.asarray(s1), jnp.asarray(s2), kernel=k, tile_a=256, tile_b=256,
        interpret=True)
    return (float(jl), np.asarray(jr).ravel(), np.asarray(jc).ravel(),
            np.asarray(gr).ravel(), np.asarray(gc).ravel())


def _hinge_scores(rng, W, n1, n2, lattice):
    if lattice:
        # multiples of 0.25: exact float32 differences, many ties, and
        # pairs on the kink d == 1 on both sides of every tile edge
        a = rng.integers(-8, 12, (W, n1)).astype(np.float32) * 0.25
        b = rng.integers(-8, 12, (W, n2)).astype(np.float32) * 0.25
    else:
        a = (rng.standard_normal((W, n1)) * 0.5 + 0.3).astype(np.float32)
        b = (rng.standard_normal((W, n2)) * 0.5).astype(np.float32)
    k = min(n1, n2, 7)
    b[:, :k] = a[:, :k] - np.float32(1.0)          # d == 1 exactly
    a[:, -1], b[:, -1] = 0.0, -0.0
    return a, b


@pytest.mark.parametrize("W,n1,n2,tile_a,tile_b,lattice", [
    (1, 300, 517, 64, 128, False),        # several ragged tiles a side
    (2, 257, 130, 256, 64, True),         # lattice scores, ties at d == 1
    (1, 70, 90, 256, 256, True),          # one tile a side
    (3, 16, 16, 256, 256, False),         # the sim learner's problems
])
def test_hinge_route_matches_jax(W, n1, n2, tile_a, tile_b, lattice):
    rng = np.random.default_rng(n1 * 1000 + n2)
    a, b = _hinge_scores(rng, W, n1, n2, lattice)
    loss, row, col = hinge_grad_route(torch.from_numpy(a),
                                      torch.from_numpy(b), tile_a, tile_b)
    for w in range(W):
        jl, jr, jc, gr, gc = _jax_grad(a[w], b[w], "hinge")
        np.testing.assert_array_equal(row[w].numpy(), jr)
        np.testing.assert_array_equal(col[w].numpy(), jc)
        np.testing.assert_array_equal(row[w].numpy(), gr)
        np.testing.assert_array_equal(col[w].numpy(), gc)
        assert abs(float(loss[w]) - jl) <= 1e-5 * abs(jl), (float(loss[w]), jl)
    # and the port's plain version: row and col equal, the loss rel 1e-5
    lp, rp, cp = pg.pair_loss_grad_plain(torch.from_numpy(a),
                                         torch.from_numpy(b),
                                         get_kernel("hinge"))
    assert torch.equal(row, rp) and torch.equal(col, cp)
    torch.testing.assert_close(loss, lp, rtol=1e-5, atol=0)


def _edge_scores(rng, shape, frac):
    """Normal scores with +-inf, NaN of both signs, +-0.0, subnormals and
    lattice values (ties, d == 1) drawn in."""
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    lat = rng.random(shape) < 0.3
    x[lat] = np.round(x[lat])
    pool = np.array([INF, -INF, NAN, -NAN, 0.0, -0.0, 1.0, 2.0, 1e-45,
                     -1e-45], np.float32)
    pick = rng.random(shape) < frac
    x[pick] = rng.choice(pool, pick.sum())
    return x


def _same_nonfinite(got, want, rtol):
    got, want = got.numpy(), want.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


@pytest.mark.parametrize("seed,W,n1,n2,tile_a,tile_b,frac", [
    (0, 24, 9, 13, 4, 8, 0.15),
    (1, 16, 40, 33, 16, 8, 0.05),
    (2, 40, 5, 7, 256, 256, 0.2),
    (3, 8, 70, 90, 32, 64, 0.01),
])
def test_hinge_route_nonfinite_rules_match_plain(seed, W, n1, n2, tile_a,
                                                 tile_b, frac):
    """NaN and infinities anywhere, ragged tiles: row and col equal to the
    plain version (g' is 0 for a NaN difference), the loss NaN and inf
    where plain has them and finite losses within rel 1e-5."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(_edge_scores(rng, (W, n1), frac))
    b = torch.from_numpy(_edge_scores(rng, (W, n2), frac))
    loss, row, col = hinge_grad_route(a, b, tile_a, tile_b)
    lp, rp, cp = pg.pair_loss_grad_plain(a, b, get_kernel("hinge"))
    assert torch.equal(row, rp) and torch.equal(col, cp)
    _same_nonfinite(loss, lp, 1e-5)
    # both kinds of outcome occur
    assert lp.isnan().any() and lp.isfinite().any()


def test_hinge_route_one_nonfinite_at_a_time():
    """Each rule alone: one finite problem with a single non-finite score
    placed in turn in a or b, at every position of a ragged tiling."""
    base_a = torch.tensor([[0.5, 1.5, 2.0, -1.0, 3.0]])
    base_b = torch.tensor([[1.0, -0.5, 2.5, 0.5]])
    outcomes = set()
    for val in (INF, -INF, NAN):
        for side, n in (("a", 5), ("b", 4)):
            for j in range(n):
                a, b = base_a.clone(), base_b.clone()
                (a if side == "a" else b)[0, j] = val
                loss, row, col = hinge_grad_route(a, b, 2, 3)
                lp, rp, cp = pg.pair_loss_grad_plain(a, b,
                                                     get_kernel("hinge"))
                assert torch.equal(row, rp) and torch.equal(col, cp)
                _same_nonfinite(loss, lp, 1e-12)
                outcomes.add("nan" if math.isnan(lp) else str(float(lp)))
    assert {"nan", "inf"} <= outcomes and len(outcomes) > 3


def test_hinge_route_padding_enters_no_sum():
    """The padding fault of the sentinel design: a -inf score of a with
    n2 not a multiple of the tile met -inf padding columns, d = NaN, so
    the loss was NaN where plain gives +inf; a +inf score of b met +inf
    padding rows. Here padding is left out by count: the loss is +inf
    and row and col equal plain, whatever the tile."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy((rng.standard_normal((2, 37))).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((2, 29))).astype(np.float32))
    a[0, 3] = -INF
    b[1, 11] = INF
    for tile_a, tile_b in [(256, 256), (16, 8), (4, 32)]:
        loss, row, col = hinge_grad_route(a, b, tile_a, tile_b)
        lp, rp, cp = pg.pair_loss_grad_plain(a, b, get_kernel("hinge"))
        assert lp.isinf().all() and (lp > 0).all()
        assert torch.equal(loss, lp)
        assert torch.equal(row, rp) and torch.equal(col, cp)
        # the -inf score counts every pair: d = -inf < 1
        assert float(row[0, 3]) == -29.0


def test_hinge_loss_propagates_nan():
    """The NaN fault of the pair sweep: fmaxf(0, 1 - d) returned 0 for a
    NaN difference, so a NaN score added 0 to the loss. JAX's hinge
    (jnp.maximum), the plain version (torch.clamp_min) and this route all
    give NaN; g' = -1{d < 1} stays 0 for NaN."""
    a = torch.tensor([[0.2, NAN, 0.9]])
    b = torch.tensor([[0.1, -0.4]])
    loss, row, col = hinge_grad_route(a, b, 256, 256)
    lp, rp, cp = pg.pair_loss_grad_plain(a, b, get_kernel("hinge"))
    assert math.isnan(float(loss)) and math.isnan(float(lp))
    assert bool(jnp.isnan(jk.get_kernel("hinge").diff(jnp.float32(NAN), jnp)))
    assert float(row[0, 1]) == 0.0 and torch.equal(row, rp)
    assert torch.equal(col, cp) and col.tolist() == [[-2.0, -1.0]]


def test_grad_tiles_are_the_kernels():
    assert rank_count.GRAD_TILES == (256, 2048, 8192, 16384)
    assert rank_count.grad_tile_size(16) == 256
    assert rank_count.grad_tile_size(257) == 2048
    assert rank_count.grad_tile_size(4133) == 8192
    assert rank_count.grad_tile_size(500_000) == 16384
    # 16384 values and their float64 suffix sums fit a block's 227 KB
    assert 4 * 16384 + 8 * 16385 <= 232_448


# --------------------------------------------------------------------- #
# the logistic body                                                       #
# --------------------------------------------------------------------- #

def _log1p_unit(x):
    s = x / (2.0 + x)
    z = s * s
    c = [torch.tensor(v, dtype=F32) for v in pk.LOG1P_COEFFS]
    p = c[4] * z + c[3]
    for ci in (c[2], c[1], c[0]):
        p = p * z + ci
    return s * p


def logistic_grad_route(a, b, tile_a=2048, tile_b=1024, chunk=32):
    """Emulation of logistic_grad_kernel on [n1] x [n2] float32: (loss
    float64, row, col float32 of float64 sums, factored blocks, per-pair
    blocks). A chunk of columns that holds padding, or a ragged row tile,
    takes the per-pair form."""
    n1, n2 = len(a), len(b)
    span = torch.tensor(pk.LOGISTIC_SPAN, dtype=F32)
    row = torch.zeros(n1, dtype=F64)
    col = torch.zeros(n2, dtype=F64)
    loss = torch.zeros((), dtype=F64)
    nf = npp = 0
    for i0 in range(0, n1, tile_a):
        av = a[i0:i0 + tile_a]
        ragged_rows = i0 + tile_a > n1
        for j0 in range(0, n2, tile_b):
            bv = b[j0:j0 + tile_b]
            vals = torch.cat([av, bv])
            lo, hi = vals.min(), vals.max()
            factored = bool(vals.isfinite().all()) and bool(hi - lo <= span)
            d = av[:, None] - bv[None, :]
            u = torch.exp(-d.abs())
            if factored:
                nf += 1
                if max(abs(float(lo)), abs(float(hi))) <= float(span) / 2:
                    c = torch.zeros((), dtype=F32)
                else:
                    c = torch.round(0.5 * (lo + hi))
                fu = torch.minimum(torch.exp(c - av)[:, None]
                                   * torch.exp(bv - c)[None, :],
                                   torch.exp(av - c)[:, None]
                                   * torch.exp(c - bv)[None, :])
                # whole chunks of real columns in a whole row tile factor
                whole = (torch.arange(len(bv)) // chunk + 1) * chunk \
                    <= len(bv)
                use = whole[None, :] & torch.tensor(not ragged_rows)
                u = torch.where(use, fu, u)
            else:
                npp += 1
            r = 1.0 / (1.0 + u)
            t = torch.where(d >= 0, -u, torch.tensor(-1.0)) * r
            g = torch.clamp_min(-d, 0.0) + _log1p_unit(u)
            row[i0:i0 + tile_a] += t.sum(1, dtype=F64)
            col[j0:j0 + tile_b] += t.sum(0, dtype=F64)
            loss += g.sum(dtype=F64)
    return loss, row.to(F32), col.to(F32), nf, npp


def _spread(rng, n, shift):
    """Clustered scores (factored tiles) and a spread of [-50, 50]
    (per-pair tiles), with ties and +-0.0."""
    x = np.concatenate([rng.normal(shift, 1.0, n // 2),
                        rng.uniform(-50, 50, n - n // 2)]).astype(np.float32)
    x[::13] = np.round(x[::13])
    x[-3], x[-4] = 0.0, -0.0
    return x


@pytest.mark.parametrize("n1,n2,tile_a,tile_b,shift", [
    (300, 517, 64, 128, 0.0),     # ragged row tiles and column chunks
    (512, 256, 256, 128, 200.0),  # factored about a centre c != 0
    (16, 16, 2048, 1024, 0.0),    # the sim learner's problem: all masked
])
def test_logistic_route_matches_jax(n1, n2, tile_a, tile_b, shift):
    rng = np.random.default_rng(n1 + n2 + int(shift))
    # the first half of each tile pair clusters (factored), the spread
    # half forces per-pair tiles
    s1 = _spread(rng, n1, shift + 0.3)
    s2 = _spread(rng, n2, shift)
    if n1 <= 16:
        s1 = rng.normal(0.3, 0.5, n1).astype(np.float32)
        s2 = rng.normal(0.0, 0.5, n2).astype(np.float32)
    loss, row, col, nf, npp = logistic_grad_route(
        torch.from_numpy(s1), torch.from_numpy(s2), tile_a, tile_b)
    jl, jr, jc, gr, gc = _jax_grad(s1, s2, "logistic")
    np.testing.assert_allclose(row.numpy(), jr, rtol=1e-4, atol=0)
    np.testing.assert_allclose(col.numpy(), jc, rtol=1e-4, atol=0)
    np.testing.assert_allclose(row.numpy(), gr, rtol=1e-4, atol=0)
    np.testing.assert_allclose(col.numpy(), gc, rtol=1e-4, atol=0)
    assert abs(float(loss) - jl) <= 1e-5 * abs(jl), (float(loss), jl)
    if n1 > 16:
        assert nf > 0 and npp > 0, (nf, npp)


@pytest.mark.parametrize("d", [0.0, -0.0, 1e-45, 0.75, -0.75, 20.0, -20.0,
                               80.0, -80.0])
def test_logistic_gradient_form_points(d):
    """g' = -(d >= 0 ? u : 1) / (1 + u) with u factored about c = 0 and
    c = 20 and per pair, against float64 -1 / (1 + e^d) within rel 1e-6
    (at |d| = 80 the factored products are e^{+-80}, normal floats)."""
    want = -1.0 / (1.0 + math.exp(d))
    a = torch.tensor([d], dtype=F32)
    b = torch.tensor([0.0], dtype=F32)
    forms = [torch.exp(-(a - b).abs())]
    for c in (0.0, 20.0):
        c = torch.tensor(c, dtype=F32)
        forms.append(torch.minimum(torch.exp(c - a) * torch.exp(b - c),
                                   torch.exp(a - c) * torch.exp(c - b)))
    for u in forms:
        got = float(torch.where(a - b >= 0, -u, torch.tensor(-1.0))
                    / (1.0 + u))
        assert abs(got - want) <= 1e-6 * abs(want), (d, got, want)


def test_logistic_gradient_nonfinite_matches_plain():
    """The per-pair form on NaN and infinities gives the plain g and g':
    NaN for a NaN difference, g' = -0 and g = 0 for d = +inf, g' = -1 and
    g = +inf for d = -inf."""
    a = torch.tensor([INF, -INF, NAN, 1.0, 0.0], dtype=F32)
    b = torch.tensor([1.0, INF, -INF, NAN, 0.0, -0.0], dtype=F32)
    d = a[:, None] - b[None, :]
    u = torch.exp(-d.abs())
    gp = torch.where(d >= 0, -u, torch.tensor(-1.0)) * (1.0 / (1.0 + u))
    g = torch.clamp_min(-d, 0.0) + _log1p_unit(u)
    k = get_kernel("logistic")
    for got, want in ((gp, k.diff_grad_fn(d)), (g, k.diff(d))):
        np.testing.assert_array_equal(got.isnan().numpy(),
                                      want.isnan().numpy())
        inf = want.isinf()
        assert torch.equal(got[inf], want[inf])
        fin = want.isfinite()
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=0)
    # a tile with a non-finite score takes the per-pair form
    *_, nf, npp = logistic_grad_route(a, b)
    assert (nf, npp) == (0, 1)


def test_logistic_grad_constants_are_the_pair_sums():
    """pair_grad.cu builds the span and log1p coefficients of pair_sum.cu;
    the launcher checks both against these when it loads the library."""
    assert pg.LOGISTIC_SPAN == pk.LOGISTIC_SPAN == 80.0
    assert pg.LOG1P_COEFFS == pk.LOG1P_COEFFS
