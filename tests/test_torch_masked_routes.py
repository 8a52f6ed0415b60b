"""Kernel 2's masked auc and hinge bodies as weighted sort-and-search routes
(``csrc/rank_count.cu`` ``tw_rank_masked_sum``), emulated on the CPU and
held against the JAX package's ``pallas_masked_pair_sum`` in interpret mode
and, on edge values, against the port's plain version.

The routes: b cut into tiles, each sorted once with its weights mb (keys:
-0.0 as +0.0; NaN values and padding as +inf slots of weight 0 past the
tile's values), with the float64 suffix sums of the sorted weights (auc)
or of (mb, mb * b) over the finite values (hinge). Each a_i searches every
tile with the body's own float32 predicates:

* auc: P_gt and P_ge, the weights of the b with fl(a_i - b) > 0 and >= 0;
  the row adds ma_i (P_gt + (P_ge - P_gt) / 2) in float64;
* hinge: the prefix where !(fl(a_i - b) < 1); the row adds
  ma_i ((1 - a_i) W + S), W and S the suffix sums past it, in float64;
  non-finite scores follow the tile's counts of +inf and -inf values and
  its flags (a NaN; for the finite and +inf values and for the +inf
  values, whether one has a weight < 0, = 0 or > 0: an infinite term takes
  the sign of its weights' product, NaN where one is 0), as
  ``masked_hinge_row`` in the source. Weights are finite, of either sign.

Tolerances, derived from the arithmetic, not chosen:

* auc: the plain version rounds each float32 product fl(fl(g mb) ma) once
  or twice; ``auc_gap`` sums those roundings, computed exactly in float64.
  With weights in {0, 1} the gap is 0 and the route equals plain bit for
  bit; otherwise it is within the gap plus a float64 slack (1e-12 of the
  sum).
* hinge: the plain version adds fl(fl(fl(1 - fl(a - b)) mb) ma) where the
  route adds (1 - a + b) mb ma; ``hinge_gap`` sums, over the selected
  pairs, half an ulp of fl(a - b) and of fl(1 - d) times mb ma, and the
  two products' roundings (exact in float64). The route is held within it
  plus the float64 slack, and the gap within rel 1e-5 of the sum.
* Against JAX (float32 row sums of g mb, Kahan-summed block partials):
  the auc under {0, 1} masks exactly (every partial is a small half
  integer), otherwise rel 1e-5, the tolerance of the package's other
  pair-sum parity tests.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grad_designs import _edge_scores, _prefix, _same_nonfinite
from test_torch_pair_hinge_route import _half_ulp
from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops import pallas_pairs as jp
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.ops import rank_count
from tuplewise_tpu_torch.ops.kernels import get_kernel

INF, NAN = float("inf"), float("nan")
F32, F64 = torch.float32, torch.float64
AUC, HINGE = get_kernel("auc"), get_kernel("hinge")


# --------------------------------------------------------------------- #
# the routes                                                              #
# --------------------------------------------------------------------- #

def _signs(m, where):
    """(a weight = 0, < 0, > 0) among the weights m where ``where`` holds;
    a NaN weight counts as 0."""
    return (bool((where & ~((m < 0) | (m > 0))).any()),
            bool((where & (m < 0)).any()), bool((where & (m > 0)).any()))


def _weighted_tile(v, m, tile):
    """(values sorted with their weights, NaN and padding as +inf slots of
    weight 0, padded to tile; the tile's info: values that are not NaN, +inf
    values, -inf values, the signs of the finite and +inf values' weights,
    the signs of the +inf values' weights, each as ``_signs``)."""
    nan = v.isnan()
    key = torch.where(nan, torch.tensor(INF), v + 0.0)
    wt = torch.where(nan, torch.zeros(()), m)
    order = torch.sort(key, stable=True).indices
    pad = tile - len(v)
    s = torch.cat([key[order], torch.full((pad,), INF)])
    w = torch.cat([wt[order], torch.zeros(pad)])
    info = (int((~nan).sum()), int((v == INF).sum()), int((v == -INF).sum()),
            _signs(m, ~nan & (v != -INF)), _signs(m, v == INF))
    return s, w, info


def _suffix(x):
    """[len(x) + 1] float64 suffix sums, the last 0."""
    return torch.cat([torch.flip(torch.cumsum(torch.flip(x.to(F64), [0]), 0),
                                 [0]), torch.zeros(1, dtype=F64)])


def masked_auc_route(a, b, ma, mb, tile):
    """Emulation of tw_rank_masked_sum's auc on [W, n1] x [W, n2] float32
    with weights: [W] float64 sums of g(fl(a_i - b_j)) ma_i mb_j."""
    W, n2 = b.shape
    out = torch.zeros(W, dtype=F64)
    for w in range(W):
        x = a[w]
        for t0 in range(0, n2, tile):
            s, wt, _ = _weighted_tile(b[w, t0:t0 + tile], mb[w, t0:t0 + tile],
                                      tile)
            suf = _suffix(wt)
            d = x[:, None] - s[None, :]
            gt, ge = _prefix(d > 0), _prefix(d >= 0)
            out[w] += (ma[w].to(F64) * (suf[0] - 0.5 * (suf[gt] + suf[ge]))
                       ).sum()
    return out


def _signed_inf(wa, signs):
    """signed_inf: [len(wa)] the infinite part of rows of weights wa whose
    infinite terms are +inf times weights of the given signs (``_signs``):
    NaN if wa or one of those weights is 0 or both signs are present, else
    an infinity of sign(wa) times theirs."""
    zero, neg, pos = signs
    nan = ~((wa < 0) | (wa > 0)) | zero | (neg and pos)
    flip = (wa < 0) ^ neg
    return torch.where(nan, NAN, torch.where(flip, -INF, INF)).to(F64)


def _masked_hinge_rows(x, wa, p, info, sw, sb):
    """masked_hinge_row: each value x of a with weight wa against one
    weighted tile, p its prefix."""
    _, npos, nneg, up_signs, posinf_signs = info
    wad = wa.to(F64)
    out = wad * ((1.0 - x.to(F64)) * sw[p] + sb[p])
    fin = x.abs() < INF
    if npos:
        out = torch.where(fin, _signed_inf(wa, posinf_signs), out)
    out = torch.where(x == INF, NAN if npos else 0.0, out)
    neg_part = (torch.full_like(out, NAN) if nneg
                else _signed_inf(wa, up_signs))
    out = torch.where(x == -INF, neg_part, out)
    return torch.where(x.isnan(), NAN, out)


def masked_hinge_route(a, b, ma, mb, tile):
    """Emulation of tw_rank_masked_sum's hinge on [W, n1] x [W, n2]
    float32 with weights: [W] float64 sums of max(0, 1 - fl(a_i - b_j))
    ma_i mb_j, NaN and infinities by the tile's counts and flags."""
    W, n2 = b.shape
    one = torch.tensor(1.0, dtype=F32)
    out = torch.zeros(W, dtype=F64)
    for w in range(W):
        x = a[w]
        for t0 in range(0, n2, tile):
            v = b[w, t0:t0 + tile]
            s, wt, info = _weighted_tile(v, mb[w, t0:t0 + tile], tile)
            fin = s.abs() < INF
            zero = torch.zeros((), dtype=F64)
            sw = _suffix(torch.where(fin, wt.to(F64), zero))
            sb = _suffix(torch.where(fin, wt.to(F64) * s.to(F64), zero))
            p = _prefix(~((x[:, None] - s[None, :]) < one))
            part = _masked_hinge_rows(x, ma[w], p, info, sw, sb).sum()
            out[w] += NAN if bool(v.isnan().any()) else part
    return out


ROUTES = {"auc": masked_auc_route, "hinge": masked_hinge_route}


# --------------------------------------------------------------------- #
# the derived gaps                                                        #
# --------------------------------------------------------------------- #

def _product_roundings(g, ma, mb):
    """[W, n1, n2]: the plain version's two float32 roundings of
    fl(fl(g mb) ma) against g mb ma, each exact in float64 (a product of
    two float32 values is), the first times ma."""
    p1 = g * mb[:, None, :]
    p2 = p1 * ma[:, :, None]
    exact1 = g.to(F64) * mb[:, None, :].to(F64)
    err = ((p1.to(F64) - exact1).abs() * ma[:, :, None].to(F64).abs()
           + (p2.to(F64) - p1.to(F64) * ma[:, :, None].to(F64)).abs())
    return err


def auc_gap(a, b, ma, mb):
    """[W]: sum over the pairs of |plain's float32 term - g mb ma|."""
    g = AUC.diff(a[:, :, None] - b[:, None, :])
    return _product_roundings(g, ma, mb).sum((1, 2))


def hinge_gap(a, b, ma, mb):
    """[W]: the largest |route - plain| the float32 rounding allows, the sum
    over the pairs with finite fl(a - b) < 1 of (half an ulp of fl(a - b)
    and of g = fl(1 - d)) mb ma plus the roundings of fl(fl(g mb) ma)."""
    d = a[:, :, None] - b[:, None, :]
    g = 1.0 - d
    sel = (d < 1) & d.isfinite()
    w = (ma[:, :, None].to(F64) * mb[:, None, :].to(F64)).abs()
    gap = (_half_ulp(d) + _half_ulp(g)) * w + _product_roundings(g, ma, mb)
    return torch.where(sel, gap, torch.zeros((), dtype=F64)).sum((1, 2))


def _held_to_plain(name, got, a, b, ma, mb):
    """Hold a route's [W] sums to the plain version within its gap."""
    want = pk.masked_pair_sum_plain(a, b, ma, mb, get_kernel(name))
    gap = (auc_gap if name == "auc" else hinge_gap)(a, b, ma, mb)
    _same_nonfinite(got, want, 1.0)
    fin = want.isfinite()
    err = (got - want).abs()[fin]
    assert (err <= gap[fin] + 1e-12 * want.abs()[fin]).all(), \
        (name, err, gap[fin])
    return want, gap


def _weights(rng, shape, kind):
    """{0, 1} masks, {-1, 0, 1} weights ("ternary"), or random weights in
    [0, 2) ("random") or in (-2, 2) ("signed") with a fifth of them 0."""
    if kind == "binary":
        return rng.integers(0, 2, shape).astype(np.float32)
    if kind == "ternary":
        return rng.integers(-1, 2, shape).astype(np.float32)
    w = (rng.random(shape) * 2.0).astype(np.float32)
    if kind == "signed":
        w = np.where(rng.random(shape) < 0.5, -w, w).astype(np.float32)
    w[rng.random(shape) < 0.2] = 0.0
    return w


def _scores(rng, W, n1, n2, lattice):
    if lattice:
        # multiples of 0.25: exact differences, heavy ties, pairs at d == 0
        # and d == 1 on both sides of every tile edge
        a = rng.integers(-8, 12, (W, n1)).astype(np.float32) * 0.25
        b = rng.integers(-8, 12, (W, n2)).astype(np.float32) * 0.25
    else:
        a = (rng.standard_normal((W, n1)) + 1.0).astype(np.float32)
        b = rng.standard_normal((W, n2)).astype(np.float32)
    k = min(n1, n2, 7)
    b[:, :k] = a[:, :k] - np.float32(1.0)          # d == 1 exactly
    b[:, k:2 * k] = a[:, k:2 * k]                  # d == 0 exactly
    a[:, -1], b[:, -1] = 0.0, -0.0
    return a, b


def _tensors(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


# --------------------------------------------------------------------- #
# against JAX                                                             #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["auc", "hinge"])
@pytest.mark.parametrize("weights", ["binary", "random"])
@pytest.mark.parametrize("W,n1,n2,tile,lattice", [
    (1, 300, 517, 128, False),       # several ragged tiles of b
    (2, 257, 130, 64, True),         # lattice scores, ties at d == 0, 1
    (1, 70, 90, 256, True),          # one tile, padding past the values
    (3, 16, 16, 256, False),         # the sim learner's problems
])
def test_routes_match_jax(name, weights, W, n1, n2, tile, lattice):
    rng = np.random.default_rng(n1 * 1000 + n2 + len(weights))
    a, b = _scores(rng, W, n1, n2, lattice)
    ma, mb = _weights(rng, (W, n1), weights), _weights(rng, (W, n2), weights)
    got = ROUTES[name](*_tensors(a, b, ma, mb), tile)
    for w in range(W):
        want = float(jp.pallas_masked_pair_sum(
            jnp.asarray(a[w]), jnp.asarray(b[w]), jnp.asarray(ma[w]),
            jnp.asarray(mb[w]), kernel=jk.get_kernel(name), tile_a=256,
            tile_b=512, interpret=True))
        if name == "auc" and weights == "binary":
            assert float(got[w]) == want, (w, float(got[w]), want)
        else:
            assert abs(float(got[w]) - want) <= 1e-5 * abs(want), (w, want)
    want, gap = _held_to_plain(name, got, *_tensors(a, b, ma, mb))
    if weights == "binary" and (name == "auc" or lattice):
        # exact products (and, on the lattice, exact terms): plain's sum
        assert torch.equal(got, want)


# --------------------------------------------------------------------- #
# against the port's plain version                                        #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["auc", "hinge"])
@pytest.mark.parametrize("seed,W,n1,n2,tile,frac", [
    (0, 24, 9, 13, 8, 0.15),         # short last tile, many problems
    (1, 16, 40, 33, 8, 0.05),
    (2, 40, 5, 7, 256, 0.2),         # one tile, mostly padding
    (3, 8, 70, 90, 64, 0.01),
])
@pytest.mark.parametrize("weights", ["binary", "random"])
def test_edge_values_match_plain(name, seed, W, n1, n2, tile, frac, weights):
    """+-inf, NaN of both signs, +-0.0, ties and subnormals anywhere, weights
    with zeros (so infinities of weight 0 and infinities facing a zero
    weight), ragged tiles: the auc equal to plain under {0, 1} weights and
    within auc_gap otherwise; the hinge NaN and inf where plain has them,
    finite sums within hinge_gap."""
    rng = np.random.default_rng(seed)
    a = _edge_scores(rng, (W, n1), frac)
    b = _edge_scores(rng, (W, n2), frac)
    ma, mb = _weights(rng, (W, n1), weights), _weights(rng, (W, n2), weights)
    a, b, ma, mb = _tensors(a, b, ma, mb)
    got = ROUTES[name](a, b, ma, mb, tile)
    want, _ = _held_to_plain(name, got, a, b, ma, mb)
    if name == "auc":
        assert want.isfinite().all()
        if weights == "binary":
            assert torch.equal(got, want)
    else:
        assert want.isnan().any() and want.isfinite().any()


@pytest.mark.parametrize("name", ["auc", "hinge"])
def test_one_nonfinite_at_a_time(name):
    """Each rule alone: a single +inf, -inf or NaN placed in turn at every
    position of a or b, its own weight 1 or 0, and a zero weight placed in
    turn at every position of the other side (an infinity facing a zero
    weight), with a ragged tiling of b."""
    base_a = torch.tensor([[0.5, 1.5, 2.0, -1.0, 3.0]])
    base_b = torch.tensor([[1.0, -0.5, 2.5, 0.5]])
    outcomes = set()
    for val in (INF, -INF, NAN):
        for side, n, m in (("a", 5, 4), ("b", 4, 5)):
            for j in range(n):
                for own in (1.0, 0.0):
                    for k in range(-1, m):
                        a, b = base_a.clone(), base_b.clone()
                        ma, mb = torch.ones_like(a), torch.ones_like(b)
                        (a if side == "a" else b)[0, j] = val
                        (ma if side == "a" else mb)[0, j] = own
                        if k >= 0:  # a zero weight across
                            (mb if side == "a" else ma)[0, k] = 0.0
                        got = ROUTES[name](a, b, ma, mb, 3)
                        want, _ = _held_to_plain(name, got, a, b, ma, mb)
                        if name == "auc":
                            assert torch.equal(got, want)
                        outcomes.add("nan" if math.isnan(want) else
                                     str(float(want)))
    if name == "hinge":
        assert {"nan", "inf"} <= outcomes and len(outcomes) > 3


def test_infinities_and_zero_weights():
    """The hinge's infinite cases by hand: an infinity whose own weight is
    0 (NaN: +inf times 0), an infinity facing a zero weight across (NaN),
    and the same infinities with every weight positive (+inf); -inf in
    both a and b meet as NaN; +inf in a against finite b adds 0."""
    a = torch.tensor([[0.5, 1.0, -INF]])
    b = torch.tensor([[0.0, INF, 2.0]])
    ones_a, ones_b = torch.ones(1, 3), torch.ones(1, 3)
    cases = [
        (ones_a, ones_b, INF),                                   # all +inf
        (ones_a, torch.tensor([[1.0, 0.0, 1.0]]), NAN),          # b's own 0
        (torch.tensor([[0.0, 1.0, 1.0]]), ones_b, NAN),          # 0 across
        (ones_a, torch.tensor([[0.0, 1.0, 1.0]]), NAN),          # -inf vs 0
    ]
    for ma, mb, want_value in cases:
        got = masked_hinge_route(a, b, ma, mb, 2)
        want, _ = _held_to_plain("hinge", got, a, b, ma, mb)
        assert (math.isnan(want_value) and math.isnan(want)) or \
            float(want) == want_value
    # +inf in a against finite b is 0; -inf in a and b meet as NaN
    a2 = torch.tensor([[INF, 0.5]])
    b2 = torch.tensor([[0.0, 1.0, -0.5]])
    got = masked_hinge_route(a2, b2, torch.ones(1, 2), torch.ones(1, 3), 2)
    want, _ = _held_to_plain("hinge", got, a2, b2, torch.ones(1, 2),
                             torch.ones(1, 3))
    assert float(want) == 2.0       # 0.5 + 1.5 + 0 from a = 0.5 alone
    b3 = torch.tensor([[-INF, 1.0]])
    a3 = torch.tensor([[-INF, 0.0]])
    got = masked_hinge_route(a3, b3, torch.ones(1, 2), torch.ones(1, 2), 2)
    assert math.isnan(float(got))


def test_auc_ties_and_signed_zeros_are_exact():
    """-0.0 ties +0.0, equal infinities score 0 (their difference is NaN),
    NaN scores 0 against anything, whatever its weight: equal to plain."""
    a = torch.tensor([[0.0, -0.0, INF, -INF, NAN, 1.0]])
    b = torch.tensor([[-0.0, 0.0, INF, -INF, NAN, 1.0, 1.0]])
    ma = torch.tensor([[1.0, 1.0, 1.0, 0.0, 1.0, 1.0]])
    mb = torch.tensor([[1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0]])
    for tile in (2, 4, 8):
        got = masked_auc_route(a, b, ma, mb, tile)
        want = pk.masked_pair_sum_plain(a, b, ma, mb, AUC)
        assert torch.equal(got, want)
    # a = +-0: a tie with -0.0 (+0.0 weighs 0) and a win over -inf, 1.5
    # each; a = +inf: wins over -0.0, -inf and both 1.0 (NaN with +inf),
    # 4; a = -inf weighs 0, NaN scores 0; a = 1: wins over -0.0 and -inf,
    # ties both 1.0, 3
    assert float(want) == 10.0


@pytest.mark.parametrize("seed,W,n1,n2,tile", [
    (0, 1, 4133, 197, 256),          # phase 2's ragged shape, cut in n2
    (1, 8, 413, 819, 256),
    (2, 16, 125, 125, 2048),         # the harness's local-round batches
])
def test_hinge_gap_is_within_rel_1e5(seed, W, n1, n2, tile):
    """The hinge's derived gap on chip_smoke.py phase 2's inputs (N(1, 1)
    against N(0, 1), 97 exact ties) with random weights: the route within
    it of plain, and the gap within rel 1e-5 of the sum."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((W, n1)) + 1.0).astype(np.float32)
    b = rng.standard_normal((W, n2)).astype(np.float32)
    k = min(97, n1, n2)
    a[:, :k] = b[:, :k]
    ma, mb = _weights(rng, (W, n1), "random"), _weights(rng, (W, n2), "random")
    a, b, ma, mb = _tensors(a, b, ma, mb)
    got = masked_hinge_route(a, b, ma, mb, tile)
    want, gap = _held_to_plain("hinge", got, a, b, ma, mb)
    assert (gap <= 1e-5 * want.abs()).all(), (gap / want).max()


@pytest.mark.parametrize("n,hinge,tile", [
    (1, False, 256), (256, True, 256), (257, False, 2048),
    (8192, True, 8192), (8193, True, 8192), (8193, False, 16384),
    (125000, False, 16384), (125000, True, 8192),
])
def test_masked_tile_size(n, hinge, tile):
    assert rank_count.masked_tile_size(n, hinge) == tile


def test_grid_limits_raise():
    """Beyond the CUDA grid the launcher raises before it builds anything
    (the checks run on any device)."""
    def z(*shape):  # shapes only: nothing is read before the check
        return torch.zeros(1, 1).expand(*shape)

    with pytest.raises(ValueError, match="beyond the CUDA grid"):
        rank_count.masked_pair_sums(z(65536, 1), z(65536, 1), z(65536, 1),
                                    z(65536, 1), hinge=False)
    n2 = 8192 * 65535 + 1
    with pytest.raises(ValueError, match="beyond the CUDA grid"):
        rank_count.masked_pair_sums(z(1, 1), z(1, n2), z(1, 1), z(1, n2),
                                    hinge=True)


# --------------------------------------------------------------------- #
# weights of either sign                                                  #
# --------------------------------------------------------------------- #

# W = 1 inputs where a negative weight decides the hinge's infinity:
# (a, b, ma, mb, plain's value). The routes gave +inf on each while they
# assumed weights >= 0.
NEGATIVE_WEIGHT_INPUTS = [
    ([0.5, 0.0], [INF, 0.3], [1.0, 1.0], [-1.0, 1.0], -INF),
    ([0.5, 0.0], [INF, INF], [1.0, 1.0], [1.0, -1.0], NAN),
    ([-INF, 0.0], [0.1, 0.3], [1.0, 1.0], [-2.0, -1.0], -INF),
    ([-INF, 0.0], [0.1, 0.3], [-1.0, 1.0], [1.0, 1.0], -INF),
]


def _row_tensors(a, b, ma, mb):
    return tuple(torch.tensor([x], dtype=F32) for x in (a, b, ma, mb))


@pytest.mark.parametrize("case", range(len(NEGATIVE_WEIGHT_INPUTS)))
@pytest.mark.parametrize("tile", [1, 2, 256])
def test_negative_weight_inputs_equal_plain(case, tile):
    """The four inputs where a negative weight sets the sign of the
    hinge's infinity: the route equals plain exactly (-inf, NaN, -inf,
    -inf), one tile or a tile a value."""
    *args, value = NEGATIVE_WEIGHT_INPUTS[case]
    a, b, ma, mb = _row_tensors(*args)
    got = masked_hinge_route(a, b, ma, mb, tile)
    want, _ = _held_to_plain("hinge", got, a, b, ma, mb)
    assert (math.isnan(value) and math.isnan(float(want))) or \
        float(want) == value


def test_infinite_masked_sums_are_nan_in_the_reference():
    """A known divergence, not a fault: the reference's masked pair sum
    turns every infinite sum into NaN, on both of its routes. Its Kahan
    step (t - s) - y is inf - inf once the running sum is infinite
    (``_masked_pair_sum_kernel``, Pallas interpret, and ``pair_stats``'s
    ``_acc_update``, XLA), also with tiles of the inputs' own size (no
    zero-weight padding) and with every weight positive. The port's plain
    version and its routes sum the float32 terms in float64 with no
    compensation: an infinity of the sign the weights give, NaN only
    where IEEE arithmetic makes one."""
    from tuplewise_tpu.ops import pair_tiles as jt

    k = jk.get_kernel("hinge")
    positive = ([0.5, 0.0], [INF, 0.3], [1.0, 1.0], [1.0, 1.0], INF)
    for *args, value in NEGATIVE_WEIGHT_INPUTS + [positive]:
        a, b, ma, mb = (np.asarray(x, np.float32) for x in args)
        ja, jb, jma, jmb = (jnp.asarray(x) for x in (a, b, ma, mb))
        ref = [float(jp.pallas_masked_pair_sum(ja, jb, jma, jmb, kernel=k,
                                               interpret=True)),
               float(jp.pallas_masked_pair_sum(ja, jb, jma, jmb, kernel=k,
                                               tile_a=2, tile_b=2,
                                               interpret=True)),
               float(jt.pair_stats(k, ja, jb, mask_a=jma, mask_b=jmb)[0]),
               float(jt.pair_stats(k, ja, jb, mask_a=jma, mask_b=jmb,
                                   tile_a=2, tile_b=2)[0])]
        assert all(math.isnan(r) for r in ref), ref
        port = _row_tensors(*args)
        for got in (masked_hinge_route(*port, 2),
                    pk.masked_pair_sum(*port, HINGE)):
            assert (math.isnan(value) and math.isnan(float(got))) or \
                float(got) == value


@pytest.mark.parametrize("name", ["auc", "hinge"])
def test_one_negative_weight_and_infinity_at_a_time(name):
    """One +inf or -inf placed in turn at every position of a or b, its
    own weight 1, -1 or -0.5, and one negative weight placed in turn at
    every position of the other side (or none), with a ragged tiling of b:
    equal to plain (the hinge exactly where it is not finite); the hinge
    meets +inf, -inf and NaN."""
    base_a = torch.tensor([[0.5, 1.5, 2.0, -1.0, 3.0]])
    base_b = torch.tensor([[1.0, -0.5, 2.5, 0.5]])
    outcomes = set()
    for val in (INF, -INF):
        for side, n, m in (("a", 5, 4), ("b", 4, 5)):
            for j in range(n):
                for own in (1.0, -1.0, -0.5):
                    for k in range(-1, m):
                        a, b = base_a.clone(), base_b.clone()
                        ma, mb = torch.ones_like(a), torch.ones_like(b)
                        (a if side == "a" else b)[0, j] = val
                        (ma if side == "a" else mb)[0, j] = own
                        if k >= 0:  # a negative weight across
                            (mb if side == "a" else ma)[0, k] = -1.5
                        got = ROUTES[name](a, b, ma, mb, 3)
                        want, _ = _held_to_plain(name, got, a, b, ma, mb)
                        if name == "auc":
                            assert torch.equal(got, want)
                        outcomes.add("nan" if math.isnan(want) else
                                     str(float(want)))
    if name == "hinge":
        assert {"nan", "inf", "-inf"} <= outcomes


@pytest.mark.parametrize("name", ["auc", "hinge"])
@pytest.mark.parametrize("seed,W,n1,n2,tile,frac", [
    (20, 24, 9, 13, 8, 0.15),        # short last tile, many problems
    (21, 16, 40, 33, 8, 0.05),
    (22, 8, 70, 90, 64, 0.01),
])
@pytest.mark.parametrize("weights", ["ternary", "signed"])
def test_signed_weights_match_plain(name, seed, W, n1, n2, tile, frac,
                                    weights):
    """Edge values (+-inf, NaN, +-0.0, ties, subnormals) with weights of
    either sign: the auc equal to plain under {-1, 0, 1} weights (every
    sum an integer or a half) and within auc_gap otherwise; the hinge NaN
    and +-inf where plain has them, finite sums within hinge_gap."""
    rng = np.random.default_rng(seed)
    a = _edge_scores(rng, (W, n1), frac)
    b = _edge_scores(rng, (W, n2), frac)
    ma, mb = _weights(rng, (W, n1), weights), _weights(rng, (W, n2), weights)
    a, b, ma, mb = _tensors(a, b, ma, mb)
    got = ROUTES[name](a, b, ma, mb, tile)
    want, _ = _held_to_plain(name, got, a, b, ma, mb)
    if name == "auc":
        assert want.isfinite().all()
        if weights == "ternary":
            assert torch.equal(got, want)
    else:
        assert want.isnan().any() and want.isfinite().any()


@pytest.mark.parametrize("name", ["auc", "hinge"])
@pytest.mark.parametrize("weights", ["ternary", "signed"])
def test_signed_weights_match_jax(name, weights):
    """Finite scores with weights of either sign against both routes of
    the reference (Pallas interpret and XLA ``pair_stats``): the auc under
    {-1, 0, 1} weights exactly (every float32 partial a small half
    integer), otherwise within 1e-5 of the sum of |terms|: with signed
    weights the sum cancels, and each route's float32 rounding is of the
    terms' magnitudes, not of their sum."""
    from tuplewise_tpu.ops import pair_tiles as jt

    rng = np.random.default_rng(30 + len(weights))
    W, n1, n2 = 2, 300, 517
    a, b = _scores(rng, W, n1, n2, lattice=name == "auc")
    ma, mb = _weights(rng, (W, n1), weights), _weights(rng, (W, n2), weights)
    got = ROUTES[name](*_tensors(a, b, ma, mb), 128)
    k = jk.get_kernel(name)
    for w in range(W):
        ja, jb, jma, jmb = (jnp.asarray(x[w]) for x in (a, b, ma, mb))
        ref = (float(jp.pallas_masked_pair_sum(ja, jb, jma, jmb, kernel=k,
                                               tile_a=256, tile_b=512,
                                               interpret=True)),
               float(jt.pair_stats(k, ja, jb, mask_a=jma, mask_b=jmb)[0]))
        terms = get_kernel(name).diff(
            torch.from_numpy(a[w][:, None] - b[w][None, :])).double()
        mass = float((terms * torch.from_numpy(
            np.abs(ma[w][:, None] * mb[w][None, :]))).sum())
        for want in ref:
            if name == "auc" and weights == "ternary":
                assert float(got[w]) == want, (w, float(got[w]), want)
            else:
                assert abs(float(got[w]) - want) <= 1e-5 * mass, (w, want)
    _held_to_plain(name, got, *_tensors(a, b, ma, mb))


# --------------------------------------------------------------------- #
# on the card                                                             #
# --------------------------------------------------------------------- #

def _gap_on(name, a, b, ma, mb, rows=64):
    """auc_gap or hinge_gap in chunks of rows of a (bounded memory)."""
    fn = auc_gap if name == "auc" else hinge_gap
    return sum(fn(a[:, i:i + rows], b, ma[:, i:i + rows], mb)
               for i in range(0, a.shape[1], rows))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["auc", "hinge"])
def test_masked_routes_match_plain_on_card(name):
    """The kernel against the plain version on the card: b past one 8192-
    and one 16384-value tile with a short last tile, the harness's
    W = 512 x 1250, edge values; {0, 1}, {-1, 0, 1} and random weights of
    one or either sign; the inputs where a negative weight sets the
    hinge's infinity. The auc equal to plain under {0, 1} and {-1, 0, 1}
    weights and within auc_gap otherwise; the hinge NaN and +-inf where
    plain has them, finite sums within hinge_gap; two calls bit-equal, one
    launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the masked sort-and-search "
                    "kernels have no CPU mode")
    rng = np.random.default_rng(11)
    k = get_kernel(name)
    for W, n1, n2, frac in [(1, 1000, 8192 + 97, 0.0),
                            (2, 700, 16384 + 5, 0.0), (512, 125, 125, 0.0),
                            (3, 300, 517, 0.1), (1, 1, 1, 0.0)]:
        for weights in ("binary", "random", "ternary", "signed"):
            if frac:
                a = _edge_scores(rng, (W, n1), frac)
                b = _edge_scores(rng, (W, n2), frac)
            else:
                a, b = _scores(rng, W, n1, n2, lattice=False)
            ma = _weights(rng, (W, n1), weights)
            mb = _weights(rng, (W, n2), weights)
            a, b, ma, mb = (t.cuda() for t in _tensors(a, b, ma, mb))
            pk.reset_launch_counts()
            got = pk.masked_pair_sum(a, b, ma, mb, k)
            again = pk.masked_pair_sum(a, b, ma, mb, k)
            assert pk.LAUNCHES[f"masked_pair_sum[{name}]"] == 2
            assert torch.equal(got.view(torch.int64), again.view(torch.int64))
            want = pk.masked_pair_sum(a, b, ma, mb, k, impl="plain")
            got, want = got.cpu(), want.cpu()
            _same_nonfinite(got, want, 1.0)
            gap = _gap_on(name, *(t.cpu() for t in (a, b, ma, mb)))
            fin = want.isfinite()
            err = (got - want).abs()[fin]
            assert (err <= gap[fin] + 1e-12 * want.abs()[fin]).all()
            if name == "auc" and weights in ("binary", "ternary"):
                assert torch.equal(got, want)
    for *args, _ in NEGATIVE_WEIGHT_INPUTS:
        a, b, ma, mb = (t.cuda() for t in _row_tensors(*args))
        got = pk.masked_pair_sum(a, b, ma, mb, k).cpu()
        want = pk.masked_pair_sum(a, b, ma, mb, k, impl="plain").cpu()
        _same_nonfinite(got, want, 1e-12)
    pk.reset_launch_counts()
