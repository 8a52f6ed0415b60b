"""Kernel 1's hinge body as a sort-and-search route (``csrc/rank_count.cu``
``tw_rank_hinge_sum``), emulated on the CPU and held against the JAX
package's ``pallas_pair_sum`` with the hinge body in interpret mode (and,
on non-finite inputs, against the port's plain version, which follows the
JAX body).

The route is the hinge gradient route's loss alone (its rules and
helpers are ``tests/test_torch_grad_designs.py``'s): b cut into tiles,
each sorted once (keys: -0.0 as +0.0, NaN and padding as +inf slots past
the tile's values) with the float64 suffix sums of its finite values; each a_i finds the prefix of the sorted tile on
which !(fl(a_i - b) < 1) holds with the body's float32 predicate (a binary
search on the card), and the terms that are not 0 are the c values past
it: c (1 - a_i) + their suffix sum, in float64. Non-finite scores follow
the tile's counts of +inf and -inf values and its NaN flag.

Tolerance. A selected pair adds (1 - a_i) + b_j in float64 where the plain
version (and the pair sweep before it) adds the float32 term
fl(1 - fl(a_i - b_j)): the two differ by at most half an ulp of
fl(a_i - b_j) plus half an ulp of the float32 term. ``plain_gap`` sums that
over the selected pairs; the route is held within it (and a float64 slack)
of plain, and the gap within rel 1e-5 of the sum on the inputs of
chip_smoke.py phase 2. Against JAX (float32 block partials, Kahan-summed)
the same rel 1e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grad_designs import (  # the hinge gradient route's rules
    _edge_scores, _prefix, _same_nonfinite, _sorted_tile, _tile_loss,
)
from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops import pallas_pairs as jp
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.ops import rank_count
from tuplewise_tpu_torch.ops.kernels import get_kernel

INF, NAN = float("inf"), float("nan")
F32, F64 = torch.float32, torch.float64
HINGE = get_kernel("hinge")


def hinge_pair_route(a, b, tile):
    """Emulation of tw_rank_hinge_sum on [W, n1] x [W, n2] float32: [W]
    float64 sums of max(0, 1 - fl(a_i - b_j)), tile by tile of b."""
    W, n2 = b.shape
    one = torch.tensor(1.0, dtype=F32)
    out = torch.zeros(W, dtype=F64)
    for w in range(W):
        x = a[w]
        for t0 in range(0, n2, tile):
            v = b[w, t0:t0 + tile]
            s, nv, npos, nneg = _sorted_tile(v, tile)
            p = torch.clamp_max(_prefix(~((x[:, None] - s[None, :]) < one)),
                                nv)
            fin = torch.where(s.abs() < INF, s, torch.zeros(())).to(F64)
            suffix = torch.cat([torch.flip(torch.cumsum(torch.flip(fin, [0]),
                                                        0), [0]),
                                torch.zeros(1, dtype=F64)])
            part = _tile_loss(x, p, nv, npos, nneg, suffix).sum()
            out[w] += NAN if bool(v.isnan().any()) else part
    return out


def _half_ulp(x):
    x = x.abs()
    return (torch.nextafter(x, torch.tensor(INF)) - x).to(F64) * 0.5


def plain_gap(a, b):
    """[W]: the largest |route - plain| the float32 rounding allows, the
    sum over the selected pairs (fl(a_i - b_j) < 1, finite) of half an
    ulp of fl(a_i - b_j) and half an ulp of fl(1 - fl(a_i - b_j))."""
    d = a[:, :, None] - b[:, None, :]
    sel = (d < 1) & d.isfinite()
    gap = _half_ulp(d) + _half_ulp(1.0 - d)
    return torch.where(sel, gap, torch.zeros((), dtype=F64)).sum((1, 2))


def _pallas_hinge(a, b):
    return float(jp.pallas_pair_sum_any(
        jnp.asarray(a), jnp.asarray(b), kernel=jk.get_kernel("hinge"),
        tile_a=256, tile_b=512, interpret=True))


def _scores(rng, W, n1, n2, lattice):
    if lattice:
        # multiples of 0.25: exact differences, many ties, pairs on the
        # kink d == 1 on both sides of every tile edge
        a = rng.integers(-8, 12, (W, n1)).astype(np.float32) * 0.25
        b = rng.integers(-8, 12, (W, n2)).astype(np.float32) * 0.25
    else:
        a = (rng.standard_normal((W, n1)) + 1.0).astype(np.float32)
        b = rng.standard_normal((W, n2)).astype(np.float32)
    k = min(n1, n2, 7)
    b[:, :k] = a[:, :k] - np.float32(1.0)          # d == 1 exactly
    a[:, -1], b[:, -1] = 0.0, -0.0
    return a, b


@pytest.mark.parametrize("W,n1,n2,tile,lattice", [
    (1, 300, 517, 128, False),       # several ragged tiles
    (2, 257, 130, 64, True),         # lattice scores, ties at d == 1
    (1, 70, 90, 256, True),          # one tile, padding past the values
    (3, 16, 16, 256, False),         # the sim learner's problems
])
def test_route_matches_jax(W, n1, n2, tile, lattice):
    rng = np.random.default_rng(n1 * 1000 + n2)
    a, b = _scores(rng, W, n1, n2, lattice)
    got = hinge_pair_route(torch.from_numpy(a), torch.from_numpy(b), tile)
    for w in range(W):
        want = _pallas_hinge(a[w], b[w])
        assert abs(float(got[w]) - want) <= 1e-5 * abs(want), (w, want)
    plain = pk.pair_sum_plain(torch.from_numpy(a), torch.from_numpy(b), HINGE)
    if lattice:
        # exact float32 differences and terms: the route is plain's sum
        torch.testing.assert_close(got, plain, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed,W,n1,n2,tile", [
    (0, 1, 4133, 197, 256),          # phase 2's ragged shape, cut in n2
    (1, 8, 413, 819, 256),
    (2, 16, 125, 125, 2048),         # the harness's local-round batches
    (3, 1, 1, 1, 256),
])
def test_route_within_the_rounding_gap_of_plain(seed, W, n1, n2, tile):
    """The tolerance of the module note, on chip_smoke.py phase 2's
    inputs (N(1, 1) against N(0, 1), 97 exact ties): |route - plain| <=
    plain_gap + a float64 slack, and plain_gap within rel 1e-5."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((W, n1)) + 1.0).astype(np.float32)
    b = rng.standard_normal((W, n2)).astype(np.float32)
    k = min(97, n1, n2)
    a[:, :k] = b[:, :k]
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    got = hinge_pair_route(a, b, tile)
    want = pk.pair_sum_plain(a, b, HINGE)
    gap = plain_gap(a, b)
    assert ((got - want).abs() <= gap + 1e-12 * want.abs()).all()
    assert (gap <= 1e-5 * want.abs()).all(), (gap / want).max()


def test_rounding_gap_is_the_bound_on_near_kink_pairs():
    """Pairs just under the kink, where one float32 rounding of the
    difference is a large share of a small term: the route keeps the
    exact term, plain the rounded one; they differ, within plain_gap."""
    # 0.75 - (-0.25 + 3 2^-26) = 1 - 3 2^-26 rounds to 1 - 2^-24;
    # 2 - (1 + 2^-22) is exact; 3 - 2^-30 rounds to 3 (not selected)
    a = torch.tensor([[0.75, 2.0, 3.0]])
    b = torch.tensor([[-0.25 + 3 * 2.0 ** -26, 1.0 + 2.0 ** -22, 2.0 ** -30]])
    got = hinge_pair_route(a, b, 256)
    want = pk.pair_sum_plain(a, b, HINGE)
    assert float(got) != float(want)
    assert float((got - want).abs()) <= float(plain_gap(a, b))


@pytest.mark.parametrize("seed,W,n1,n2,tile,frac", [
    (0, 24, 9, 13, 8, 0.15),
    (1, 16, 40, 33, 8, 0.05),
    (2, 40, 5, 7, 256, 0.2),
    (3, 8, 70, 90, 64, 0.01),
])
def test_nonfinite_rules_match_plain(seed, W, n1, n2, tile, frac):
    """NaN and infinities anywhere, ragged tiles: NaN and inf where plain
    has them, finite sums within rel 1e-5."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(_edge_scores(rng, (W, n1), frac))
    b = torch.from_numpy(_edge_scores(rng, (W, n2), frac))
    want = pk.pair_sum_plain(a, b, HINGE)
    _same_nonfinite(hinge_pair_route(a, b, tile), want, 1e-5)
    assert want.isnan().any() and want.isfinite().any()


def test_one_nonfinite_at_a_time():
    """Each rule alone: a single +inf, -inf or NaN placed in turn at every
    position of a or b, with a ragged tiling of b."""
    base_a = torch.tensor([[0.5, 1.5, 2.0, -1.0, 3.0]])
    base_b = torch.tensor([[1.0, -0.5, 2.5, 0.5]])
    outcomes = set()
    for val in (INF, -INF, NAN):
        for side, n in (("a", 5), ("b", 4)):
            for j in range(n):
                a, b = base_a.clone(), base_b.clone()
                (a if side == "a" else b)[0, j] = val
                want = pk.pair_sum_plain(a, b, HINGE)
                _same_nonfinite(hinge_pair_route(a, b, 3), want, 1e-12)
                outcomes.add("nan" if math.isnan(want) else str(float(want)))
    assert {"nan", "inf"} <= outcomes and len(outcomes) > 3


def test_infinities_beside_ragged_tiles():
    """A -inf score of a and a +inf score of b beside tiles with padding:
    every pair of the -inf score counts +inf, a +inf in b makes every
    finite a's sum +inf; -inf in both a and b meet as NaN; the padding
    slots enter no sum."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((3, 37)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 29)).astype(np.float32))
    a[0, 3] = -INF
    b[1, 11] = INF
    a[2, 0], b[2, 28] = -INF, -INF
    for tile in (256, 8, 16):
        got = hinge_pair_route(a, b, tile)
        want = pk.pair_sum_plain(a, b, HINGE)
        assert want[:2].isinf().all() and (want[:2] > 0).all()
        assert math.isnan(float(want[2]))
        _same_nonfinite(got, want, 1e-12)


def test_negative_zero_and_the_kink():
    """-0.0 ties +0.0 (d = 0 counts 1), and d == 1 exactly counts 0."""
    a = torch.tensor([[0.0, -0.0, 1.0, 2.0]])
    b = torch.tensor([[-0.0, 1.0, 0.0]])
    got = hinge_pair_route(a, b, 256)
    want = pk.pair_sum_plain(a, b, HINGE)
    # d: 0, -1, 0 | 0, -1, 0 | 1, 0, 1 | 2, 1, 2 -> 1 + 2 + 1 twice, then 1
    assert float(want) == 9.0 and torch.equal(got, want)


def test_grid_limits_raise():
    """Beyond the CUDA grid the launcher raises before it builds anything
    (the checks run on any device)."""
    with pytest.raises(ValueError, match="beyond the CUDA grid"):
        rank_count.hinge_pair_sums(torch.zeros(65536, 1), torch.zeros(65536,
                                                                      1))
    with pytest.raises(ValueError, match="beyond the CUDA grid"):
        rank_count.hinge_pair_sums(torch.zeros(1, 1),
                                   torch.zeros(1, 16384 * 65535 + 1))


@pytest.mark.parametrize("name", ["auc", "hinge", "logistic"])
def test_pair_sums_take_the_route_of_their_body(name, monkeypatch):
    """The dispatch of the wrapper with the launchers stubbed so that it
    runs here: the auc and hinge bodies, unmasked and masked, go to their
    rank_count launchers (csrc/rank_count.cu), the masked one with the
    body's flag; only the logistic body reaches csrc/pair_sum.cu. Each
    call counts one launch under its wrapper."""
    calls = []

    def route(what, dtype):
        def launch(a, b, *masks, **flags):
            calls.append((what, tuple(a.shape), tuple(b.shape), len(masks),
                          flags.get("hinge")))
            return torch.zeros(a.shape[0], dtype=dtype)
        return launch

    class Sweep(Exception):
        pass

    def sweep_library():
        calls.append(("pair_sum.cu",))
        raise Sweep

    monkeypatch.setattr(rank_count, "auc_twice_counts",
                        route("auc", torch.int64))
    monkeypatch.setattr(rank_count, "hinge_pair_sums", route("hinge", F64))
    monkeypatch.setattr(rank_count, "masked_pair_sums", route("masked", F64))
    monkeypatch.setattr(pk, "load_library", sweep_library)
    k = get_kernel(name)
    a, b = torch.zeros(2, 5), torch.zeros(2, 3)
    ma, mb = torch.ones_like(a), torch.ones_like(b)
    pk.reset_launch_counts()
    if name == "logistic":
        for wrapper, masks in (("pair_sum", (None, None)),
                               ("masked_pair_sum", (ma, mb))):
            with pytest.raises(Sweep):
                pk._launch(wrapper, a, b, *masks, k)
        assert calls == [("pair_sum.cu",)] * 2
        assert sum(pk.LAUNCHES.values()) == 0
    else:
        assert pk._launch("pair_sum", a, b, None, None, k).shape == (2,)
        assert pk._launch("pair_sum", a[0], b[0], None, None, k).shape == ()
        assert pk._launch("masked_pair_sum", a, b, ma, mb, k).shape == (2,)
        assert pk._launch("masked_pair_sum", a[0], b[0], ma[0], mb[0],
                          k).shape == ()
        hinge = name == "hinge"
        assert calls == [(name, (2, 5), (2, 3), 0, None),
                         (name, (1, 5), (1, 3), 0, None),
                         ("masked", (2, 5), (2, 3), 2, hinge),
                         ("masked", (1, 5), (1, 3), 2, hinge)]
        assert pk.LAUNCHES[f"pair_sum[{name}]"] == 2
        assert pk.LAUNCHES[f"masked_pair_sum[{name}]"] == 2
    pk.reset_launch_counts()


@pytest.mark.cuda
def test_route_matches_plain_on_card():
    """The kernel against the plain version on the card: ragged multi-tile
    shapes (n2 past 16384), the harness's batches, edge values with
    padding in the last tile, infinities without NaN, d == 1 ties: NaN
    and inf where plain has them, finite sums within plain_gap's rel
    1e-5; two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hinge pair-sum kernel has no "
                    "CPU mode")
    rng = np.random.default_rng(9)
    for W, n1, n2, frac in [(1, 4133, 40000, 0.0), (512, 125, 125, 0.0),
                            (3, 900, 17000, 0.01), (8, 300, 517, 0.1),
                            (1, 1, 1, 0.0)]:
        if frac:
            a = _edge_scores(rng, (W, n1), frac)
            b = _edge_scores(rng, (W, n2), frac)
        else:
            a, b = _scores(rng, W, n1, n2, lattice=False)
            if W > 2:
                a[1, 0], b[2, -1] = -INF, INF
        a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        got = pk.pair_sum(a, b, HINGE)
        again = pk.pair_sum(a, b, HINGE)
        want = pk.pair_sum(a, b, HINGE, impl="plain")
        assert torch.equal(got.view(torch.int64), again.view(torch.int64))
        _same_nonfinite(got.cpu(), want.cpu(), 1e-5)
    a, b = _scores(rng, 2, 5000, 3000, lattice=True)
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    torch.testing.assert_close(pk.pair_sum(a, b, HINGE),
                               pk.pair_sum(a, b, HINGE, impl="plain"),
                               rtol=1e-12, atol=0)
