"""The port's gradient pair sums (ops.pair_grad_kernels) and the
differentiable pair means (ops.pair_tiles) against the JAX package, on
the same numpy-made inputs.

The JAX Pallas gradient kernels run in interpret mode at 256 x 256
tiles, as tests/test_learner.py runs them. Tolerances: hinge row and col
are integer counts in both packages, so they must be equal. Logistic row
and col sums are each held against the float64 sums of the same float32
terms (d = a - b rounded to float32 as both packages round it), within a
bound derived from the arithmetic, per element, u = 2^-24:

* the JAX kernel sums n float32 terms in float32: at most (n - 1) u
  sum|t| of summation error, plus each term's own error (exp, add,
  divide: a few ulps) of at most 16 u |t|: (n + 16) u sum|t|;
* the port's plain version sums the same float32 terms in float64 and
  rounds once: 16 u sum|t| + u |sum|.

Logistic g' terms all have one sign, so sum|t| = |sum| and the bounds are
relative: 6.3e-6 for a row of 90 terms. Losses within rtol 2e-5, the JAX
suite's own tolerance for float32 sums taken in different orders.
Gradients of the pair means against jax.grad: atol 1e-7, as the JAX suite
holds its own VJPs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops import pair_tiles as jt
from tuplewise_tpu.ops import pallas_pairs as jp
from tuplewise_tpu_torch.ops import pair_grad_kernels as pg
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.ops import kernels as tk
from tuplewise_tpu_torch.ops import pair_tiles

GRAD_NAMES = ("hinge", "logistic")
SHAPES = [(70, 90), (256, 512), (300, 517)]


def _scores(n1, n2, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n1).astype(np.float32),
            rng.standard_normal(n2).astype(np.float32))


# unit roundoff of float32, and the per-term error allowance in units of
# it (the module docstring)
_U32 = 2.0 ** -24
_TERM_U = 16


def _exact_terms(name, s1, s2):
    """g'(d) in float64 of the float32 differences d = s1_i - s2_j."""
    d = (s1[:, None] - s2[None, :]).astype(np.float64)
    if name == "logistic":
        return -1.0 / (1.0 + np.exp(d))
    return np.where(d < 1.0, -1.0, 0.0)


def _check_sums(name, s1, s2, row, col, port):
    """Row and col sums against the float64 sums of the same terms within
    the bound of the module docstring (``port``: float64 accumulation;
    else the JAX kernel's float32 one). Returns the largest error as a
    fraction of its bound."""
    row, col = np.asarray(row, np.float64), np.asarray(col, np.float64)
    t = _exact_terms(name, s1, s2)
    worst = 0.0
    for got, exact, mag, n in ((row, t.sum(1), np.abs(t).sum(1), len(s2)),
                               (col, t.sum(0), np.abs(t).sum(0), len(s1))):
        if name == "hinge":
            np.testing.assert_array_equal(got, exact)
            continue
        if port:
            bound = _TERM_U * _U32 * mag + _U32 * np.abs(exact)
        else:
            bound = (n + _TERM_U) * _U32 * mag
        err = np.abs(got - exact)
        assert (err <= bound).all(), (
            f"{'port' if port else 'JAX'} sums off by up to "
            f"{(err / bound).max():.2f}x the derived bound at "
            f"{int((err > bound).sum())} of {len(err)} elements")
        worst = max(worst, float((err / bound).max()))
    return worst


def _check(name, s1, s2, got, want):
    """The port's (row, col) and the JAX kernel's, each against the exact
    sums; hinge counts also equal each other."""
    _check_sums(name, s1, s2, *got, port=True)
    _check_sums(name, s1, s2, *want, port=False)
    if name == "hinge":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", GRAD_NAMES)
@pytest.mark.parametrize("n1,n2", SHAPES)
def test_pair_loss_grad_plain_matches_pallas(name, n1, n2):
    s1, s2 = _scores(n1, n2)
    wl, wr, wc = jp.pallas_pair_loss_grad(
        jnp.asarray(s1), jnp.asarray(s2), kernel=jk.get_kernel(name),
        tile_a=256, tile_b=256, interpret=True)
    gl, gr, gc = pg.pair_loss_grad_plain(
        torch.from_numpy(s1), torch.from_numpy(s2), tk.get_kernel(name))
    assert gl.dtype == torch.float64 and gr.dtype == torch.float32
    assert gr.shape == (n1,) and gc.shape == (n2,)
    _check(name, s1, s2, (gr, gc),
           (np.asarray(wr).ravel(), np.asarray(wc).ravel()))
    np.testing.assert_allclose(float(gl), float(wl), rtol=2e-5)


@pytest.mark.parametrize("name", GRAD_NAMES)
@pytest.mark.parametrize("n1,n2", SHAPES)
def test_pair_grad_sums_plain_matches_pallas(name, n1, n2):
    s1, s2 = _scores(n1, n2, seed=8)
    wr, wc = jp.pallas_pair_grad_sums(
        jnp.asarray(s1), jnp.asarray(s2), kernel=jk.get_kernel(name),
        tile_a=256, tile_b=256, interpret=True)
    a, b = torch.from_numpy(s1), torch.from_numpy(s2)
    gr, gc = pg.pair_grad_sums_plain(a, b, tk.get_kernel(name))
    _check(name, s1, s2, (gr, gc),
           (np.asarray(wr).ravel(), np.asarray(wc).ravel()))
    # the loss+grad pass gives the same row and col
    _, lr, lc = pg.pair_loss_grad(a, b, tk.get_kernel(name))
    assert torch.equal(lr, gr) and torch.equal(lc, gc)
    # pair_tiles.pair_grad_sums is the same plain sweep (JAX signature)
    tr, tc = pair_tiles.pair_grad_sums(tk.get_kernel(name), a, b)
    assert torch.equal(tr, gr) and torch.equal(tc, gc)


def test_logistic_70x90_row_sums_within_derived_bound():
    """The inputs of the case that once missed rtol 2e-5 port-vs-JAX in a
    whole parallel run (2 of 70 rows at rel 2.1e-5, passing alone): both
    packages' row and col sums sit far inside their derived bounds here,
    and a rel 2.1e-5 error on these rows is over 3x the JAX bound, so it
    cannot come from float32 summation order. Each side is held against
    the exact sums, so a recurrence names the side whose terms moved."""
    s1, s2 = _scores(70, 90)
    k = "logistic"
    _, wr, wc = jp.pallas_pair_loss_grad(
        jnp.asarray(s1), jnp.asarray(s2), kernel=jk.get_kernel(k),
        tile_a=256, tile_b=256, interpret=True)
    _, gr, gc = pg.pair_loss_grad_plain(
        torch.from_numpy(s1), torch.from_numpy(s2), tk.get_kernel(k))
    port = _check_sums(k, s1, s2, gr, gc, port=True)
    ref = _check_sums(k, s1, s2, np.asarray(wr).ravel(),
                      np.asarray(wc).ravel(), port=False)
    assert port < 0.5 and ref < 0.5, (port, ref)
    t = _exact_terms(k, s1, s2)
    assert (t < 0).all()            # one sign: sum|t| = |sum|
    assert (90 + _TERM_U) * _U32 < 2.1e-5 / 3


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_batched_form_equals_a_loop_over_problems(name):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((5, 130)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((5, 77)).astype(np.float32))
    k = tk.get_kernel(name)
    loss, row, col = pg.pair_loss_grad(a, b, k)
    assert loss.shape == (5,) and row.shape == (5, 130) and col.shape == (5, 77)
    for w in range(5):
        lw, rw, cw = pg.pair_loss_grad(a[w], b[w], k)
        torch.testing.assert_close(loss[w], lw, rtol=1e-12, atol=0)
        if name == "hinge":
            assert torch.equal(row[w], rw) and torch.equal(col[w], cw)
        else:
            torch.testing.assert_close(row[w], rw, rtol=1e-6, atol=0)
            torch.testing.assert_close(col[w], cw, rtol=1e-6, atol=0)


def test_loss_matches_pair_sum():
    s1, s2 = _scores(300, 517)
    a, b = torch.from_numpy(s1), torch.from_numpy(s2)
    for name in GRAD_NAMES:
        k = tk.get_kernel(name)
        loss, _, _ = pg.pair_loss_grad(a, b, k)
        assert abs(float(loss) - float(pk.pair_sum(a, b, k))) \
            <= 1e-6 * abs(float(loss))


def _jax_grad(fn_name, name, s1, s2):
    k = jk.get_kernel(name)
    fn = getattr(jt, fn_name)
    return jax.value_and_grad(lambda a, b: fn(k, a, b, 32, 32),
                              argnums=(0, 1))(jnp.asarray(s1), jnp.asarray(s2))


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_diff_pair_mean_gradient_matches_jax(name):
    s1, s2 = _scores(130, 70, seed=11)
    wv, (wg1, wg2) = _jax_grad("diff_pair_mean", name, s1, s2)
    a = torch.from_numpy(s1).requires_grad_()
    b = torch.from_numpy(s2).requires_grad_()
    v = pair_tiles.diff_pair_mean(tk.get_kernel(name), a, b)
    g1, g2 = torch.autograd.grad(v, (a, b))
    assert abs(float(v.detach()) - float(wv)) < 1e-6
    np.testing.assert_allclose(g1.numpy(), np.asarray(wg1), atol=1e-7)
    np.testing.assert_allclose(g2.numpy(), np.asarray(wg2), atol=1e-7)


@pytest.mark.parametrize("name", GRAD_NAMES)
def test_loss_free_mean_gives_nan_and_the_same_gradient(name):
    s1, s2 = _scores(90, 110, seed=12)
    wv, (wg1, wg2) = _jax_grad("diff_pair_mean_loss_free", name, s1, s2)
    assert np.isnan(float(wv))
    k = tk.get_kernel(name)
    a = torch.from_numpy(s1).requires_grad_()
    b = torch.from_numpy(s2).requires_grad_()
    v = pair_tiles.diff_pair_mean_loss_free(k, a, b)
    assert torch.isnan(v) and v.shape == ()
    g1, g2 = torch.autograd.grad(v, (a, b))
    np.testing.assert_allclose(g1.numpy(), np.asarray(wg1), atol=1e-7)
    np.testing.assert_allclose(g2.numpy(), np.asarray(wg2), atol=1e-7)
    f1, f2 = torch.autograd.grad(pair_tiles.diff_pair_mean(k, a, b), (a, b))
    assert torch.equal(g1, f1) and torch.equal(g2, f2)


def test_batched_pair_mean_gradient_matches_dense_autograd():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 25)).astype(np.float32))
    k = tk.logistic_kernel
    a.requires_grad_()
    b.requires_grad_()
    v = pair_tiles.pair_mean_for_grad(k, a, b)
    assert v.shape == (3,)
    g = torch.autograd.grad((v * torch.arange(1.0, 4.0)).sum(), (a, b))
    dense = k.diff(a[:, :, None] - b[:, None, :]).mean(dim=(1, 2))
    d = torch.autograd.grad((dense * torch.arange(1.0, 4.0)).sum(), (a, b))
    torch.testing.assert_close(v, dense, rtol=1e-6, atol=0)
    for x, y in zip(g, d):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-7)


def test_pair_mean_for_grad_user_kernels_take_the_plain_paths():
    # a user kernel with g' but no CUDA body: the analytic plain sweep;
    # one without g': autograd through the plain tiled mean
    with_gp = tk.Kernel(name="sq", degree=2, two_sample=True, kind="diff",
                        diff_fn=lambda d: (1.0 - d) ** 2,
                        diff_grad_fn=lambda d: -2.0 * (1.0 - d))
    no_gp = tk.Kernel(name="sq2", degree=2, two_sample=True, kind="diff",
                      diff_fn=lambda d: (1.0 - d) ** 2)
    s1, s2 = _scores(50, 60, seed=5)
    grads = []
    for k in (with_gp, no_gp):
        a = torch.from_numpy(s1).requires_grad_()
        b = torch.from_numpy(s2).requires_grad_()
        v = pair_tiles.pair_mean_for_grad(k, a, b)
        grads.append((float(v), *torch.autograd.grad(v, (a, b))))
    assert abs(grads[0][0] - grads[1][0]) < 1e-5
    for x, y in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)


def test_dispatch_on_the_cpu_and_errors():
    s1, s2 = _scores(64, 48)
    a, b = torch.from_numpy(s1), torch.from_numpy(s2)
    pk.reset_launch_counts()
    for name in GRAD_NAMES:
        k = tk.get_kernel(name)
        got = pg.pair_loss_grad(a, b, k)
        want = pg.pair_loss_grad(a, b, k, impl="plain")
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert sum(pk.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="impl"):
        pg.pair_grad_sums(a, b, tk.hinge_kernel, impl="xla")
    with pytest.raises(ValueError, match="diff_grad_fn"):
        pg.pair_loss_grad(a, b, tk.auc_kernel)
    with pytest.raises(ValueError, match="diff_grad_fn"):
        pg.pair_grad_sums(a, b, tk.scatter_kernel)
    empty = pg.pair_loss_grad(a[:0], b, tk.hinge_kernel)
    assert float(empty[0]) == 0.0 and empty[1].shape == (0,)
    assert torch.equal(empty[2], torch.zeros(48))


def test_grid_shape_and_scratch():
    # the trainer's headline: 245 row tiles, column segments up to the
    # target block count, none empty; ~0.5 GB of partials
    gx, gs, per_seg = pg.grid_shape(500_000, 500_000, 1, 2048, 1024)
    assert gx == 245 and gs * per_seg >= 489 and (gs - 1) * per_seg < 489
    assert gx * gs >= pg._TARGET_BLOCKS
    assert pg.scratch_bytes(500_000, 500_000) == 508_017_640
    # a batch of problems fills the grid alone: one segment
    assert pg.grid_shape(16, 16, 1536, 2048, 1024) == (1, 1, 1)
    for n1, n2, W in [(1, 1, 1), (4133, 8197, 8), (3000, 70_000, 2)]:
        gx, gs, per_seg = pg.grid_shape(n1, n2, W, 2048, 1024)
        gy = -(-n2 // 1024)
        assert (gs - 1) * per_seg < gy <= gs * per_seg


def test_hinge_routes_to_the_sort_and_search_kernel(monkeypatch):
    """The dispatch of a CUDA tensor, with the launchers stubbed so that
    it runs here: the hinge body goes to rank_count.hinge_grad and never
    to the pair sweep of pair_grad.cu, the logistic body the other way;
    each call counts one launch under its wrapper's key."""
    from tuplewise_tpu_torch.ops import rank_count

    calls = []

    def outputs(a, b, with_loss):
        W, n1, n2 = a.shape[0], a.shape[1], b.shape[1]
        return (torch.zeros(W, dtype=torch.float64) if with_loss else None,
                torch.zeros(W, n1), torch.zeros(W, n2))

    def hinge_grad(a, b, with_loss):
        calls.append(("sort-and-search", with_loss))
        return outputs(a, b, with_loss)

    def sweep(name, a, b, kernel, with_loss):
        calls.append(("sweep", kernel.name))
        return outputs(a, b, with_loss)

    monkeypatch.setattr(rank_count, "hinge_grad", hinge_grad)
    monkeypatch.setattr(pg, "_launch_sweep", sweep)
    a, b = torch.zeros(2, 5), torch.zeros(2, 3)
    pk.reset_launch_counts()
    loss, row, col = pg._launch("pair_loss_grad", a, b, tk.hinge_kernel, True)
    assert loss.shape == (2,) and row.shape == (2, 5) and col.shape == (2, 3)
    row, col = pg._launch("pair_grad_sums", a[0], b[0], tk.hinge_kernel,
                          False)
    assert row.shape == (5,) and col.shape == (3,)
    pg._launch("pair_grad_sums", a, b, tk.logistic_kernel, False)
    assert calls == [("sort-and-search", True), ("sort-and-search", False),
                     ("sweep", "logistic")]
    assert pk.LAUNCHES["pair_loss_grad[hinge]"] == 1
    assert pk.LAUNCHES["pair_grad_sums[hinge]"] == 1
    pk.reset_launch_counts()


def _bits(t):
    return t.contiguous().view(torch.int32)


def _nonfinite_close(got, want, rtol):
    """NaN positions equal, infinities equal, finite values within rtol."""
    assert torch.equal(got.isnan(), want.isnan())
    inf = want.isinf()
    assert torch.equal(got.isinf(), inf) and torch.equal(got[inf], want[inf])
    fin = want.isfinite()
    if fin.any():
        torch.testing.assert_close(got[fin], want[fin], rtol=rtol, atol=0)


def _edge_on_card(gen, frac, *shape):
    """Normal scores with a fraction frac drawn from +-inf, NaN of both
    signs, +-0.0, subnormals and +-1, and a fifth rounded (ties)."""
    x = torch.randn(*shape, generator=gen, device="cuda")
    pool = torch.tensor([math.inf, -math.inf, math.nan, -math.nan, 0.0, -0.0,
                         1.0, -1.0, 1e-45, -1e-45], device="cuda")
    at = torch.randint(0, len(pool), shape, generator=gen, device="cuda")
    x = torch.where(torch.rand(*shape, generator=gen, device="cuda") < frac,
                    pool[at], x)
    return torch.where(torch.rand(*shape, generator=gen, device="cuda") < 0.2,
                       x.round(), x)


@pytest.mark.cuda
def test_grad_kernels_match_plain_on_card():
    """Both bodies against plain: scores of early training, then edge
    values at ragged shapes (the last tile of each side holds padding:
    the hinge route's tiles are 256, 2048, 8192 or 16384 values, the
    logistic sweep's 2048 x 1024) and a -inf score beside ragged columns.
    hinge row and col equal, logistic within rel 1e-4; the loss within
    rel 1e-5; NaN and infinities where plain has them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA gradient kernels have no "
                    "CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(1, 4133, 8197, None), (8, 300, 517, None), (64, 16, 16, None),
             (3, 300, 517, 0.3), (2, 2100, 17000, 1e-3),
             (1, 17, 20000, 0.3), (5, 16, 16, 0.2), (2, 300, 1500, "-inf")]
    for W, n1, n2, frac in cases:
        if frac is None or frac == "-inf":
            a = torch.randn(W, n1, generator=g, device="cuda") * 0.5 + 0.3
            b = torch.randn(W, n2, generator=g, device="cuda") * 0.5
            if frac == "-inf":
                a[0, 3], b[1, 7] = -math.inf, math.inf
        else:
            a, b = _edge_on_card(g, frac, W, n1), _edge_on_card(g, frac, W, n2)
        b[:, :3] = a[:, :3] - 1.0                       # d == 1
        for name in GRAD_NAMES:
            k = tk.get_kernel(name)
            loss, row, col = pg.pair_loss_grad(a, b, k)
            row2, col2 = pg.pair_grad_sums(a, b, k)
            lp, rp, cp = pg.pair_loss_grad(a, b, k, impl="plain")
            assert torch.equal(_bits(row), _bits(row2))
            assert torch.equal(_bits(col), _bits(col2))
            _nonfinite_close(loss, lp, 1e-5)
            if name == "hinge":
                assert torch.equal(row, rp) and torch.equal(col, cp)
            else:
                _nonfinite_close(row, rp, 1e-4)
                _nonfinite_close(col, cp, 1e-4)
        if frac == "-inf":
            assert lp.isinf().all(), lp


@pytest.mark.cuda
def test_loss_and_loss_free_kernels_agree_bitwise_on_card():
    """Kernel 3's row and col equal kernel 4's bit for bit, with a NaN
    score (the logistic row and col are NaN there, the hinge's 0 terms)
    and with an infinite one, for both bodies; the hinge counts also
    repeat from call to call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA gradient kernels have no "
                    "CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    for special in (math.nan, math.inf, -math.inf):
        a = torch.randn(3, 5000, generator=g, device="cuda")
        b = torch.randn(3, 3001, generator=g, device="cuda")
        a[0, 17], b[1, 3000], a[2, 0] = special, special, special
        for name in GRAD_NAMES:
            k = tk.get_kernel(name)
            _, row, col = pg.pair_loss_grad(a, b, k)
            row2, col2 = pg.pair_grad_sums(a, b, k)
            assert torch.equal(_bits(row), _bits(row2)), (name, special)
            assert torch.equal(_bits(col), _bits(col2)), (name, special)
            _, row3, col3 = pg.pair_loss_grad(a, b, k)
            assert torch.equal(_bits(row), _bits(row3)), (name, special)
            assert torch.equal(_bits(col), _bits(col3)), (name, special)
            if name == "logistic" and math.isnan(special):
                assert row[0, 17].isnan() and col[1, 3000].isnan()
