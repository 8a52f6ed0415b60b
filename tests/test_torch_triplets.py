"""The port's degree-3 reductions (ops.triplet_kernels, the triplet half of
ops.pair_tiles) against the JAX package, on the same numpy-made inputs.

The JAX Pallas kernel runs in interpret mode at small tiles, as
tests/test_pallas_and_rank.py runs it. Tolerances: counts are integers
and must be equal; indicator sums are integers too, but the two
packages' distance products round differently (the JAX product on the
CPU, the port's plain one), so sums agree within rel 1e-6, the JAX
test's own tolerance; within the port, the kernel's plain version and
the tiled scan see the same float32 terms and are compared at rel 1e-6
(hinge) or exactly (indicator on one distance source).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops.pair_tiles import triplet_stats as j_triplet_stats
from tuplewise_tpu.ops.pallas_triplets import _sqdist_matrix as j_sqdist
from tuplewise_tpu.ops.pallas_triplets import pallas_triplet_stats
from tuplewise_tpu_torch.ops import pair_kernels, pair_tiles
from tuplewise_tpu_torch.ops import triplet_kernels as tk
from tuplewise_tpu_torch.ops.kernels import (
    Kernel, builtin_triplet_spec, get_kernel,
)

NAMES = ("triplet_indicator", "triplet_hinge")


@pytest.fixture(scope="module")
def data():
    # the inputs of tests/test_pallas_and_rank.py::test_parity_with_xla_tiles
    rng = np.random.default_rng(0)
    X = rng.normal(size=(45, 5)).astype(np.float32)
    Y = rng.normal(size=(37, 5)).astype(np.float32) + np.float32(0.3)
    mx = (rng.random(45) > 0.2).astype(np.float32)
    my = (rng.random(37) > 0.3).astype(np.float32)
    Pv = rng.normal(size=(29, 5)).astype(np.float32)
    return X, Y, mx, my, Pv


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1.0)


@pytest.mark.parametrize("name", NAMES)
def test_factorized_matches_pallas_and_tiles(data, name):
    X, Y, mx, my, Pv = data
    k, jkern = get_kernel(name), jk.get_kernel(name)
    ids = np.arange(45, dtype=np.int32)
    cases = [
        (dict(mask_x=mx, mask_y=my, ids_x=ids), {}),
        # visiting positives (the double ring's block), ids 100+
        (dict(mask_y=my, ids_x=ids),
         dict(positives=Pv, ids_p=100 + np.arange(29, dtype=np.int32))),
    ]
    for kw, vis in cases:
        jkw = {a: jnp.asarray(v) for a, v in {**kw, **vis}.items()}
        sp, cp = pallas_triplet_stats(
            jkern, jnp.asarray(X), jnp.asarray(Y), anchor_chunk=16,
            tile_p=8, tile_k=128, interpret=True, **jkw)
        sx, cx = j_triplet_stats(jkern, jnp.asarray(X), jnp.asarray(Y),
                                 tile=16, **jkw)
        tkw = {a: _t(v) for a, v in {**kw, **vis}.items()}
        s, c = tk.factorized_triplet_stats(k, _t(X), _t(Y), **tkw)
        s2, c2 = pair_tiles.triplet_stats(k, _t(X), _t(Y), tile=16, **tkw)
        assert s.dtype == torch.float64 and c.dtype == torch.int64
        assert int(c) == int(c2) == int(cx) == int(cp)
        for want in (sp, sx, s2):
            assert _rel(s, want) < 1e-6, (name, float(s), float(want))


@pytest.mark.parametrize("name", NAMES)
def test_anchor_chunks_and_best_dispatch_agree(data, name):
    X, Y, mx, my, _ = data
    k = get_kernel(name)
    base = tk.factorized_triplet_stats(k, _t(X), _t(Y), _t(mx), _t(my))
    for chunk in (1, 7, 45):
        # another chunk is another product shape, rounded differently
        s, c = tk.factorized_triplet_stats(k, _t(X), _t(Y), _t(mx), _t(my),
                                           anchor_chunk=chunk)
        assert int(c) == int(base[1])
        assert _rel(s, base[0]) < 1e-6
    s, c = tk.triplet_stats_best(k, _t(X), _t(Y), mask_x=_t(mx),
                                 mask_y=_t(my))
    assert (float(s), int(c)) == (float(base[0]), int(base[1]))


@pytest.mark.parametrize("name", NAMES)
def test_batched_sum_equals_a_loop_over_problems(name):
    rng = np.random.default_rng(1)
    G, C, P, K = 3, 5, 23, 17
    A = _t(rng.normal(size=(G * C, P)).astype(np.float32) * 3)
    B = _t(rng.normal(size=(G * C, K)).astype(np.float32) * 3)
    mp = _t((rng.random((G, P)) > 0.2).astype(np.float32))
    mk = _t((rng.random((G, K)) > 0.2).astype(np.float32))
    ip = _t(rng.integers(0, 9, (G, P)))
    ia = _t(rng.integers(0, 9, G * C))
    comb = tk.triplet_combine_kernel(get_kernel(name))
    got = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb,
                                     anchors_per_group=C)
    assert got.shape == (G * C,) and got.dtype == torch.float64
    for w in range(G * C):
        q = w // C
        one = tk.batched_masked_pair_sum(A[w:w + 1], B[w:w + 1], mp[q:q + 1],
                                         ip[q:q + 1], ia[w:w + 1],
                                         mk[q:q + 1], comb)
        d = A[w][:, None] - B[w][None, :]
        wgt = (mp[q] * (ip[q] != ia[w]))[:, None] * mk[q][None, :]
        dense = (comb.g(d) * wgt).double().sum()
        assert float(one[0]) == float(got[w])
        assert _rel(got[w], dense) < 1e-12


def test_positive_counts_and_grouped_stats_match_brute_force():
    rng = np.random.default_rng(2)
    ip = _t(rng.integers(0, 6, (2, 11)))
    mp = _t((rng.random((2, 11)) > 0.3).astype(np.float32))
    ia = _t(rng.integers(0, 8, (2, 4)))
    got = tk.positive_counts(mp, ip, ia)
    want = ((mp[:, None, :] > 0) & (ip[:, None, :] != ia[:, :, None])).sum(-1)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    # grouped (local-round) stats = the tiled scan per group, global ids
    Xa = _t(rng.normal(size=(2, 9, 3)).astype(np.float32))
    Yb = _t(rng.normal(size=(2, 7, 3)).astype(np.float32))
    ids = _t(rng.integers(0, 5, (2, 9)))            # with duplicates
    for name in NAMES:
        k = get_kernel(name)
        sums, counts = tk.grouped_triplet_stats(k, Xa, Yb, ids)
        for q in range(2):
            s, c = pair_tiles.triplet_stats(k, Xa[q], Yb[q], ids_x=ids[q],
                                            tile=4)
            assert int(counts[q]) == int(c)
            assert _rel(sums[q], s) < 1e-6


def test_sqdist_matrix_matches_jax_unclamped_and_keeps_tf32_setting():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 4)).astype(np.float32)
    b = np.concatenate([a[:2], rng.normal(size=(5, 4)).astype(np.float32)])
    want = np.asarray(j_sqdist(jnp.asarray(a), jnp.asarray(b)))
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        got = tk.sqdist_matrix(_t(a), _t(b)).numpy()
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = saved
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # batched form: one [..., m, k] block per leading index
    batched = tk.sqdist_matrix(_t(np.stack([a, a])), _t(np.stack([b, b])))
    torch.testing.assert_close(batched[1], _t(got), rtol=1e-5, atol=1e-5)


def test_custom_triplet_kernel_takes_the_plain_scan(data):
    X, Y, mx, my, _ = data
    custom = Kernel(
        name="triplet_custom", degree=3, two_sample=True, kind="triplet",
        triplet_fn=lambda a, p, n: torch.sum((a - p) * (a - n), dim=-1),
    )
    assert tk.triplet_combine_kernel(custom) is None
    with pytest.raises(ValueError, match="factorization"):
        tk.factorized_triplet_stats(custom, _t(X), _t(Y))
    s, c = tk.triplet_stats_best(custom, _t(X), _t(Y), mask_y=_t(my),
                                 tile=16)
    s2, c2 = pair_tiles.triplet_stats(custom, _t(X), _t(Y), mask_y=_t(my))
    assert int(c) == int(c2) and _rel(s, s2) < 1e-9
    jcustom = jk.Kernel(
        name="triplet_custom", degree=3, two_sample=True, kind="triplet",
        triplet_fn=lambda a, p, n, xp: xp.sum((a - p) * (a - n), axis=-1),
    )
    sj, cj = j_triplet_stats(jcustom, jnp.asarray(X), jnp.asarray(Y),
                             mask_y=jnp.asarray(my), tile=16)
    assert int(c) == int(cj) and _rel(s, sj) < 1e-5


def test_builtin_triplet_spec_is_identity_dispatch():
    for name in NAMES:
        assert builtin_triplet_spec(get_kernel(name)) == \
            jk.builtin_triplet_spec(jk.get_kernel(name))
    assert builtin_triplet_spec(get_kernel("triplet_indicator")) == \
        ("indicator", 0.0)
    assert builtin_triplet_spec(get_kernel("triplet_hinge")) == ("hinge", 1.0)
    # a kernel under a built-in NAME with another function never matches
    shadow = Kernel(name="triplet_indicator", degree=3, two_sample=True,
                    kind="triplet", triplet_fn=lambda a, p, n: a.sum(-1))
    assert builtin_triplet_spec(shadow) is None
    # the built-in FUNCTION under another name does
    alias = Kernel(name="my_hinge", degree=3, two_sample=True, kind="triplet",
                   triplet_fn=get_kernel("triplet_hinge").triplet_fn)
    comb = tk.triplet_combine_kernel(alias)
    assert (comb.kind, comb.margin, comb.name) == ("hinge", 1.0,
                                                   "triplet_hinge")
    assert builtin_triplet_spec(get_kernel("auc")) is None


@pytest.mark.parametrize("name", NAMES)
def test_incomplete_triplet_mean_is_unbiased(data, name):
    X, Y, _, _, _ = data
    k = get_kernel(name)
    s, c = tk.factorized_triplet_stats(k, _t(X), _t(Y))
    full = float(s) / int(c)
    gen = torch.Generator().manual_seed(4)
    vals = [float(pair_tiles.incomplete_triplet_mean(k, gen, _t(X), _t(Y),
                                                     2000))
            for _ in range(20)]
    se = np.std(vals, ddof=1) / np.sqrt(len(vals))
    assert abs(np.mean(vals) - full) < 4 * se + 1e-9
    # the shift trick never draws i == j
    i, j = pair_tiles.sample_pair_indices(gen, 5, 5, 4000, True)
    assert bool((i != j).all()) and int(j.max()) == 4


def test_dispatch_and_errors():
    rng = np.random.default_rng(5)
    A = _t(rng.normal(size=(4, 6)).astype(np.float32))
    B = _t(rng.normal(size=(4, 5)).astype(np.float32))
    mp, mk = torch.ones(1, 6), torch.ones(1, 5)
    ip, ia = torch.arange(6)[None], torch.arange(4)
    comb = tk.triplet_combine_kernel(get_kernel("triplet_hinge"))
    pair_kernels.reset_launch_counts()
    want = tk.batched_masked_pair_sum_plain(A, B, mp, ip, ia, mk, comb)
    for impl in (None, "kernel", "plain"):
        got = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb,
                                         impl=impl)
        assert torch.equal(got, want)
    assert not pair_kernels.LAUNCHES        # CPU tensors: plain, no launch
    with pytest.raises(ValueError, match="impl"):
        tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, impl="xla")
    with pytest.raises(ValueError, match="groups of 3"):
        tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb,
                                   anchors_per_group=3)
    with pytest.raises(ValueError, match="mk must be"):
        tk.batched_masked_pair_sum(A, B, mp, ip, ia, torch.ones(1, 4), comb)
    with pytest.raises(ValueError, match="ip must be"):
        tk.batched_masked_pair_sum(A, B, mp, ip.int(), ia, mk, comb)
    with pytest.raises(TypeError, match="float32"):
        tk.batched_masked_pair_sum(A.double(), B.double(), mp, ip, ia, mk,
                                   comb)
    with pytest.raises(ValueError, match="expected A"):
        tk.batched_masked_pair_sum(A, B[:3], mp, ip, ia, mk, comb)
    with pytest.raises(ValueError, match="contiguous"):
        tk.batched_masked_pair_sum(A.t().contiguous().t(), B, mp, ip, ia,
                                   mk, comb)


@pytest.mark.cuda
def test_triplet_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA triplet kernel has no CPU "
                    "mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for name in NAMES:
        comb = tk.triplet_combine_kernel(get_kernel(name))
        for W, C, P, K in [(45, 45, 45, 37), (300, 300, 2100, 4133),
                           (800, 100, 100, 150)]:
            G = W // C
            A = torch.randn(W, P, generator=g, device="cuda") * 8
            B = torch.randn(W, K, generator=g, device="cuda") * 8
            mp = (torch.rand(G, P, generator=g, device="cuda") > 0.2).float()
            mk = (torch.rand(G, K, generator=g, device="cuda") > 0.2).float()
            ip = torch.randint(0, P, (G, P), generator=g, device="cuda")
            ia = torch.randint(0, P, (W,), generator=g, device="cuda")
            got = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C)
            want = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C,
                                              impl="plain")
            torch.cuda.synchronize()
            if name == "triplet_indicator":
                assert torch.equal(got, want), (W, P, K)
            else:
                rel = ((got - want).abs() / want.abs().clamp_min(1)).max()
                assert float(rel) < 1e-5, (W, P, K)
