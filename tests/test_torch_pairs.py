"""The port's pair sums, rank AUC and scatter closed form against the JAX
package, on the same numpy-made inputs.

The JAX Pallas kernels run in interpret mode at small tiles (256 x 512),
as tests/test_pallas_and_rank.py runs them. Tolerances: AUC sums are
exact in both packages (float32 sums of halves below 2^23 per partial,
float64 or Kahan above), so they must be equal; hinge and logistic sums
agree within rel 1e-6 (float32 values summed in different orders: Kahan
float32 in JAX, float64 in the port).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import pallas_pairs as jp
from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu.ops.rank_auc import rank_auc as j_rank_auc
from tuplewise_tpu.ops.scatter_exact import scatter_pair_stats as j_scatter
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.ops import kernels as tk
from tuplewise_tpu_torch.ops import pair_tiles
from tuplewise_tpu_torch.ops.rank_auc import rank_auc
from tuplewise_tpu_torch.ops.scatter_exact import scatter_pair_stats

NAMES = ("auc", "hinge", "logistic")


@pytest.fixture(scope="module")
def scores():
    rng = np.random.default_rng(5)
    s1 = (rng.normal(size=2048) + 1.0).astype(np.float32)
    s2 = rng.normal(size=1024).astype(np.float32)
    s1[:40] = s2[:40]                      # exact ties
    return s1, s2


def _close(got, want, name):
    if name == "auc":
        assert got == want, (got, want)
    else:
        assert abs(got - want) / max(abs(want), 1.0) < 1e-6, (name, got, want)


@pytest.mark.parametrize("name", NAMES)
def test_pair_sum_matches_pallas(scores, name):
    s1, s2 = scores
    want = float(jp.pallas_pair_sum(
        jnp.asarray(s1), jnp.asarray(s2), kernel=jk.get_kernel(name),
        tile_a=256, tile_b=512, interpret=True))
    got = float(pk.pair_sum(torch.from_numpy(s1), torch.from_numpy(s2),
                            tk.get_kernel(name)))
    _close(got, want, name)


@pytest.mark.parametrize("name", NAMES)
def test_pair_sum_any_matches_pallas_at_ragged_sizes(scores, name):
    s1, s2 = scores
    for n1, n2 in [(2047, 1023), (130, 1024), (1, 513)]:
        want = float(jp.pallas_pair_sum_any(
            jnp.asarray(s1[:n1]), jnp.asarray(s2[:n2]),
            kernel=jk.get_kernel(name), tile_a=256, tile_b=512,
            interpret=True))
        got = float(pk.pair_sum_any(torch.from_numpy(s1[:n1]),
                                    torch.from_numpy(s2[:n2]),
                                    tk.get_kernel(name)))
        _close(got, want, name)


@pytest.mark.parametrize("name", NAMES)
def test_masked_pair_sum_matches_pallas(scores, name):
    s1, s2 = scores
    rng = np.random.default_rng(3)
    a, b = s1[:1237], s2[:1011]
    ma = rng.integers(0, 2, 1237).astype(np.float32)
    mb = rng.integers(0, 2, 1011).astype(np.float32)
    want = float(jp.pallas_masked_pair_sum(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ma), jnp.asarray(mb),
        kernel=jk.get_kernel(name), tile_a=256, tile_b=512, interpret=True))
    got = float(pk.masked_pair_sum(
        *(torch.from_numpy(x) for x in (a, b, ma, mb)), tk.get_kernel(name)))
    _close(got, want, name)


def test_batched_pair_sum_equals_per_problem_sums(scores):
    s1, s2 = scores
    a = torch.from_numpy(s1[:1200]).reshape(4, 300)
    b = torch.from_numpy(s2[:1000]).reshape(4, 250)
    for name in NAMES:
        k = tk.get_kernel(name)
        got = pk.pair_sum(a, b, k)
        want = torch.stack([pk.pair_sum(a[w], b[w], k) for w in range(4)])
        assert got.shape == (4,) and got.dtype == torch.float64
        torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


def test_pair_stats_matches_jax_with_masks_and_ids(scores):
    from tuplewise_tpu.ops import pair_tiles as jt

    s1, s2 = scores
    rng = np.random.default_rng(7)
    a, b = s1[:300], s2[:260]
    ma = rng.integers(0, 2, 300).astype(np.float32)
    ids_a = rng.integers(0, 200, 300).astype(np.int32)
    ids_b = rng.integers(0, 200, 260).astype(np.int32)
    for name in NAMES:
        ws, wc = jt.pair_stats(jk.get_kernel(name), jnp.asarray(a),
                               jnp.asarray(b), mask_a=jnp.asarray(ma),
                               ids_a=jnp.asarray(ids_a),
                               ids_b=jnp.asarray(ids_b), tile_a=128,
                               tile_b=128)
        gs, gc = pair_tiles.pair_stats(
            tk.get_kernel(name), torch.from_numpy(a), torch.from_numpy(b),
            mask_a=torch.from_numpy(ma), ids_a=torch.from_numpy(ids_a),
            ids_b=torch.from_numpy(ids_b), tile_a=128, tile_b=100)
        assert int(gc) == int(wc)
        _close(float(gs), float(ws), name)


def test_rank_auc_matches_jax_and_pair_sum_exactly():
    rng = np.random.default_rng(11)
    # rounded scores: many ties across and within classes
    pos = np.round(rng.normal(1.0, 1.0, 3001), 1).astype(np.float32)
    neg = np.round(rng.normal(0.0, 1.0, 2003), 1).astype(np.float32)
    got = rank_auc(torch.from_numpy(pos), torch.from_numpy(neg))
    assert got.dtype == torch.float64
    assert abs(float(got) - float(j_rank_auc(jnp.asarray(pos),
                                             jnp.asarray(neg)))) < 1e-6
    s = pk.pair_sum(torch.from_numpy(pos), torch.from_numpy(neg),
                    tk.auc_kernel)
    assert float(s / float(pos.size * neg.size)) == float(got)


def test_scatter_closed_form_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    ids = rng.integers(0, 40, 64).astype(np.int32)
    mask = rng.integers(0, 2, 64).astype(np.float32)
    ws, wc = j_scatter(jnp.asarray(X), jnp.asarray(X), jnp.asarray(mask),
                       jnp.asarray(mask), jnp.asarray(ids), jnp.asarray(ids))
    t = torch.from_numpy
    gs, gc = scatter_pair_stats(t(X), t(X), t(mask), t(mask), t(ids), t(ids))
    assert float(gc) == float(wc)
    assert abs(float(gs) - float(ws)) / abs(float(ws)) < 1e-5


def test_cpu_tensors_take_the_plain_version(scores):
    s1, s2 = scores
    pk.reset_launch_counts()
    a, b = torch.from_numpy(s1), torch.from_numpy(s2)
    for name in NAMES:
        k = tk.get_kernel(name)
        assert float(pk.pair_sum(a, b, k)) == float(pk.pair_sum_plain(a, b, k))
    assert sum(pk.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="impl"):
        pk.pair_sum(a, b, tk.auc_kernel, impl="xla")
    with pytest.raises(ValueError, match="diff kernels"):
        pk.pair_sum(a, b, tk.scatter_kernel)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA pair kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(8, 4133, generator=g, device="cuda") + 1.0
    b = torch.randn(8, 8197, generator=g, device="cuda")
    ma = (torch.rand(8, 4133, generator=g, device="cuda") > 0.3).float()
    mb = (torch.rand(8, 8197, generator=g, device="cuda") > 0.3).float()
    for name in NAMES:
        k = tk.get_kernel(name)
        for got, want in [
            (pk.pair_sum(a, b, k), pk.pair_sum(a, b, k, impl="plain")),
            (pk.masked_pair_sum(a, b, ma, mb, k),
             pk.masked_pair_sum(a, b, ma, mb, k, impl="plain")),
        ]:
            if name == "auc":
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
