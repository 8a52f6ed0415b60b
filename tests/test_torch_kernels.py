"""The port's kernel table against the JAX package's: g and g' on grids
that include ties (d == 0), -0.0 and the hinge kink (d == 1).

Tolerances: auc and hinge are exact (comparisons and one subtraction in
float32 round the same way everywhere). logistic agrees within rel 1e-6:
the port uses max(-d, 0) + log1p(exp(-|d|)) (the form of the CUDA body),
the JAX package logaddexp(0, -d); both are within a few float32 ulps of
the true value. Below the smallest normal float32 the comparison is
absolute (atol = float32 tiny): XLA on the CPU flushes subnormal results
to zero, torch keeps them (g(88) ~ 6e-39).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import kernels as jk
from tuplewise_tpu_torch.ops import kernels as tk


_TINY = float(np.finfo(np.float32).tiny)


def _grid():
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, 1.0, -1.0, 1.0 - 2**-23, 1.0 + 2**-23,
                        2**-30, -(2**-30), 30.0, -30.0, 88.0, -88.0],
                       np.float32)
    return np.concatenate([special, rng.normal(0, 3, 4096).astype(np.float32),
                           np.linspace(-5, 5, 1001, dtype=np.float32)])


def _port(fn, d):
    return fn(torch.from_numpy(d)).numpy()


@pytest.mark.parametrize("name", ["auc", "hinge", "logistic"])
def test_diff_body_matches_jax(name):
    d = _grid()
    want = np.asarray(jk.get_kernel(name).diff(jnp.asarray(d), jnp))
    got = _port(tk.get_kernel(name).diff, d)
    assert got.dtype == np.float32
    if name == "logistic":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=_TINY)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["hinge", "logistic"])
def test_diff_grad_matches_jax(name):
    d = _grid()
    want = np.asarray(jk.get_kernel(name).diff_grad_fn(jnp.asarray(d), jnp))
    got = _port(tk.get_kernel(name).diff_grad_fn, d)
    if name == "logistic":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=_TINY)
    else:
        np.testing.assert_array_equal(got, want)


def test_auc_ties_and_signed_zero():
    got = _port(tk.auc_kernel.diff, np.array([0.0, -0.0, 1e-38, -1e-38],
                                             np.float32))
    np.testing.assert_array_equal(got, [0.5, 0.5, 1.0, 0.0])


def test_feature_kernels_match_jax():
    rng = np.random.default_rng(1)
    a, b, c = (rng.normal(size=(17, 3)) for _ in range(3))
    t = [torch.from_numpy(x) for x in (a, b, c)]
    np.testing.assert_allclose(
        tk.scatter_kernel.pair_matrix(t[0], t[1]).numpy(),
        np.asarray(jk.scatter_kernel.pair_matrix(a, b, np)), rtol=1e-12)
    np.testing.assert_allclose(
        tk.scatter_kernel.pair_elementwise(t[0], t[1]).numpy(),
        np.asarray(jk.scatter_kernel.pair_elementwise(a, b, np)), rtol=1e-12)
    for name in ("triplet_indicator", "triplet_hinge"):
        np.testing.assert_allclose(
            tk.get_kernel(name).triplet_values(*t).numpy(),
            np.asarray(jk.get_kernel(name).triplet_values(a, b, c, np)),
            rtol=1e-12)


def test_registry_parity_and_cuda_bodies():
    assert set(tk._REGISTRY) == set(jk._REGISTRY)
    for name, k in tk._REGISTRY.items():
        ref = jk.get_kernel(name)
        assert (k.degree, k.two_sample, k.kind, k.higher_is_better) == (
            ref.degree, ref.two_sample, ref.kind, ref.higher_is_better)
    assert [tk.get_kernel(n).cuda_body for n in ("auc", "hinge", "logistic")
            ] == [tk.AUC_BODY, tk.HINGE_BODY, tk.LOGISTIC_BODY]
    custom = tk.Kernel(name="custom_sq", degree=2, two_sample=True,
                       kind="diff", diff_fn=lambda d: d * d)
    assert custom.cuda_body is None
    with pytest.raises(KeyError):
        tk.get_kernel("nope")
