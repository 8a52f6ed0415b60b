"""The port's host partitioner and design sampler (parallel.partition)
against the JAX package's: pure numpy on the same np.random.Generator,
so every array must be equal bit for bit, and the generators must end in
the same state. Also the cases of tests/test_sampling_designs.py that
pin the host designs themselves (distinctness, sizes, the off-diagonal
encoding, the errors)."""

import numpy as np
import pytest

from tuplewise_tpu.parallel import partition as J
from tuplewise_tpu_torch.parallel import partition as T


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _both(fn_name, *args, seed=0, **kw):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    out_j = getattr(J, fn_name)(rj, *args, **kw)
    out_t = getattr(T, fn_name)(rt, *args, **kw)
    _same(out_j, out_t)
    assert rj.bit_generator.state == rt.bit_generator.state
    return out_t


@pytest.mark.parametrize("design", ["swr", "swor", "bernoulli"])
@pytest.mark.parametrize("n1,n2,budget", [(50, 40, 1500), (7, 9, 63),
                                          (10**6, 10**6, 5000),
                                          (3000, 2000, 700)])
def test_pair_design_equals_reference(design, n1, n2, budget):
    i, j = _both("draw_pair_design", n1, n2, budget, design, seed=budget)
    assert i.max() < n1 and j.max() < n2


@pytest.mark.parametrize("design", ["swr", "swor", "bernoulli"])
def test_one_sample_design_equals_reference(design):
    i, j = _both("draw_pair_design", 30, 29, 600, design, seed=4,
                 one_sample=True)
    assert np.all(i != j) and j.max() < 30


@pytest.mark.parametrize("design", ["swr", "swor", "bernoulli"])
@pytest.mark.parametrize("n1,n2,budget", [(12, 9, 800), (5, 3, 60),
                                          (400, 300, 5000)])
def test_triplet_design_equals_reference(design, n1, n2, budget):
    i, j, k = _both("draw_triplet_design", n1, n2, budget, design,
                    seed=budget)
    assert np.all(i != j) and k.max() < n2


@pytest.mark.parametrize("scheme", ["swor", "swr"])
def test_partitions_equal_reference(scheme):
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    _same(J.partition_indices(103, 4, rj, scheme),
          T.partition_indices(103, 4, rt, scheme))
    _same(J.partition_two_sample(103, 77, 5, rj, scheme),
          T.partition_two_sample(103, 77, 5, rt, scheme))
    assert rj.bit_generator.state == rt.bit_generator.state


def test_pack_all_and_pad_len_equal_reference():
    v = np.random.default_rng(3).normal(size=(23, 3))
    _same(J.pack_all(v, 5), T.pack_all(v, 5))
    for design in ("swr", "swor", "bernoulli"):
        for b in (1, 100, 10_000):
            assert J.design_pad_len(b, design) == T.design_pad_len(b, design)


def test_distinct_uniform_equals_reference():
    for grid, size in ((100, 60), (1 << 22, 5000)):
        _both("_distinct_uniform", grid, size, seed=grid)


def test_host_designs_distinct_and_sized():
    rng = np.random.default_rng(0)
    i, j = T.draw_pair_design(rng, 50, 40, 1500, "swor")
    assert len(set(zip(i.tolist(), j.tolist()))) == 1500
    i, j, k = T.draw_triplet_design(rng, 5, 3, 60, "swor")
    assert len(set(zip(i.tolist(), j.tolist(), k.tolist()))) == 60
    sizes = [len(T.draw_pair_design(rng, 100, 100, 2000, "bernoulli")[0])
             for _ in range(50)]
    assert 1800 < np.mean(sizes) < 2200 and np.std(sizes) > 1.0


def test_host_design_errors():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="distinct"):
        T.draw_pair_design(rng, 4, 4, 17, "swor")
    with pytest.raises(ValueError, match="unknown sampling design"):
        T.draw_pair_design(rng, 5, 5, 3, "systematic")
    with pytest.raises(ValueError, match="n1"):
        T.draw_triplet_design(rng, 1, 5, 3, "swor")
    with pytest.raises(ValueError, match="too small"):
        T.partition_indices(3, 4, rng)
