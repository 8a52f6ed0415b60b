"""Kernel 6's search (``csrc/signed_count.cu``), emulated on the CPU probe
for probe (``signed_search.flat_search``) and held against the port's
plain version (comparison counting), its ``torch.searchsorted`` route and
the JAX package's ``flat_signed_count_fn`` in Pallas interpret mode, as
integers, on the same numpy inputs; the other design that
``bench_torch_variants.py --flat`` times (one thread a cell, the upper
bound searched again at a tie) beside it. The emulation counts each
cell's dependent rounds, pinned against ``count_kernels.signed_rounds``.
The CUDA kernel is held against the plain version and this emulation on
the card, on these edge cases, by ``tests/test_torch_counts.py``'s
``cuda``-marked test.
"""

import math

import numpy as np
import pytest
import torch

from signed_search import COMMITTED, I64, flat_search
from tuplewise_tpu_torch.ops import count_kernels as ck
from tuplewise_tpu_torch.parallel import sharded_counts as sc

# (top levels, lanes a bound, splitters a lane a round): the committed
# design, its 8-lane form, and the one-thread design at tops of 5 and 8
# halvings with 2 and 3 halvings a round (bench_torch_variants.py --flat)
DESIGNS = [COMMITTED, (8, 8, 1), (5, 1, 3), (8, 1, 3), (5, 1, 7), (8, 1, 7)]


def search_route(runs, signs, sets, qa, qb, design=COMMITTED):
    """Kernel 6's int32 [4, max(la, lb)] block by the emulated search,
    and the longest chain of a cell, ties included."""
    qs = (qa, qb)
    out = torch.zeros((4, max(len(qa), len(qb))), dtype=I64)
    chain = 0
    for run, s, a in zip(runs, signs, sets):
        q = qs[a]
        less, leq, c, tie = flat_search(run, q, design)
        out[2 * a, :len(q)] += s * less
        out[2 * a + 1, :len(q)] += s * leq
        chain = max(chain, int((c + tie).max()) if len(q) else 0)
    return out.to(torch.int32), chain


# --------------------------------------------------------------------- #
# inputs                                                                  #
# --------------------------------------------------------------------- #

def _grid_run(rng, n, shift=0.0):
    """n sorted float32 values on a 1/64 grid (many duplicates)."""
    return np.sort(np.round(rng.standard_normal(n) * 64) / 64
                   + shift).astype(np.float32)


def _queries(rng, n, runs):
    """n queries: NaN, +-inf, +-0.0 first, then half of them values of the
    runs (ties), the rest on and off the 1/64 grid."""
    q = rng.standard_normal(n).astype(np.float32)
    q[n // 2:] = (np.round(q[n // 2:] * 64) / 64).astype(np.float32)
    vals = np.concatenate([r[np.isfinite(r)] for r in runs] + [[0.5]])
    q[:n // 2] = vals[rng.integers(0, len(vals), n // 2)]
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)
    k = min(n, len(special))
    q[:k] = special[:k]
    return q


def _padded(arr):
    out = np.full(sc.next_bucket(len(arr)), np.inf, np.float32)
    out[: len(arr)] = arr
    return out


# (seed, run lengths, signs, sets, la, lb, +inf padding): chip_smoke.py
# phase 16's runs (30011, 4097 and 777 values; an empty run), 8 runs of
# mixed signs and odd lengths, runs shorter than the top, one run of one
# value repeated
EDGE_CASES = [
    (0, [3001, 409, 30011, 5009, 77, 0], [1, -1, 1, 1, -1, 1],
     [0, 0, 0, 1, 1, 1], 255, 1, True),
    (1, [0, 1, 2, 3, 254, 255, 256, 1000], [1, -1, 1, -1, 1, 1, -1, 1],
     [0, 1, 0, 1, 0, 1, 1, 0], 64, 63, False),
    (2, [1000, 257, 4097], [1, -1, 1], [1, 1, 1], 1, 130, True),
    (3, [777, 1 << 12], [1, 1], [0, 1], 200, 200, True),
    (4, [513, 5], [-1, 1], [0, 0], 3, 0, False),
]


def _edge_problem(seed, lens, signs, sets, la, lb, pad):
    """Runs on a 1/64 grid (the last run of case 3 one value repeated,
    the second of case 1 with -inf and +inf values, zeros of case 2 as
    -0.0), padded with +inf to their buckets or not, and queries of
    ``_queries`` against each set's runs."""
    rng = np.random.default_rng(seed)
    runs = [_grid_run(rng, n, 0.5 * (k % 2)) for k, n in enumerate(lens)]
    if seed == 1:
        runs[1] = np.array([-np.inf], np.float32)
        runs[3] = np.array([-np.inf, 0.0, np.inf], np.float32)
    if seed == 2:
        runs = [np.where(r == 0, np.float32(-0.0), r) for r in runs]
    if seed == 3:
        runs[1] = np.full(lens[1], 0.25, np.float32)
    qa = _queries(rng, la, [r for r, a in zip(runs, sets) if a == 0])
    qb = _queries(rng, lb, [r for r, a in zip(runs, sets) if a == 1])
    if pad:
        runs = [_padded(r) for r in runs]
    return runs, signs, sets, qa, qb


def _torch_args(runs, signs, sets, qa, qb):
    return ([torch.from_numpy(np.ascontiguousarray(r)) for r in runs],
            list(signs), list(sets), torch.from_numpy(qa),
            torch.from_numpy(qb))


def _non_nan(qa, qb, qcols):
    """[4, qcols] True where the column's query is not NaN."""
    rows = []
    for q in (qa, qb):
        ok = torch.ones(qcols, dtype=torch.bool)
        ok[:len(q)] = ~q.isnan()
        rows += [ok, ok]
    return torch.stack(rows)


# --------------------------------------------------------------------- #
# against the port's routes and JAX                                       #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("case", range(len(EDGE_CASES)))
def test_search_equals_plain_and_searchsorted(case, design):
    """Every design on the edge cases: the plain version's integers, and
    the searchsorted route's at every query that is not NaN (a NaN query
    counts 0 here and the whole run there: see
    test_nan_queries_split_the_reference_routes)."""
    args = _torch_args(*_edge_problem(*EDGE_CASES[case]))
    got, _ = search_route(*args, design=design)
    assert torch.equal(got, ck.signed_count_plain(*args))
    lib = sc.signed_count_searchsorted(*args)
    ok = _non_nan(args[3], args[4], got.shape[1])
    assert torch.equal(got[ok], lib[ok])
    # a NaN query counts 0 in every row of its set
    for a, q in ((0, args[3]), (1, args[4])):
        if len(q):
            assert not got[2 * a:2 * a + 2, 0].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_equals_jax_kernel(seed):
    """Against JAX flat_signed_count_fn (Pallas interpret mode) on
    padded runs and bucket-padded queries: base, delta and tombstone runs,
    two query sets, ties at run values."""
    from test_torch_counts import _jax_block, _problem

    runs, qa, qb = _problem(seed)
    want = _jax_block(runs, qa, qb)
    tens = [torch.from_numpy(_padded(a)) for a, _, _ in runs]
    got, _ = search_route(tens, [s for _, s, _ in runs],
                          [a for _, _, a in runs], torch.from_numpy(qa),
                          torch.from_numpy(qb))
    np.testing.assert_array_equal(got[:2, :len(qa)].numpy(),
                                  want[:2, :len(qa)])
    np.testing.assert_array_equal(got[2:, :len(qb)].numpy(),
                                  want[2:, :len(qb)])


@pytest.mark.parametrize("case", [0, 3])
def test_edge_cases_equal_jax_kernel(case):
    """The edge cases with +inf padding against JAX flat_signed_count_fn
    at its bucket-padded query length, NaN queries included: the Pallas
    kernel compares, so a NaN query counts 0 there too."""
    from tuplewise_tpu.ops import pallas_counts as jax_pc
    from tuplewise_tpu.parallel import sharded_counts as jax_sc

    runs, signs, sets, qa, qb = _edge_problem(*EDGE_CASES[case])
    qbk = jax_sc.next_bucket(max(len(qa), len(qb), 1))
    qa_p, qb_p = np.zeros(qbk, np.float32), np.zeros(qbk, np.float32)
    qa_p[:len(qa)], qb_p[:len(qb)] = qa, qb
    fn = jax_pc.flat_signed_count_fn(tuple(len(r) for r in runs),
                                     tuple(signs), tuple(sets), qbk, True)
    want = np.asarray(fn(tuple(runs), qa_p, qb_p))
    got, _ = search_route(*_torch_args(runs, signs, sets, qa, qb))
    np.testing.assert_array_equal(got[:2, :len(qa)].numpy(),
                                  want[:2, :len(qa)])
    np.testing.assert_array_equal(got[2:, :len(qb)].numpy(),
                                  want[2:, :len(qb)])


def test_nan_queries_split_the_reference_routes():
    """A NaN query counts 0 in the kernel route (the JAX Pallas kernel's
    comparisons, the plain version, kernel 6) and the whole run in the
    searchsorted route (jnp.searchsorted and torch.searchsorted sort NaN
    last): each port route equals its reference route."""
    from tuplewise_tpu.parallel import sharded_counts as jax_sc

    rng = np.random.default_rng(9)
    neg, pos = _grid_run(rng, 300), _grid_run(rng, 200, 0.5)
    qa = np.array([np.nan, 0.5, -1.0], np.float32)
    qb = np.array([np.nan, np.inf], np.float32)
    runs_a, runs_b = [(neg, 512, 1)], [(pos, 256, 1)]
    for kernel in (None, True):
        got = sc.signed_pair_counts(None, runs_a, runs_b, qa, qb,
                                    np.float32, kernel=kernel, device="cpu")
        want = jax_sc.signed_pair_counts(None, runs_a, runs_b, qa, qb,
                                         np.float32, kernel=kernel)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        nan_col = [int(g[0]) for g in got]
        assert nan_col == ([0] * 4 if kernel else [512, 512, 256, 256])


# --------------------------------------------------------------------- #
# the chain                                                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("cap,rounds", [(0, 0), (1, 1), (2, 1), (254, 1),
                                        (256, 2), (1 << 17, 4),
                                        (1 << 18, 4), (1 << 19, 4),
                                        ((1 << 19) + 5, 4)])
def test_signed_rounds_are_pinned(cap, rounds):
    """Dependent rounds of the committed search: one for the block's top
    (255 splitters a run, its first cut from shared memory), then one for
    each cut into 17 parts (16 lanes, one splitter each): 4 at caps 2^17
    to 2^19, where a lower and then an upper binary search took 2 x 18 to
    2 x 20 dependent loads. The emulation's longest chain over queries at
    every value of a run and between them, tied or not, is that count."""
    assert COMMITTED == (8, 16, 1)
    assert ck.signed_rounds(cap) == rounds
    if cap == 0:
        return
    run = torch.sort(torch.randint(-cap, cap, (cap,),
                                   generator=torch.Generator().manual_seed(
                                       cap)).float() / 4).values
    at = torch.linspace(0, cap - 1, min(cap, 3000)).long()
    q = torch.cat([run[at], run[at] + 0.125, run[at] - 0.125,
                   torch.tensor([math.inf, -math.inf, math.nan])])
    less, leq, chain, tie = flat_search(run, q)
    assert int(chain.max()) == rounds and not tie.any()
    assert torch.equal(less, torch.searchsorted(run, q.contiguous())[
        :len(q)] * (~q.isnan()))
    assert torch.equal(leq[:-1], torch.searchsorted(run, q[:-1], right=True))


def _design_rounds(cap, design):
    """signed_rounds for any design: the top's round, then cuts into
    lanes x probes + 1 parts until one candidate is left."""
    top_levels, lanes, probes = design
    left, rounds = -(-(cap + 1) // (1 << top_levels)), 1
    while left > 1:
        left, rounds = -(-left // (lanes * probes + 1)), rounds + 1
    return rounds


def test_ties_cost_the_committed_design_nothing():
    """Phase 16's headline on the CPU: a run on a 1/64 grid at cap 2^19
    and 512 queries, half of them run values (ties) and half N(0, 1). The
    committed design's chain is signed_rounds(cap) for tied and untied
    queries alike; the one-thread design's tied queries pay a second search
    on top of its lower bound's chain (bench_torch_variants.py --flat times
    both)."""
    rng = np.random.default_rng(16)
    run = torch.from_numpy(_padded(_grid_run(rng, 500_000)))
    q = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    q[:256] = run[torch.from_numpy(rng.integers(0, 500_000, 256))]
    tied = torch.isin(q, run)
    assert tied[:256].all() and not tied[256:].any()
    want = ck.signed_count_plain([run], [1], [0], q, q[:1])[:2].long()
    assert ck.signed_rounds(len(run)) == _design_rounds(len(run), COMMITTED)
    for design in DESIGNS:
        less, leq, chain, tie = flat_search(run, q, design)
        assert torch.equal(torch.stack([less, leq]), want)
        rounds = _design_rounds(len(run), design)
        # the longest chain: every query's at the committed design
        assert int(chain.max()) <= rounds
        assert design != COMMITTED or bool((chain == rounds).all())
        if design[1] > 1:
            assert not tie.any()
        else:
            assert not tie[~tied].any() and bool((tie[tied] > 0).all())
            assert int((chain + tie).max()) > rounds
