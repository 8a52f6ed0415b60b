"""The fused signed counts of the serving index (kernel 6) against the
JAX package: the port's plain version (comparison counting) and its
torch.searchsorted route equal JAX ``flat_signed_count_fn`` in Pallas
interpret mode and JAX ``signed_pair_counts(kernel=True)`` as integers,
on the same numpy inputs: ties at run values, -1 (tombstone) runs, two
query sets, empty runs. The CUDA kernel is held against the plain
version on the card by the ``cuda``-marked test."""

import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import pallas_counts as jax_pc
from tuplewise_tpu.parallel import sharded_counts as jax_sc
from tuplewise_tpu_torch.ops import count_kernels as ck
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.parallel import sharded_counts as sc


def _problem(seed):
    """The JAX parity test's randomized runs (base +1, delta +1, tombstone
    -1), each counted against one of two query sets with ties at run
    values, padded to their buckets with +inf."""
    rng = np.random.default_rng(seed)
    base = np.sort(rng.standard_normal(
        int(rng.integers(1, 400)))).astype(np.float32)
    base[::7] = np.round(base[::7], 1)       # duplicated values
    base = np.sort(base)
    delta = np.sort(rng.standard_normal(
        int(rng.integers(0, 60)))).astype(np.float32)
    tomb = np.sort(rng.choice(
        base, int(rng.integers(0, min(10, len(base)))),
        replace=False)).astype(np.float32)
    qa = rng.standard_normal(int(rng.integers(1, 50))).astype(np.float32)
    qa[: min(3, len(qa))] = base[: min(3, len(qa))]      # boundary ties
    qb = rng.standard_normal(int(rng.integers(1, 70))).astype(np.float32)
    qb[: min(2, len(qb))] = base[-min(2, len(qb)):]
    runs = [(base, 1, 0), (delta, 1, 1), (tomb, -1, 0), (tomb, -1, 1)]
    return runs, qa, qb


def _padded(arr):
    out = np.full(sc.next_bucket(len(arr)), np.inf, np.float32)
    out[: len(arr)] = arr
    return out


def _jax_block(runs, qa, qb):
    """JAX flat_signed_count_fn (Pallas interpret mode) on padded runs
    and bucket-padded queries: [4, q_bucket] int32 as numpy."""
    qbk = jax_sc.next_bucket(max(len(qa), len(qb), 1))
    qa_p = np.zeros(qbk, np.float32)
    qa_p[: len(qa)] = qa
    qb_p = np.zeros(qbk, np.float32)
    qb_p[: len(qb)] = qb
    padded = tuple(_padded(a) for a, _, _ in runs)
    fn = jax_pc.flat_signed_count_fn(
        tuple(len(p) for p in padded), tuple(s for _, s, _ in runs),
        tuple(a for _, _, a in runs), qbk, True)
    return np.asarray(fn(padded, qa_p, qb_p))


def _torch_args(runs, qa, qb, pad=True):
    tens = [torch.from_numpy(_padded(a) if pad else a) for a, _, _ in runs]
    return (tens, [s for _, s, _ in runs], [a for _, _, a in runs],
            torch.from_numpy(qa), torch.from_numpy(qb))


def _assert_block_equal(got, want, la, lb):
    got = got.numpy()
    assert got.dtype == np.int32 and got.shape == (4, max(la, lb))
    np.testing.assert_array_equal(got[:2, :la], want[:2, :la])
    np.testing.assert_array_equal(got[2:, :lb], want[2:, :lb])
    assert not got[:2, la:].any() and not got[2:, lb:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("route", ["plain", "searchsorted"])
def test_block_equals_jax_kernel(seed, route):
    runs, qa, qb = _problem(seed)
    want = _jax_block(runs, qa, qb)
    fn = (ck.signed_count_plain if route == "plain"
          else sc.signed_count_searchsorted)
    got = fn(*_torch_args(runs, qa, qb))
    _assert_block_equal(got, want, len(qa), len(qb))
    # unpadded runs give the same integers: padding counts 0
    _assert_block_equal(fn(*_torch_args(runs, qa, qb, pad=False)), want,
                        len(qa), len(qb))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kernel", [True, None])
def test_signed_pair_counts_equal_jax(seed, kernel):
    runs, qa, qb = _problem(seed)
    runs_a = [(a, sc.next_bucket(len(a)), s) for a, s, side in runs
              if side == 0]
    runs_b = [(a, sc.next_bucket(len(a)), s) for a, s, side in runs
              if side == 1]
    want = jax_sc.signed_pair_counts(None, runs_a, runs_b, qa, qb,
                                     np.float32, kernel=True)
    # host arrays (padded by the call) and placed device tensors
    placed_a = [(sc.place_run(a, c, "cpu"), c, s) for a, c, s in runs_a]
    for ra, rb in ((runs_a, runs_b), (placed_a, runs_b)):
        got = sc.signed_pair_counts(None, ra, rb, qa, qb, np.float32,
                                    kernel=kernel, device="cpu")
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)


def test_two_query_sets_and_empty_runs():
    rng = np.random.default_rng(7)
    neg = np.sort(rng.standard_normal(300)).astype(np.float32)
    pos = np.sort(rng.standard_normal(200)).astype(np.float32)
    qa = rng.standard_normal(17).astype(np.float32)
    qb = rng.standard_normal(9).astype(np.float32)
    empty = np.zeros(0, np.float32)
    runs = [(neg, 1, 0), (empty, 1, 0), (pos, 1, 1), (empty, -1, 1)]
    want = _jax_block(runs, qa, qb)
    for fn in (ck.signed_count_plain, sc.signed_count_searchsorted):
        for pad in (True, False):
            _assert_block_equal(fn(*_torch_args(runs, qa, qb, pad=pad)),
                                want, len(qa), len(qb))
    out = ck.signed_count_plain(*_torch_args(runs, qa, qb)).numpy()
    np.testing.assert_array_equal(out[0, :17], np.searchsorted(neg, qa))
    np.testing.assert_array_equal(out[3, :9],
                                  np.searchsorted(pos, qb, "right"))
    # no runs at all, and an empty query set
    z = ck.signed_count_plain([], [], [], torch.from_numpy(qa),
                              torch.zeros(0))
    assert z.shape == (4, 17) and not z.any()
    la, lqa, lb, lqb = sc.signed_pair_counts(None, [], [], qa, qb,
                                             kernel=True)
    assert not (la.any() or lqa.any() or lb.any() or lqb.any())
    assert len(la) == 17 and len(lb) == 9


class _Placed(Exception):
    pass


def test_host_runs_with_no_device_go_to_the_card(monkeypatch):
    """Host runs and no device: the card, as every entry point of the
    port; with no card the call raises instead of counting on the CPU."""
    neg = np.sort(np.random.default_rng(8).standard_normal(300)
                  ).astype(np.float32)
    q = neg[:5].copy()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sc.signed_pair_counts(None, [(neg, 512, 1)], [], q, q,
                                  kernel=True)

    def place(arr, cap, device):
        raise _Placed(torch.device(device))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(sc, "place_run", place)
    with pytest.raises(_Placed) as placed:
        sc.signed_pair_counts(None, [(neg, 512, 1)], [], q, q, kernel=True)
    assert placed.value.args[0].type == "cuda"


def test_k6_with_many_ties():
    """Six runs on a coarse grid (heavy ties at run values), both signs,
    both query sets."""
    rng = np.random.default_rng(3)
    runs = []
    for r in range(6):
        vals = np.sort(rng.integers(-5, 6, size=int(rng.integers(0, 300)))
                       .astype(np.float32) / 2)
        runs.append((vals, 1 if r % 3 else -1, r % 2))
    qa = (rng.integers(-6, 7, size=41) / 2).astype(np.float32)
    qb = (rng.integers(-6, 7, size=23) / 2).astype(np.float32)
    want = _jax_block(runs, qa, qb)
    for fn in (ck.signed_count_plain, sc.signed_count_searchsorted):
        _assert_block_equal(fn(*_torch_args(runs, qa, qb)), want, 41, 23)


def test_cpu_dispatch_takes_plain_and_counts_no_launch():
    runs, qa, qb = _problem(0)
    args = _torch_args(runs, qa, qb)
    pk.reset_launch_counts()
    assert torch.equal(ck.signed_count(*args), ck.signed_count_plain(*args))
    assert sum(pk.LAUNCHES.values()) == 0


def test_argument_checks():
    q = torch.zeros(4)
    r = torch.zeros(8)
    with pytest.raises(ValueError, match="at most 8"):
        ck.signed_count([r] * 9, [1] * 9, [0] * 9, q, q)
    with pytest.raises(ValueError, match="signs"):
        ck.signed_count([r], [2], [0], q, q)
    with pytest.raises(ValueError, match="query sets"):
        ck.signed_count([r], [1], [2], q, q)
    with pytest.raises(TypeError, match="float32"):
        ck.signed_count([r.double()], [1], [0], q, q)
    with pytest.raises(ValueError, match="one entry per run"):
        ck.signed_count([r], [1, 1], [0], q, q)
    with pytest.raises(NotImplementedError, match="mesh"):
        sc.signed_pair_counts(object(), [], [], np.zeros(1), np.zeros(1))
    assert [sc.next_bucket(n) for n in (0, 1, 256, 257, 5000)] == [
        256, 256, 256, 512, 8192]
    placed = sc.place_run(np.asarray([1.0, 2.0], np.float32), 256, "cpu")
    assert placed.shape == (256,) and torch.isinf(placed[2:]).all()


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA count kernel has no CPU "
                    "mode")
    for seed in range(3):
        runs, qa, qb = _problem(seed)
        tens, signs, sets, tqa, tqb = _torch_args(runs, qa, qb)
        args = ([t.cuda() for t in tens], signs, sets, tqa.cuda(),
                tqb.cuda())
        got = ck.signed_count(*args)
        assert torch.equal(got, ck.signed_count_plain(*args))
        assert torch.equal(got, sc.signed_count_searchsorted(*args))
        _assert_block_equal(got.cpu(), _jax_block(runs, qa, qb), len(qa),
                            len(qb))
    # the search's edge cases (8 runs of mixed signs, odd and empty runs,
    # runs shorter than the top, +-inf values, NaN, +-inf and tied
    # queries): plain and the CPU emulation bit for bit, searchsorted at
    # every query that is not NaN, one launch a call
    from test_torch_signed_search import (EDGE_CASES, _edge_problem,
                                          _non_nan, search_route)

    for case in EDGE_CASES:
        runs, signs, sets, qa, qb = _edge_problem(*case)
        cpu = ([torch.from_numpy(r) for r in runs], signs, sets,
               torch.from_numpy(qa), torch.from_numpy(qb))
        args = ([r.cuda() for r in cpu[0]], signs, sets, cpu[3].cuda(),
                cpu[4].cuda())
        pk.reset_launch_counts()
        got = ck.signed_count(*args)
        assert pk.LAUNCHES["signed_count[flat]"] == 1
        assert torch.equal(got, ck.signed_count_plain(*args))
        assert torch.equal(got.cpu(), search_route(*cpu)[0])
        ok = _non_nan(cpu[3], cpu[4], got.shape[1]).cuda()
        assert torch.equal(got[ok], sc.signed_count_searchsorted(*args)[ok])
    pk.reset_launch_counts()
