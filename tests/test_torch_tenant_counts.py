"""The fleet's tenant-axis counts (kernel 7) against the JAX package: the
port's plain version (comparison counting) and its batched
torch.searchsorted route equal JAX ``tenant_signed_count_local_fn`` in
Pallas interpret mode (transposed: the port drops the TPU's [qb, T]
layout) as integers, on the same numpy inputs: ragged caps per side,
empty and full rows, duplicates, queries tied to row values.
``tenant_pack_counts`` equals JAX ``tenant_pack_counts`` on both JAX
routes, and the dirty-row placement equals a full re-ship. The CUDA
kernel is held against the plain version on the card by the
``cuda``-marked test."""

import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import pallas_counts as jax_pc
from tuplewise_tpu.parallel import sharded_counts as jax_sc
from tuplewise_tpu_torch.ops import count_kernels as ck
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.parallel import sharded_counts as sc
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry


def _runs(rng, T, max_len, grid=None):
    """T sorted float32 runs of ragged lengths, one empty and one at
    ``max_len``; ``grid`` rounds values onto a coarse grid (ties)."""
    lens = rng.integers(0, max_len + 1, size=T)
    lens[0] = 0
    lens[-1] = max_len
    runs = []
    for n in lens:
        v = rng.standard_normal(int(n))
        if grid is not None:
            v = np.round(v * grid) / grid
        runs.append(np.sort(v).astype(np.float32))
    return runs


def _pack(runs, t_bucket, cap):
    out = np.full((t_bucket, cap), np.inf, np.float32)
    for t, r in enumerate(runs):
        out[t, : len(r)] = r
    return out


def _queries(rng, runs, t_bucket, qb, grid=None):
    """[t_bucket, qb] queries, a third of each row tied to its run's
    values."""
    q = rng.standard_normal((t_bucket, qb))
    if grid is not None:
        q = np.round(q * grid) / grid
    q = q.astype(np.float32)
    for t, r in enumerate(runs):
        if len(r):
            k = qb // 3
            q[t, :k] = r[rng.integers(0, len(r), size=k)]
    return q


def _problem(seed, grid=None):
    rng = np.random.default_rng(seed)
    t_bucket = 8
    T = int(rng.integers(1, t_bucket + 1))
    pos_runs = _runs(rng, T, int(rng.integers(1, 300)), grid)
    neg_runs = _runs(rng, T, int(rng.integers(1, 700)), grid)
    cap_p = sc.next_bucket(max(len(r) for r in pos_runs))
    cap_n = sc.next_bucket(max(len(r) for r in neg_runs))
    qb = 256
    pos, neg = _pack(pos_runs, t_bucket, cap_p), _pack(neg_runs, t_bucket,
                                                        cap_n)
    qn = _queries(rng, neg_runs, t_bucket, qb, grid)
    qp = _queries(rng, pos_runs, t_bucket, qb, grid)
    return pos, neg, qn, qp


def _jax_block(pos, neg, qn, qp):
    """JAX tenant_signed_count_local_fn (interpret mode), [4, T, qb]."""
    t_bucket, qb = qn.shape
    fn = jax_pc.tenant_signed_count_local_fn(
        t_bucket, pos.shape[1], neg.shape[1], qb, True)
    out = np.asarray(fn(pos, neg, np.ascontiguousarray(qn.T),
                        np.ascontiguousarray(qp.T)))
    return out.transpose(0, 2, 1)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


ROUTES = {"plain": ck.tenant_count_plain,
          "searchsorted": sc.tenant_count_searchsorted,
          "dispatch": ck.tenant_count}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_block_equals_jax_kernel(seed, route):
    pos, neg, qn, qp = _problem(seed)
    got = ROUTES[route](*_torch(pos, neg, qn, qp))
    assert got.dtype == torch.int32 and got.shape == (4,) + qn.shape
    np.testing.assert_array_equal(got.numpy(), _jax_block(pos, neg, qn, qp))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_many_ties_equal_jax_kernel(route):
    """Values and queries on a coarse grid: heavy ties at row values."""
    pos, neg, qn, qp = _problem(5, grid=2)
    got = ROUTES[route](*_torch(pos, neg, qn, qp))
    np.testing.assert_array_equal(got.numpy(), _jax_block(pos, neg, qn, qp))


def test_plain_tiles_any_budget(monkeypatch):
    """The plain version's tiling (rows x run columns under its element
    budget) gives the same integers however small the budget."""
    pos, neg, qn, qp = _problem(3)
    want = ck.tenant_count_plain(*_torch(pos, neg, qn, qp))
    for budget in (1, 300, 5000):
        monkeypatch.setitem(ck._PLAIN_TILE_ELEMS, "cpu", budget)
        assert torch.equal(ck.tenant_count_plain(*_torch(pos, neg, qn, qp)),
                           want)


@pytest.mark.parametrize("kernel", [None, True])
def test_pack_counts_equal_jax_dispatcher(kernel):
    """Port tenant_pack_counts on the CPU against JAX tenant_pack_counts
    on its XLA route and through its interpreted kernel: the same four
    [T_bucket, qb] int64 arrays."""
    pos, neg, qn, qp = _problem(4)
    t_bucket = qn.shape[0]
    reg = MetricsRegistry()
    got = sc.tenant_pack_counts(
        None, torch.from_numpy(pos), pos.shape[1], torch.from_numpy(neg),
        neg.shape[1], t_bucket, qn, qp, np.float32, kernel=kernel,
        metrics=reg)
    for jkernel in (None, True):
        want = jax_sc.tenant_pack_counts(
            None, pos, pos.shape[1], neg, neg.shape[1], t_bucket, qn, qp,
            np.float32, kernel=jkernel)
        for g, w in zip(got, want):
            assert g.dtype == np.int64 and g.shape == qn.shape
            np.testing.assert_array_equal(g, np.asarray(w))
    calls = reg.snapshot().get("count_kernel_calls_total", {}).get("value", 0)
    assert calls == (1 if kernel else 0)


def test_place_tenant_pack_full_ship_equals_jax():
    rng = np.random.default_rng(6)
    runs = _runs(rng, 5, 300)
    reg = MetricsRegistry()
    dev, cap, shipped = sc.place_tenant_pack(None, runs, 8, device="cpu",
                                             metrics=reg)
    jdev, jcap, jshipped = jax_sc.place_tenant_pack(None, runs, 8, np.float32)
    assert cap == jcap == 512 and shipped == jshipped == 8 * 512 * 4
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jdev))
    assert reg.snapshot()["bytes_h2d"]["value"] == shipped


def test_dirty_rows_equal_full_reship_and_ship_db_rows():
    """The dirty-row update writes the changed slots into the resident
    pack in place, equals a full re-ship, and ships db * cap * 4 bytes;
    the rest of a full ship counts as saved."""
    rng = np.random.default_rng(7)
    runs = _runs(rng, 6, 200)
    reg = MetricsRegistry()
    dev, cap, _ = sc.place_tenant_pack(None, runs, 8, device="cpu",
                                       metrics=reg)
    runs[2] = np.sort(rng.standard_normal(150)).astype(np.float32)
    runs[4] = np.empty(0, np.float32)
    runs.append(np.sort(rng.standard_normal(40)).astype(np.float32))
    dirty = [2, 4, 6]
    upd, ucap, shipped = sc.place_tenant_pack(
        None, runs, 8, prev=(dev, cap, 8), dirty=dirty, metrics=reg)
    full, fcap, _ = sc.place_tenant_pack(None, runs, 8, device="cpu")
    assert upd is dev and ucap == cap == fcap
    assert torch.equal(upd, full)
    assert shipped == len(dirty) * cap * 4
    snap = reg.snapshot()
    assert snap["bytes_h2d"]["value"] == 8 * cap * 4 + shipped
    assert snap["bytes_h2d_saved"]["value"] == (8 - len(dirty)) * cap * 4
    # nothing dirty: nothing shipped, the whole pack saved
    same, _, none = sc.place_tenant_pack(None, runs, 8, prev=(upd, cap, 8),
                                         dirty=[], metrics=reg)
    assert same is upd and none == 0


@pytest.mark.parametrize("change", ["t_bucket", "cap", "unknown"])
def test_geometry_change_ships_the_whole_pack(change):
    rng = np.random.default_rng(8)
    runs = _runs(rng, 4, 100)
    dev, cap, _ = sc.place_tenant_pack(None, runs, 8, device="cpu")
    t_bucket, dirty = 8, [1]
    if change == "t_bucket":
        t_bucket = 16
    elif change == "cap":
        runs[1] = np.sort(rng.standard_normal(600)).astype(np.float32)
    else:
        dirty = None
    new, ncap, shipped = sc.place_tenant_pack(
        None, runs, t_bucket, prev=(dev, cap, 8), dirty=dirty, device="cpu")
    assert new is not dev and shipped == t_bucket * ncap * 4
    want, _, _ = sc.place_tenant_pack(None, runs, t_bucket, device="cpu")
    assert torch.equal(new, want)


def test_cpu_dispatch_takes_plain_and_counts_no_launch():
    args = _torch(*_problem(0))
    pk.reset_launch_counts()
    assert torch.equal(ck.tenant_count(*args), ck.tenant_count_plain(*args))
    assert sum(pk.LAUNCHES.values()) == 0


def test_argument_checks():
    p = torch.zeros(8, 256)
    q = torch.zeros(8, 4)
    with pytest.raises(TypeError, match="float32"):
        ck.tenant_count(p.double(), p, q, q)
    with pytest.raises(ValueError, match="one row per tenant"):
        ck.tenant_count(torch.zeros(4, 256), p, q, q)
    with pytest.raises(ValueError, match="query blocks of shapes"):
        ck.tenant_count(p, p, q, torch.zeros(8, 5))
    with pytest.raises(ValueError, match="contiguous"):
        ck.tenant_count(p, p, q, torch.zeros(4, 8).T)
    with pytest.raises(NotImplementedError, match="mesh"):
        sc.tenant_pack_counts(object(), p, 256, p, 256, 8, q.numpy(),
                              q.numpy())
    with pytest.raises(ValueError, match="t_bucket"):
        sc.tenant_pack_counts(None, p, 256, p, 256, 16, q.numpy(), q.numpy())
    assert [sc.tenant_bucket(n) for n in (0, 1, 8, 9, 37, 1024)] == [
        8, 8, 8, 16, 64, 1024]
    assert sc.tenant_bucket(3, min_bucket=1) == 4
    assert ([sc.tenant_bucket(n) for n in (0, 9, 37)]
            == [jax_sc.tenant_bucket(n) for n in (0, 9, 37)])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA tenant count kernel has "
                    "no CPU mode")
    for seed in range(3):
        pos, neg, qn, qp = _problem(seed)
        args = tuple(t.cuda() for t in _torch(pos, neg, qn, qp))
        got = ck.tenant_count(*args)
        assert torch.equal(got, ck.tenant_count_plain(*args))
        assert torch.equal(got, sc.tenant_count_searchsorted(*args))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _jax_block(pos, neg, qn, qp))
