"""The fleet's tenant-axis counts (kernel 7) against the JAX package: the
port's plain version (comparison counting) and its batched
torch.searchsorted route equal JAX ``tenant_signed_count_local_fn`` in
Pallas interpret mode (transposed: the port drops the TPU's [qb, T]
layout) as integers, on the same numpy inputs: ragged caps per side,
empty and full rows, duplicates, queries tied to row values.
``tenant_pack_counts`` equals JAX ``tenant_pack_counts`` on both JAX
routes, and the dirty-row placement equals a full re-ship. The CUDA
kernel's search (rounds of ``TENANT_LEVELS`` halvings whose probes load
together, the lower and upper bounds in one descent) is emulated here
probe for probe and held against JAX, the plain version and the
searchsorted route on the edge cases of chip_smoke.py phase 20, and its
round count is pinned. The CUDA kernel is held against the plain version
on the card by the ``cuda``-marked test."""

import math

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
    from tuplewise_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    with pytest.raises(ValueError, match="1-D mesh"):
        sc.tenant_pack_counts(make_mesh_2d(2, 2, "cpu"), p, 256, p, 256, 8,
                              q.numpy(), q.numpy())
    with pytest.raises(ValueError, match="packs of shapes"):
        sc.tenant_pack_counts(make_mesh(2, "cpu"), p, 256, p, 256, 8,
                              q.numpy(), q.numpy())
    with pytest.raises(ValueError, match="t_bucket"):
        sc.tenant_pack_counts(None, p, 256, p, 256, 16, q.numpy(), q.numpy())
    assert [sc.tenant_bucket(n) for n in (0, 1, 8, 9, 37, 1024)] == [
        8, 8, 8, 16, 64, 1024]
    assert sc.tenant_bucket(3, min_bucket=1) == 4
    assert ([sc.tenant_bucket(n) for n in (0, 9, 37)]
            == [jax_sc.tenant_bucket(n) for n in (0, 9, 37)])


def _search(pack, q):
    """Emulation of tenant_count_kernel's search of one side, in its
    order: the lower bound by the top's ``TENANT_TOP_LEVELS`` halvings
    (one round: the block loads every candidate probe, at base + the sizes
    chosen before it + its own size), then rounds of ``TENANT_LEVELS``
    halvings (the same rule), a last round of row[base] and row[base + 1],
    then, for a query equal to the value at the bound only, a plain
    halving of the rest of the row (upper_bound).
    Returns (less, leq) int64 [T, qb], the dependent rounds of the lower
    bound (with its last round) and the most rounds of a tie."""
    T, cap = pack.shape
    flat = torch.cat([pack.reshape(-1), torch.tensor([math.inf])])
    row0 = (torch.arange(T) * cap)[:, None].expand(q.shape).reshape(-1)
    qf = q.reshape(-1)
    if cap == 0:
        zero = torch.zeros(q.shape, dtype=torch.int64)
        return zero, zero.clone(), 0, 0
    base = torch.zeros(qf.shape, dtype=torch.int64)
    n, rounds, levels = cap, 0, ck.TENANT_TOP_LEVELS
    while rounds == 0 or n > 1:
        # the top (read by the block once, then from shared memory), then
        # rounds of TENANT_LEVELS halvings
        rounds += 1
        h = []
        for _ in range(levels):
            h.append(n >> 1)
            n -= h[-1]
        v = {}
        for lev in range(levels):
            for c in range(1 << lev):
                off = h[lev] + sum(h[b] for b in range(lev)
                                   if (c >> (lev - 1 - b)) & 1)
                assert (base + off < cap).all()
                v[lev, c] = flat[row0 + base + off]
        c = torch.zeros_like(base)
        for lev in range(levels):
            x = torch.stack([v[lev, k] for k in range(1 << lev)])
            x = x.gather(0, c[None]).squeeze(0)
            up = x < qf
            base = torch.where(up, base + h[lev], base)
            c = 2 * c + up.long()
        levels = ck.TENANT_LEVELS
    rounds += 1
    v = flat[row0 + base]
    w = torch.where(base + 1 < cap, flat[row0 + base + 1], math.inf)
    at = torch.where(v < qf, w, v)
    less = base + (v < qf).long()
    tie = (less < cap) & (at == qf)
    lo = torch.where(tie, less + 1, less)
    m = torch.where(tie, cap - less - 1, 0)
    tie_rounds = 0
    while bool((m > 0).any()):
        tie_rounds += 1
        live = m > 0
        half = m >> 1
        x = flat[row0 + torch.where(live, lo + half, 0)]
        right = live & (x <= qf)
        lo = torch.where(right, lo + half + 1, lo)
        m = torch.where(live, torch.where(right, m - half - 1, half), m)
    return less.reshape(q.shape), lo.reshape(q.shape), rounds, tie_rounds


def search_route(pos, neg, qn, qp):
    """Kernel 7's int32 [4, T, qb] block by the emulated search, with the
    rounds of each side."""
    ln, en, rn, _ = _search(neg, qn)
    lp, ep, rp, _ = _search(pos, qp)
    return torch.stack([ln, en, lp, ep]).to(torch.int32), rn, rp


def _edge_problem(seed, T, cap_p, cap_n, qb):
    """Packs of ragged rows (empty, full, one value, a long tie run across
    the first halvings' probes) with NaN, +-inf, +-0.0 and row values as
    queries."""
    rng = np.random.default_rng(seed)

    def pack(cap):
        out = np.full((T, cap), np.inf, np.float32)
        for t in range(T):
            n = [0, cap, 1, cap // 2 + 1, cap - 1][t % 5]
            v = np.sort(np.round(rng.standard_normal(n) * 4) / 4)
            if n > 8:
                # a run of one value around n / 2, n / 4 and n / 8
                lo, hi = n // 8 - 1, n // 2 + 2
                v[lo:hi] = 0.5
                v = np.sort(v)
            if t % 5 == 4:
                v[v == 0] = -0.0          # -0.0 ties +0.0 queries
            out[t, :n] = v
        return out

    def queries(p):
        q = np.round(rng.standard_normal((T, qb)) * 4).astype(np.float32) / 4
        special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5],
                           np.float32)
        q[:, :len(special)] = special[:qb]
        for t in range(T):
            vals = p[t][np.isfinite(p[t])]
            if len(vals) and qb > 8:
                q[t, 6:qb // 2] = vals[rng.integers(0, len(vals),
                                                    qb // 2 - 6)]
        return q

    pos, neg = pack(cap_p), pack(cap_n)
    return pos, neg, queries(neg), queries(pos)


EDGE_CASES = [(0, 5, 1, 3, 8), (1, 5, 3, 1, 16), (2, 5, 256, 1024, 64),
              (3, 10, 513, 40, 32), (4, 5, (1 << 17) + 5, 7, 16)]


@pytest.mark.parametrize("seed,T,cap_p,cap_n,qb", EDGE_CASES)
def test_search_route_equals_plain_and_searchsorted(seed, T, cap_p, cap_n,
                                                    qb):
    """The emulated search on phase 20's edge cases (caps 1, 3 and
    2^17 + 5, caps that differ between the sides, empty rows, NaN and
    +-inf queries, ties across probe boundaries): the plain version's
    integers, and the searchsorted route's at every query that is not NaN
    (see test_nan_queries_split_the_reference_routes)."""
    args = _torch(*_edge_problem(seed, T, cap_p, cap_n, qb))
    got, rn, rp = search_route(*args)
    assert torch.equal(got, ck.tenant_count_plain(*args))
    num = ~torch.stack([args[2], args[2], args[3], args[3]]).isnan()
    assert torch.equal(got[num], sc.tenant_count_searchsorted(*args)[num])
    assert (rn, rp) == (ck.tenant_rounds(cap_n), ck.tenant_rounds(cap_p))
    # NaN counts 0; +inf counts the whole row (padding included) as leq
    assert (got[:, :, 0] == 0).all()
    assert (got[1, :, 1] == cap_n).all() and (got[3, :, 1] == cap_p).all()


@pytest.mark.parametrize("seed,cap_p,cap_n", [(10, 256, 1024), (11, 512, 512),
                                              (12, 2048, 256)])
def test_search_route_equals_jax_kernel(seed, cap_p, cap_n):
    """Against JAX tenant_signed_count_local_fn (interpret mode) on the
    edge problems at the caps it takes (powers of two, at least 256)."""
    pos, neg, qn, qp = _edge_problem(seed, 8, cap_p, cap_n, 32)
    got, _, _ = search_route(*_torch(pos, neg, qn, qp))
    np.testing.assert_array_equal(got.numpy(), _jax_block(pos, neg, qn, qp))
    for s in range(3):
        pos, neg, qn, qp = _problem(s)
        got, _, _ = search_route(*_torch(pos, neg, qn, qp))
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_block(pos, neg, qn, qp))


def test_nan_queries_split_the_reference_routes():
    """A NaN query counts 0 in the kernel route (the JAX Pallas kernel's
    comparisons, the plain version, kernel 7) and the whole row in the
    searchsorted route (jnp.searchsorted and torch.searchsorted sort NaN
    last): the reference's two routes differ there, and each port route
    equals its reference route."""
    pos, neg, qn, qp = _edge_problem(13, 8, 256, 512, 16)
    t_bucket = qn.shape[0]
    for kernel in (None, True):
        got = sc.tenant_pack_counts(
            None, torch.from_numpy(pos), pos.shape[1], torch.from_numpy(neg),
            neg.shape[1], t_bucket, qn, qp, np.float32, kernel=kernel)
        want = jax_sc.tenant_pack_counts(
            None, pos, pos.shape[1], neg, neg.shape[1], t_bucket, qn, qp,
            np.float32, kernel=kernel)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        caps = (neg.shape[1], neg.shape[1], pos.shape[1], pos.shape[1])
        nan_col = [g[:, 0].tolist() for g in got]
        assert nan_col == [[0 if kernel else c] * t_bucket for c in caps]


@pytest.mark.parametrize("cap,rounds", [(0, 0), (1, 2), (2, 2), (32, 2),
                                        (33, 3), (256, 4), (1024, 5),
                                        (1 << 17, 8), ((1 << 17) + 5, 9)])
def test_search_rounds_are_pinned(cap, rounds):
    """Dependent rounds of the lower bound: one for the top 5 halvings
    (the block's 31 probes), one for each two halvings below them (3
    loads) and a last one (2 loads): 8 at cap 2^17, where a lower and then
    an upper binary search took 2 x 18 dependent loads. The upper bound
    costs no round unless the query equals the value at the lower bound;
    then a plain halving of the rest of the row, one load a round."""
    assert (ck.TENANT_TOP_LEVELS, ck.TENANT_LEVELS) == (5, 2)
    assert ck.tenant_rounds(cap) == rounds
    row = torch.full((1, cap), 0.5)
    row[0, : cap // 3] = -1.0
    q = torch.tensor([[-2.0, 0.75, math.nan, 2.0]])
    less, leq, got, tie_rounds = _search(row, q)
    assert got == rounds and tie_rounds == 0
    assert less.tolist() == leq.tolist() == [[0, cap, 0, cap]]
    # a tie at the bound: the rest of the row by halvings
    less, leq, _, tie_rounds = _search(row, torch.tensor([[0.5, -1.0]]))
    assert less.tolist() == [[cap // 3, 0]]
    assert leq.tolist() == [[cap, cap // 3]]
    # the longest rest: past the first 0.5, or past the first -1.0
    rest = max(cap - cap // 3 - 1, cap - 1 if cap // 3 else 0, 0)
    assert (rest > 0) <= tie_rounds <= rest.bit_length()


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
    for case in EDGE_CASES:
        args = tuple(t.cuda() for t in _torch(*_edge_problem(*case)))
        got = ck.tenant_count(*args)
        assert torch.equal(got, ck.tenant_count_plain(*args))
        assert torch.equal(got.cpu(), search_route(
            *(t.cpu() for t in args))[0])
