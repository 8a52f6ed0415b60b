"""The port's ring (tuplewise_tpu_torch.parallel.ring, parallel.comm)
on the CPU worker axis.

The rotation is held against the JAX ``ppermute`` permutation on the 8
virtual CPU devices. The ring's (sum, count) is held against the port's
single-device reductions on the concatenated data: auc and the triplet
indicator exactly (sums of 0, 1/2 and 1 are exact in float64); hinge and
logistic within rel 1e-12 (float64 sums of the same float32 terms in
another order; each sum's worst case is n1 n2 2^-53 < 8e-13 relative at
these sizes, its typical error sqrt(n1 n2) 2^-53 ~ 1e-14); the triplet
hinge within rel 1e-6
(the float32 distance products of differently shaped blocks round
differently, a few ulps of the distances).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tuplewise_tpu.parallel import ring as jring
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.ops import pair_tiles, triplet_kernels
from tuplewise_tpu_torch.ops.kernels import get_kernel
from tuplewise_tpu_torch.parallel import comm as pcomm
from tuplewise_tpu_torch.parallel import ring
from tuplewise_tpu_torch.parallel.device_partition import pack_blocks
from tuplewise_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from tuplewise_tpu_torch.parallel.partition import pack_all


def _jax_rotated(shape, names, axis_name):
    """Worker ids after one JAX ``ppermute`` ring step along an axis."""
    mesh = jax.make_mesh(shape, names)
    n = int(np.prod(shape))
    spec = P(names)

    def body(x):
        return jring._rotate((x,), axis_name)[0]

    fn = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec,
                       check_vma=False)
    return np.asarray(fn(jnp.arange(n, dtype=jnp.int32)))


@pytest.mark.parametrize("shape,names,axis", [
    ((8,), ("w",), 0), ((5,), ("w",), 0), ((2, 4), ("dcn", "w"), 1),
    ((2, 4), ("dcn", "w"), 0), ((4, 2), ("dcn", "w"), 0),
    ((1, 8), ("dcn", "w"), 0),
])
def test_rotation_matches_the_jax_permutation(shape, names, axis):
    want = _jax_rotated(shape, names, names[axis])
    comm = pcomm.LocalComm(shape)
    ids = torch.arange(comm.n_workers)
    got = comm.start_rotate([ids[:, None]], axis).wait()[0][:, 0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(8,), (2, 4), (3, 1), (2, 2)])
def test_distributed_peers_match_the_worker_axis(monkeypatch, shape):
    """DistComm's rank arithmetic: rank r receives, along each axis, the
    block the worker axis rolls into row r."""
    import torch.distributed as dist

    n = int(np.prod(shape))
    local = pcomm.LocalComm(shape)
    monkeypatch.setattr(dist, "get_world_size", lambda: n)
    for axis in range(len(shape)):
        src = local.start_rotate([torch.arange(n)[:, None]], axis).wait()[0]
        for r in range(n):
            monkeypatch.setattr(dist, "get_rank", lambda r=r: r)
            c = pcomm.DistComm(shape)
            assert c.worker_ids("cpu").tolist() == [r]
            if shape[axis] > 1:
                assert c._peer(axis, -1) == int(src[r, 0])
                assert c._peer(axis, 1) == int(
                    torch.nonzero(src[:, 0] == r)[0, 0])


def test_worker_ids_are_row_major():
    c = pcomm.LocalComm((2, 4))
    assert c.worker_ids("cpu").tolist() == list(range(8))
    assert pcomm._unravel(6, (2, 4)) == (1, 2)
    assert pcomm._ravel((1, 2), (2, 4)) == 6


@pytest.mark.parametrize("shape", [(8,), (2, 4), (3,)])
def test_full_cycle_returns_the_visiting_state(shape):
    comm = pcomm.LocalComm(shape)
    g = torch.Generator().manual_seed(0)
    b = torch.randn(comm.n_workers, 5, generator=g)
    ib = torch.arange(comm.n_workers * 5).reshape(comm.n_workers, 5)
    stops = []

    def stats(a, bv, ibv):
        stops.append(ibv[:, 0].clone())
        z = torch.zeros(a.shape[0], dtype=torch.float64)
        return z, z

    zero = torch.zeros(comm.n_workers, dtype=torch.float64)
    for axis in range(len(shape)):
        stops.clear()
        _, vis = ring._ring_accumulate(stats, b, [b, ib], comm=comm,
                                       axis=axis, acc=(zero, zero))
        assert torch.equal(vis[0], b) and torch.equal(vis[1], ib)
        assert len(stops) == shape[axis]
    # the hierarchical cycle visits every block once at every worker
    seen = []
    _, state = ring._hier_cycle(
        [ib], tuple(range(len(shape))),
        lambda acc, st: seen.append(st[0][:, 0].clone()) or acc, None, comm)
    assert torch.equal(state[0], ib)
    visits = torch.stack(seen)                        # [N stops, N workers]
    for w in range(comm.n_workers):
        assert sorted(visits[:, w].tolist()) == list(
            range(0, 5 * comm.n_workers, 5))


def _scores(n1, n2, seed=0):
    rng = np.random.default_rng(seed)
    # quarter-lattice scores with many ties, the auc's worst case
    a = (np.round(rng.normal(size=n1) * 4) / 4 + 0.25).astype(np.float32)
    b = (np.round(rng.normal(size=n2) * 4) / 4).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


MESHES = {
    "1d8": lambda: make_mesh(8, "cpu"),
    "1d3": lambda: make_mesh(3, "cpu"),
    "2d": lambda: make_mesh_2d(2, 4, "cpu"),
}


def _pair_ring(mesh):
    return (ring.ring_pair_stats_2d if len(mesh.shape) == 2
            else ring.ring_pair_stats)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["auc", "hinge", "logistic"])
@pytest.mark.parametrize("n1,n2", [(96, 72), (101, 67)])
def test_ring_pair_stats_equal_single_device(mesh_name, name, n1, n2):
    mesh = MESHES[mesh_name]()
    k = get_kernel(name)
    a, b = _scores(n1, n2)
    pa, ma, _ = pack_blocks(a, mesh)
    pb, mb, _ = pack_blocks(b, mesh)
    full = n1 % mesh.n_workers == 0 and n2 % mesh.n_workers == 0
    s, c = _pair_ring(mesh)(k, pa, pb, None if full else ma,
                            None if full else mb, mesh=mesh)
    want_s, want_c = pair_tiles.pair_stats(k, a, b)
    assert s.dtype == torch.float64 and float(c) == float(want_c) == n1 * n2
    if name == "auc":
        assert float(s) == float(want_s)
        assert float(s) == float(pk.pair_sum(a, b, k))
    else:
        assert abs(float(s) - float(want_s)) <= 1e-12 * abs(float(want_s))


@pytest.mark.parametrize("mesh_name", ["1d8", "2d"])
def test_ring_one_sample_ids_equal_single_device(mesh_name):
    """The id path (one-sample kernels): the diagonal, and nothing else,
    is excluded across shards."""
    mesh = MESHES[mesh_name]()
    k = get_kernel("scatter")
    X = torch.from_numpy(
        np.random.default_rng(3).normal(size=(45, 3)).astype(np.float32))
    px, mx, ix = pack_blocks(X, mesh)
    s, c = _pair_ring(mesh)(k, px, px, mx, mx, ix, ix, mesh=mesh)
    ids = torch.arange(45)
    want_s, want_c = pair_tiles.pair_stats(k, X, X, ids_a=ids, ids_b=ids)
    assert float(c) == float(want_c) == 45 * 44
    assert abs(float(s) - float(want_s)) <= 1e-12 * abs(float(want_s))


def test_pack_blocks_is_pack_all():
    X = np.random.default_rng(1).normal(size=(37, 2)).astype(np.float32)
    for mesh in (make_mesh(8, "cpu"), make_mesh_2d(2, 3, "cpu")):
        p, m, i = pack_all(X, mesh.n_workers)
        tp, tm, ti = pack_blocks(torch.from_numpy(X), mesh)
        np.testing.assert_array_equal(tp.numpy(), p)
        np.testing.assert_array_equal(tm.numpy(), m)
        np.testing.assert_array_equal(ti.numpy(), i)


def _triplet_data(n1, n2, d=3, seed=4):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(n1, d)).astype(np.float32))
    Y = torch.from_numpy((rng.normal(size=(n2, d)) + 0.3).astype(np.float32))
    return X, Y


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ["triplet_indicator", "triplet_hinge"])
@pytest.mark.parametrize("n1,n2", [(40, 32), (37, 29)])
def test_ring_triplet_stats_equal_single_device(mesh_name, name, n1, n2):
    mesh = MESHES[mesh_name]()
    k = get_kernel(name)
    X, Y = _triplet_data(n1, n2)
    px, mx, ix = pack_blocks(X, mesh)
    py, my, _ = pack_blocks(Y, mesh)
    fn = (ring.ring_triplet_stats_2d if len(mesh.shape) == 2
          else ring.ring_triplet_stats)
    s, c = fn(k, px, py, mx, my, ix, mesh=mesh)
    want_s, want_c = triplet_kernels.triplet_stats_best(k, X, Y)
    assert float(c) == float(want_c) == n1 * (n1 - 1) * n2
    if name == "triplet_indicator":
        assert float(s) == float(want_s)
    else:
        assert abs(float(s) - float(want_s)) <= 1e-6 * abs(float(want_s))


def test_custom_triplet_kernel_takes_the_tiled_scan():
    import dataclasses

    base = get_kernel("triplet_indicator")
    k = dataclasses.replace(
        base, name="custom_tri",
        triplet_fn=lambda a, p, n: base.triplet_fn(a, p, n))
    assert triplet_kernels.triplet_combine_kernel(k) is None
    mesh = make_mesh(4, "cpu")
    X, Y = _triplet_data(21, 14)
    px, mx, ix = pack_blocks(X, mesh)
    py, my, _ = pack_blocks(Y, mesh)
    s, c = ring.ring_triplet_stats(k, px, py, mx, my, ix, mesh=mesh)
    want_s, want_c = pair_tiles.triplet_stats(k, X, Y)
    assert float(s) == float(want_s) and float(c) == float(want_c)


def test_ids_contracts_raise():
    mesh, mesh2 = make_mesh(4, "cpu"), make_mesh_2d(2, 2, "cpu")
    k = get_kernel("auc")
    a = torch.zeros(4, 3)
    ids = torch.zeros(4, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="BOTH ids_a and ids_b"):
        ring.ring_pair_stats(k, a, a, ids_a=ids, mesh=mesh)
    with pytest.raises(ValueError, match="BOTH ids_a and ids_b"):
        ring.ring_pair_stats_2d(k, a, a, ids_b=ids, mesh=mesh2)
    t = get_kernel("triplet_indicator")
    x = torch.zeros(4, 3, 2)
    with pytest.raises(ValueError, match="requires global ids_x"):
        ring.ring_triplet_stats(t, x, x, mesh=mesh)
    with pytest.raises(ValueError, match="requires global ids_x"):
        ring.ring_triplet_stats_2d(t, x, x, mesh=mesh2)
    with pytest.raises(ValueError, match="2-D mesh"):
        ring.ring_pair_stats_2d(k, a, a, mesh=mesh)


def test_stop_routes():
    """Each stop's route, as the JAX _make_stats_fn picks it: no masks
    -> kernel 1, masks -> kernel 2, ids -> the tiled scan; only the
    fields a route reads rotate."""
    k = get_kernel("auc")
    build = functools.partial(ring._make_stats_fn, k, None, None, impl=None)
    assert build(use_ids=False, no_masks=True)[1] == ("b",)
    assert build(use_ids=False, no_masks=False)[1] == ("b", "mb")
    fn, fields = build(use_ids=True, no_masks=False)
    assert fields == ("b", "mb", "ib") and fn.__name__ == "tiled_stats_fn"
    fn, _ = ring._make_stats_fn(get_kernel("scatter"), None, None,
                                use_ids=False, impl=None, no_masks=True)
    assert fn.__name__ == "tiled_stats_fn"


@pytest.mark.cuda
def test_ring_kernels_match_plain_on_card():
    """Every stop one batched launch of kernel 1 (no padding) or kernel 2
    (padding) on the card, against impl="plain" on the same ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    mesh = make_mesh(8)
    g = torch.Generator(device="cuda").manual_seed(0)
    for n1, n2, key in ((8000, 6400, "pair_sum"),
                        (8003, 6395, "masked_pair_sum")):
        a = torch.randn(n1, generator=g, device="cuda") + 0.5
        b = torch.randn(n2, generator=g, device="cuda")
        pa, ma, _ = pack_blocks(a, mesh)
        pb, mb, _ = pack_blocks(b, mesh)
        full = key == "pair_sum"
        for name in ("auc", "hinge", "logistic"):
            k = get_kernel(name)
            args = (k, pa, pb, None if full else ma, None if full else mb)
            pk.reset_launch_counts()
            s, c = ring.ring_pair_stats(*args, mesh=mesh)
            assert pk.LAUNCHES[f"{key}[{name}]"] == 8
            sp, cp = ring.ring_pair_stats(*args, mesh=mesh, impl="plain")
            assert float(c) == float(cp)
            if name == "auc":
                assert float(s) == float(sp)
            else:
                assert abs(float(s) - float(sp)) <= 1e-5 * abs(float(sp))
    X = torch.randn(300, 8, generator=g, device="cuda")
    Y = torch.randn(260, 8, generator=g, device="cuda") + 0.2
    px, mx, ix = pack_blocks(X, mesh)
    py, my, _ = pack_blocks(Y, mesh)
    for name in ("triplet_indicator", "triplet_hinge"):
        k = get_kernel(name)
        pk.reset_launch_counts()
        s, c = ring.ring_triplet_stats(k, px, py, mx, my, ix, mesh=mesh)
        assert pk.LAUNCHES[f"batched_masked_pair_sum[{name}]"] == 64
        sp, cp = ring.ring_triplet_stats(k, px, py, mx, my, ix, mesh=mesh,
                                         impl="plain")
        assert float(c) == float(cp)
        assert abs(float(s) - float(sp)) <= 1e-5 * abs(float(sp))
