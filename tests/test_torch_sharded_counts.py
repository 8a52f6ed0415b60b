"""The mesh half of the port's count layer (parallel.sharded_counts with a
mesh) against the JAX package on its 8 virtual CPU devices: the
worker-axis plain versions of kernels 6 and 7 and their batched
searchsorted twins, summed over the workers, equal JAX
``sharded_signed_count_fn`` / ``tenant_signed_count_fn`` (Pallas
interpret mode) and JAX ``sharded_counts`` as integers; ``place_base``
places the same [S, cap] rows and ships (and saves) the same bytes;
``plan_major_merge`` gives the same arrays; ``sharded_major_merge`` and
``delta_append`` build the rows the JAX functions build, and the merge
equals ``place_base`` of the merged run. The int32 envelope raises. The
``cuda``-marked cases hold each worker-axis kernel against its plain
version on the card."""

import numpy as np
import pytest
import torch

from tuplewise_tpu.ops import pallas_counts as jax_pc
from tuplewise_tpu.parallel import sharded_counts as jax_sc
from tuplewise_tpu.parallel.mesh import make_mesh as jax_mesh
from tuplewise_tpu.utils.profiling import MetricsRegistry as JaxRegistry
from tuplewise_tpu_torch.ops import count_kernels as ck
from tuplewise_tpu_torch.ops import pair_kernels as pk
from tuplewise_tpu_torch.parallel import sharded_counts as sc
from tuplewise_tpu_torch.parallel.mesh import make_mesh
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry


def _runs(seed):
    """Base (+1, set a), delta (+1, set b), tombstones (-1, both sets),
    with ties at run values, as sorted float32 host arrays."""
    rng = np.random.default_rng(seed)
    base = np.sort(rng.standard_normal(
        int(rng.integers(1, 900)))).astype(np.float32)
    base[::7] = np.round(base[::7], 1)
    base = np.sort(base)
    delta = np.sort(rng.standard_normal(
        int(rng.integers(1, 120)))).astype(np.float32)
    tomb = np.sort(rng.choice(base, int(rng.integers(1, min(12, len(base))
                                                     + 1)),
                              replace=False)).astype(np.float32)
    qa = rng.standard_normal(int(rng.integers(1, 50))).astype(np.float32)
    qa[: min(3, len(qa))] = base[: min(3, len(qa))]
    qb = rng.standard_normal(int(rng.integers(1, 70))).astype(np.float32)
    qb[: min(2, len(qb))] = base[-min(2, len(qb)):]
    return [(base, 1, 0), (delta, 1, 1), (tomb, -1, 0), (tomb, -1, 1)], \
        qa, qb


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_worker_axis_counts_equal_jax_sharded_kernel(S, seed):
    runs, qa, qb = _runs(seed)
    jm, pm = jax_mesh(S), make_mesh(S, "cpu")
    jdev, pdev, caps = [], [], []
    for arr, _, _ in runs:
        d, cap, _ = jax_sc.place_base(jm, arr, np.float32)
        p, pcap, _ = sc.place_base(pm, arr)
        assert cap == pcap
        np.testing.assert_array_equal(np.asarray(d), p.numpy())
        jdev.append(d)
        pdev.append(p)
        caps.append(cap)
    signs = tuple(s for _, s, _ in runs)
    sets = tuple(a for _, _, a in runs)
    qbk = sc.next_bucket(max(len(qa), len(qb)))
    qa_p = np.zeros(qbk, np.float32)
    qa_p[:len(qa)] = qa
    qb_p = np.zeros(qbk, np.float32)
    qb_p[:len(qb)] = qb
    want = np.asarray(jax_pc.sharded_signed_count_fn(
        jm, tuple(caps), signs, sets, qbk, True)(tuple(jdev), qa_p, qb_p))
    args = (pdev, signs, sets, torch.from_numpy(qa), torch.from_numpy(qb))
    for fn in (ck.signed_count_mesh_plain, sc.signed_count_searchsorted_mesh,
               ck.signed_count_mesh):
        blocks = fn(*args)
        assert tuple(blocks.shape) == (S, 4, max(len(qa), len(qb)))
        got = blocks.sum(0).numpy()
        for row, n in ((0, len(qa)), (1, len(qa)), (2, len(qb)),
                       (3, len(qb))):
            np.testing.assert_array_equal(got[row, :n], want[row, :n])
    for kernel in (None, True):
        out = sc.signed_pair_counts(
            pm, [(p, c, s) for p, c, (_, s, a) in zip(pdev, caps, runs)
                 if a == 0],
            [(p, c, s) for p, c, (_, s, a) in zip(pdev, caps, runs)
             if a == 1], qa, qb, kernel=kernel)
        ref = jax_sc.signed_pair_counts(
            jm, [(d, c, s) for d, c, (_, s, a) in zip(jdev, caps, runs)
                 if a == 0],
            [(d, c, s) for d, c, (_, s, a) in zip(jdev, caps, runs)
             if a == 1], qa, qb, np.float32, kernel=kernel and True)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_counts_with_deltas_equal_jax(S):
    rng = np.random.default_rng(S)
    base = np.sort(rng.standard_normal(1001)).astype(np.float32)
    delta = np.sort(rng.standard_normal(77)).astype(np.float32)
    q = np.concatenate([base[::50], rng.standard_normal(20)]).astype(
        np.float32)
    jm, pm = jax_mesh(S), make_mesh(S, "cpu")
    jb, cap, _ = jax_sc.place_base(jm, base, np.float32)
    jd, dcap, _ = jax_sc.place_base(jm, delta, np.float32)
    pb, _, _ = sc.place_base(pm, base)
    pd, _, _ = sc.place_base(pm, delta)
    for deltas_j, deltas_p, b_j, b_p in (
            (((jd, dcap),), ((pd, dcap),), jb, pb),
            ((), (), jb, pb), (((jd, dcap),), ((pd, dcap),), None, None)):
        want = jax_sc.sharded_counts(jm, b_j, cap, q, np.float32,
                                     deltas=deltas_j)
        got = sc.sharded_counts(pm, b_p, cap, q, deltas=deltas_p)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _tenant_runs(T, seed):
    rng = np.random.default_rng(seed)
    runs_p, runs_n = [], []
    for t in range(T):
        runs_p.append(np.sort(rng.standard_normal(
            int(rng.integers(0, 90)))).astype(np.float32))
        runs_n.append(np.sort(np.round(rng.standard_normal(
            int(rng.integers(0, 70))), 1)).astype(np.float32))
    return runs_p, runs_n


@pytest.mark.parametrize("S,T", [(1, 8), (2, 13), (4, 33)])
def test_tenant_worker_axis_counts_equal_jax(S, T):
    runs_p, runs_n = _tenant_runs(T, S + T)
    tb = sc.tenant_bucket(T)
    jm, pm = jax_mesh(S), make_mesh(S, "cpu")
    jp, cap_p, _ = jax_sc.place_tenant_pack(jm, runs_p, tb, np.float32)
    jn, cap_n, _ = jax_sc.place_tenant_pack(jm, runs_n, tb, np.float32)
    pp, pcap_p, _ = sc.place_tenant_pack(pm, runs_p, tb)
    pn, pcap_n, _ = sc.place_tenant_pack(pm, runs_n, tb)
    assert (cap_p, cap_n) == (pcap_p, pcap_n)
    np.testing.assert_array_equal(np.asarray(jp), pp.numpy())
    np.testing.assert_array_equal(np.asarray(jn), pn.numpy())
    rng = np.random.default_rng(T)
    qb = 256
    qn = np.round(rng.standard_normal((tb, qb)), 1).astype(np.float32)
    qp = rng.standard_normal((tb, qb)).astype(np.float32)
    want = np.asarray(jax_pc.tenant_signed_count_fn(
        jm, tb, cap_p, cap_n, qb, True)(jp, jn, qn.T.copy(), qp.T.copy()))
    want = want.transpose(0, 2, 1)            # [4, qb, T] -> [4, T, qb]
    args = (pp, pn, torch.from_numpy(qn), torch.from_numpy(qp))
    for fn in (ck.tenant_count_mesh_plain, sc.tenant_count_searchsorted_mesh,
               ck.tenant_count_mesh):
        blocks = fn(*args)
        assert tuple(blocks.shape) == (S, 4, tb, qb)
        np.testing.assert_array_equal(blocks.sum(0).numpy(), want)
    for kernel in (None, True):
        got = sc.tenant_pack_counts(pm, pp, cap_p, pn, cap_n, tb, qn, qp,
                                    kernel=kernel)
        ref = jax_sc.tenant_pack_counts(jm, jp, cap_p, jn, cap_n, tb, qn,
                                        qp, np.float32, kernel=None)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_place_base_reuses_rows_and_counts_the_jax_bytes():
    """The JAX TestPlacementReuse cases: a tail append ships one row, an
    identical run ships nothing, a new geometry ships all; the byte
    counters equal the JAX ones."""
    rng = np.random.default_rng(0)
    base = np.sort(rng.standard_normal(999).astype(np.float32))
    ext = np.concatenate([base, [base[-1] + 1.0]]).astype(np.float32)
    grown = np.sort(rng.standard_normal(2100).astype(np.float32))
    jm, pm = jax_mesh(4), make_mesh(4, "cpu")
    jr, pr = JaxRegistry(), MetricsRegistry()
    jd, cap, s0 = jax_sc.place_base(jm, base, np.float32, metrics=jr)
    pd, pcap, t0 = sc.place_base(pm, base, metrics=pr)
    assert (cap, s0) == (pcap, t0) == (cap, 4 * cap * 4)
    steps = [(ext, base), (ext, ext), (grown, ext)]
    for arr, prev in steps:
        jd, cap, s = jax_sc.place_base(jm, arr, np.float32,
                                       prev=(prev, jd, cap), metrics=jr)
        pd2, pcap, t = sc.place_base(pm, arr, prev=(prev, pd, pcap),
                                     metrics=pr)
        assert (cap, s) == (pcap, t)
        if t == 0:
            assert pd2 is pd
        np.testing.assert_array_equal(np.asarray(jd), pd2.numpy())
        pd = pd2
        for k in ("bytes_h2d", "bytes_h2d_saved"):
            assert (jr.snapshot()[k]["value"]
                    == pr.snapshot()[k]["value"]), k
    assert pr.snapshot()["bytes_h2d_saved"]["value"] == 3 * 256 * 4 + 4 * \
        256 * 4
    less, leq = sc.sharded_counts(pm, pd, pcap, ext[:17])
    np.testing.assert_array_equal(less, np.searchsorted(grown, ext[:17]))
    np.testing.assert_array_equal(
        leq, np.searchsorted(grown, ext[:17], side="right"))


def test_place_base_reuse_keeps_the_previous_placement():
    """Row reuse copies on the device: the placement a count may still be
    reading stays as it was."""
    pm = make_mesh(2, "cpu")
    base = np.arange(599, dtype=np.float32)
    pd, cap, _ = sc.place_base(pm, base)
    before = pd.clone()
    ext = np.concatenate([base, [1e4]]).astype(np.float32)
    pd2, _, shipped = sc.place_base(pm, ext, prev=(base, pd, cap))
    assert shipped == cap * 4 and pd2 is not pd
    assert torch.equal(pd, before)


@pytest.mark.parametrize("n,m,S", [(4001, 700, 2), (4001, 700, 4),
                                   (100, 400, 4), (17, 3, 8),
                                   (5000, 5000, 2), (300, 1, 1)])
def test_plan_major_merge_equals_jax(n, m, S):
    rng = np.random.default_rng(n + m + S)
    base = np.sort(np.round(rng.standard_normal(n), 2)).astype(np.float32)
    delta = np.sort(np.round(rng.standard_normal(m), 2)).astype(np.float32)
    got, want = sc.plan_major_merge(base, delta, S), \
        jax_sc.plan_major_merge(base, delta, S)
    np.testing.assert_array_equal(got.pos, want.pos)
    np.testing.assert_array_equal(got.meta, want.meta)
    assert (got.cap_out, got.per_out, got.ok) == (want.cap_out,
                                                  want.per_out, want.ok)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_sharded_major_merge_equals_place_base_of_the_merge(S):
    rng = np.random.default_rng(S)
    base = np.sort(np.round(rng.standard_normal(4001), 2)).astype(np.float32)
    delta = np.sort(np.round(rng.standard_normal(700), 2)).astype(np.float32)
    jm, pm = jax_mesh(S), make_mesh(S, "cpu")
    pb, cap, _ = sc.place_base(pm, base)
    pd, dcap, _ = sc.place_base(pm, delta)
    plan = sc.plan_major_merge(base, delta, S)
    assert plan.ok
    out, cap_out = sc.sharded_major_merge(pm, pb, cap, ((pd, dcap),), plan)
    merged = np.sort(np.concatenate([base, delta]))
    expect, expect_cap, _ = sc.place_base(pm, merged)
    assert cap_out == expect_cap
    assert torch.equal(out, expect)
    jb, _, _ = jax_sc.place_base(jm, base, np.float32)
    jd, _, _ = jax_sc.place_base(jm, delta, np.float32)
    jout, _ = jax_sc.sharded_major_merge(jm, jb, cap, ((jd, dcap),), plan)
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())


def test_sharded_major_merge_in_chunks(monkeypatch):
    """A merge of several chunks (the pause bound) builds the same rows
    as one chunk."""
    rng = np.random.default_rng(9)
    base = np.sort(rng.standard_normal(6000)).astype(np.float32)
    delta = np.sort(rng.standard_normal(900)).astype(np.float32)
    pm = make_mesh(2, "cpu")
    pb, cap, _ = sc.place_base(pm, base)
    pd, dcap, _ = sc.place_base(pm, delta)
    plan = sc.plan_major_merge(base, delta, 2)
    whole, _ = sc.sharded_major_merge(pm, pb, cap, ((pd, dcap),), plan)
    monkeypatch.setattr(sc, "_MERGE_CHUNK", 256)
    chunked, _ = sc.sharded_major_merge(pm, pb, cap, ((pd, dcap),), plan)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_delta_append_equals_jax(S):
    rng = np.random.default_rng(10 + S)
    delta = np.sort(np.round(rng.standard_normal(333), 1)).astype(np.float32)
    chunk = np.sort(np.round(rng.standard_normal(190), 1)).astype(np.float32)
    jm, pm = jax_mesh(S), make_mesh(S, "cpu")
    jd, dcap, _ = jax_sc.place_base(jm, delta, np.float32)
    jc, ccap, _ = jax_sc.place_base(jm, chunk, np.float32)
    pd, _, _ = sc.place_base(pm, delta)
    pc, _, _ = sc.place_base(pm, chunk)

    def rows(n):
        per = -(-n // S)
        return np.clip(n - per * np.arange(S), 0, per)

    cap_new = sc.next_bucket(int((rows(len(delta)) + rows(len(chunk))).max()))
    want = jax_sc.delta_append_fn(jm, dcap, ccap, cap_new)(jd, jc)
    got = sc.delta_append(pd, dcap, pc, ccap, cap_new)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # the rows together are the merged multiset
    vals = got.numpy().ravel()
    np.testing.assert_array_equal(np.sort(vals[np.isfinite(vals)]),
                                  np.sort(np.concatenate([delta, chunk])))


def test_int32_envelope_raises(monkeypatch):
    """The worker-axis wrappers hold the sum over workers below the int32
    limit (here lowered, to check it without 2^31 values)."""
    runs = [torch.zeros(4, 256), torch.zeros(4, 512)]
    q = torch.zeros(3)
    ck.signed_count_mesh(runs, [1, 1], [0, 1], q, q)
    monkeypatch.setattr(ck, "_COUNT_LIMIT", 4 * 768)
    with pytest.raises(ValueError, match="all workers"):
        ck.signed_count_mesh(runs, [1, 1], [0, 1], q, q)
    pack = torch.zeros(4, 8, 768)
    qq = torch.zeros(8, 5)
    with pytest.raises(ValueError, match="over all workers"):
        ck.tenant_count_mesh(pack, pack, qq, qq)


def test_argument_checks_and_cpu_dispatch():
    q = torch.zeros(4)
    with pytest.raises(ValueError, match="one S"):
        ck.signed_count_mesh([torch.zeros(2, 8), torch.zeros(3, 8)],
                             [1, 1], [0, 0], q, q)
    with pytest.raises(ValueError, match="at most 8"):
        ck.signed_count_mesh([torch.zeros(2, 8)] * 9, [1] * 9, [0] * 9, q, q)
    with pytest.raises(TypeError, match=r"\[S, T, cap\]"):
        ck.tenant_count_mesh(torch.zeros(8, 4), torch.zeros(8, 4),
                             torch.zeros(8, 2), torch.zeros(8, 2))
    runs, qa, qb = _runs(3)
    pm = make_mesh(2, "cpu")
    placed = [sc.place_base(pm, r)[0] for r, _, _ in runs]
    args = (placed, [s for _, s, _ in runs], [a for _, _, a in runs],
            torch.from_numpy(qa), torch.from_numpy(qb))
    pk.reset_launch_counts()
    assert torch.equal(ck.signed_count_mesh(*args),
                       ck.signed_count_mesh_plain(*args))
    assert sum(pk.LAUNCHES.values()) == 0
    with pytest.raises(TypeError, match="placed by place_base"):
        sc.signed_pair_counts(pm, [(runs[0][0], 1024, 1)], [], qa, qb)


@pytest.mark.cuda
def test_worker_axis_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA count kernels have no "
                    "CPU mode")
    for S in (1, 3, 8):
        for seed in range(2):
            runs, qa, qb = _runs(seed)
            pm = make_mesh(S, "cuda")
            placed = [sc.place_base(pm, r)[0] for r, _, _ in runs]
            args = (placed, [s for _, s, _ in runs],
                    [a for _, _, a in runs], torch.from_numpy(qa).cuda(),
                    torch.from_numpy(qb).cuda())
            pk.reset_launch_counts()
            got = ck.signed_count_mesh(*args)
            assert pk.LAUNCHES["signed_count[mesh]"] == 1
            assert torch.equal(got, ck.signed_count_mesh_plain(*args))
            assert torch.equal(got, sc.signed_count_searchsorted_mesh(*args))
        runs_p, runs_n = _tenant_runs(37, S)
        tb = sc.tenant_bucket(37)
        pp, _, _ = sc.place_tenant_pack(pm, runs_p, tb)
        pn, _, _ = sc.place_tenant_pack(pm, runs_n, tb)
        rng = np.random.default_rng(S)
        qn = torch.from_numpy(np.round(rng.standard_normal((tb, 300)), 1)
                              .astype(np.float32)).cuda()
        qp = torch.from_numpy(rng.standard_normal((tb, 300))
                              .astype(np.float32)).cuda()
        pk.reset_launch_counts()
        got = ck.tenant_count_mesh(pp, pn, qn, qp)
        assert pk.LAUNCHES["tenant_count[mesh]"] == 1
        assert torch.equal(got, ck.tenant_count_mesh_plain(pp, pn, qn, qp))
        assert torch.equal(got,
                           sc.tenant_count_searchsorted_mesh(pp, pn, qn, qp))


@pytest.mark.cuda
def test_worker_axis_launch_failure_raises_on_card(monkeypatch):
    """A launch that fails raises; nothing falls back to plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA count kernels have no "
                    "CPU mode")

    class _Failing:
        def tw_signed_count_mesh(self, *a):
            return 1

        def tw_tenant_count_mesh(self, *a):
            return 1

    monkeypatch.setattr(ck, "load_library", lambda: _Failing())
    monkeypatch.setattr(ck, "load_tenant_library", lambda: _Failing())
    r = torch.zeros(2, 256, device="cuda")
    q = torch.zeros(4, device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        ck.signed_count_mesh([r], [1], [0], q, q)
    pack = torch.zeros(2, 8, 256, device="cuda")
    qq = torch.zeros(8, 4, device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        ck.tenant_count_mesh(pack, pack, qq, qq)


@pytest.mark.cuda
def test_row_reuse_on_card():
    """On the card ("cuda" names the current card, which a tensor reports
    with its index) a tail append re-ships one row of the base and a
    dirty tenant one bucket of rows a worker, as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pm = make_mesh(4, "cuda")
    base = np.arange(999, dtype=np.float32)
    pd, cap, _ = sc.place_base(pm, base)
    ext = np.concatenate([base, [1e4]]).astype(np.float32)
    pd2, _, shipped = sc.place_base(pm, ext, prev=(base, pd, cap))
    assert shipped == cap * 4
    assert torch.equal(pd2.cpu(), sc.place_base(pm, ext)[0].cpu())
    runs = [np.sort(np.random.default_rng(t).standard_normal(40 + t))
            .astype(np.float32) for t in range(8)]
    pack, pcap, _ = sc.place_tenant_pack(pm, runs, 8)
    runs[3] = np.sort(np.concatenate([runs[3], [0.5]])).astype(np.float32)
    pack2, _, shipped = sc.place_tenant_pack(pm, runs, 8,
                                             prev=(pack, pcap, 8), dirty=[3])
    assert shipped == 4 * 1 * pcap * 4 and pack2 is pack
    assert torch.equal(pack2.cpu(), sc.place_tenant_pack(pm, runs, 8)[0].cpu())
