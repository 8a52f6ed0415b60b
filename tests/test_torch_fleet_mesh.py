"""The port's mesh fleet (TenantFleetIndex on a LocalComm mesh,
device="cpu") against the JAX fleet on its 8 virtual CPU devices, case
for case with the mesh cases of tests/test_tenancy.py (parity at S = 1,
2 and 4, scores, device loss and compactor crash), of
tests/test_fleet_incremental.py (dirty-row reuse, whale promotion onto
the fleet's mesh, the promote/demote soak, chaos mid-promotion, device
loss after promotion), of tests/test_pallas_counts.py (the fleet kernel
with promotion, demotion and drops, and across fleet sizes) and of
tests/test_control.py TestMeshResize: per-tenant wins2 and AUC equal
bit for bit, and the pack byte counters equal the JAX fleet's."""

import numpy as np
import pytest

from tuplewise_tpu.serving.tenancy import TenantFleetIndex as JaxFleet
from tuplewise_tpu.testing.chaos import FaultInjector as JaxInjector
from tuplewise_tpu_torch.serving import (
    ExactAucIndex, ServingConfig, TenantFleetIndex,
    make_tenant_stream, replay_fleet,
)
from tuplewise_tpu_torch.testing import FaultInjector

_PACK_COUNTERS = ("bytes_h2d", "bytes_h2d_saved", "pack_replaces_total",
                  "pack_full_replaces_total")


def _v(m, name):
    return m.get(name, {}).get("value", 0)


def _tenant_streams(n_tenants, n_events, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k in range(n_tenants):
        labels = rng.random(n_events) < 0.5
        scores = (rng.standard_normal(n_events) + 0.8 * labels).astype(
            np.float32)
        out[f"t{k}"] = (scores, labels)
    return out


def _drive(fleets, streams, *, singles=None, window=None,
           compact_every=64, chunk_rng_seed=1):
    """Feed the per-tenant streams, as random coalesced batches, into
    every fleet of ``fleets`` and into single-device port indexes."""
    if singles is None:
        singles = {t: ExactAucIndex(window=window, device="cpu",
                                    compact_every=compact_every)
                   for t in streams}
    n = len(next(iter(streams.values()))[0])
    pos = {t: 0 for t in streams}
    rng = np.random.default_rng(chunk_rng_seed)
    while any(pos[t] < n for t in streams):
        items = []
        for t in streams:
            if pos[t] >= n or rng.random() > 0.7:
                continue
            k = int(rng.integers(1, 40))
            s, l = streams[t]
            items.append((t, s[pos[t]:pos[t] + k], l[pos[t]:pos[t] + k]))
            pos[t] += k
        if items:
            for f in fleets:
                f.apply_inserts(items)
            for t, s, l in items:
                singles[t].insert_batch(s, l)
    return singles


def _same_packs(fleet, ref):
    got, want = fleet.metrics.snapshot(), ref.metrics.snapshot()
    for k in _PACK_COUNTERS:
        assert _v(got, k) == _v(want, k), k


class TestFleetParity:
    @pytest.mark.parametrize("shards,window,count_kernel", [
        (1, None, False), (2, 128, False), (4, 64, False), (2, 128, True),
        (4, None, True)])
    def test_wins2_bit_identical(self, shards, window, count_kernel):
        streams = _tenant_streams(5, 300, seed=2)
        kw = dict(window=window, compact_every=64, shards=shards,
                  count_kernel=count_kernel)
        fleet = TenantFleetIndex(device="cpu", **kw)
        ref = JaxFleet(**kw)
        singles = _drive([fleet, ref], streams, window=window)
        for t in streams:
            assert fleet.wins2(t) == singles[t]._wins2 == ref.wins2(t), t
            assert fleet.auc(t) == singles[t].auc() == ref.auc(t), t
        _same_packs(fleet, ref)
        assert fleet.state()["shards"] == shards

    def test_score_parity(self):
        streams = _tenant_streams(3, 200, seed=3)
        fleet = TenantFleetIndex(device="cpu", compact_every=32, shards=2)
        singles = _drive([fleet], streams, compact_every=32)
        q = np.random.default_rng(4).standard_normal(13)
        ranks = fleet.apply_scores([(t, q) for t in streams])
        for i, t in enumerate(streams):
            np.testing.assert_array_equal(ranks[i],
                                          singles[t].score_batch(q))


class TestChaosFleet:
    def test_device_loss_and_compactor_crash_parity(self):
        spec = {"faults": [
            {"point": "sharded_count", "on_call": 3, "action": "error",
             "dropped": [1]},
            {"point": "compactor_build", "on_call": 1, "action": "error"},
            {"point": "place_base", "on_call": 4, "action": "error"},
        ]}
        chaos = FaultInjector.from_spec(spec)
        streams = _tenant_streams(4, 260, seed=11)
        fleet = TenantFleetIndex(device="cpu", window=128, compact_every=32,
                                 shards=2, chaos=chaos, retry_backoff_s=0.0)
        ref = JaxFleet(window=128, compact_every=32, shards=2,
                       chaos=JaxInjector.from_spec(spec))
        singles = _drive([fleet, ref], streams, window=128,
                         compact_every=32)
        snap = chaos.snapshot()
        assert snap["fired"] == ref.chaos.snapshot()["fired"] == {
            "sharded_count": 1, "compactor_build": 1, "place_base": 1}
        m = fleet.metrics.snapshot()
        assert m["reshard_events"]["value"] >= 1
        assert m["fleet_compact_aborts"]["value"] == 1
        assert fleet.shards == 1 == ref.shards
        for t in streams:
            assert fleet.wins2(t) == singles[t]._wins2 == ref.wins2(t), t
            assert fleet.auc(t) == singles[t].auc(), t

    def test_heal_preserves_scores(self):
        chaos = FaultInjector.from_spec({"faults": [
            {"point": "sharded_count", "on_call": 2, "action": "error",
             "dropped": [0]}]})
        streams = _tenant_streams(3, 120, seed=12)
        fleet = TenantFleetIndex(device="cpu", compact_every=16, shards=2,
                                 chaos=chaos, retry_backoff_s=0.0)
        singles = _drive([fleet], streams, compact_every=16)
        q = np.linspace(-1, 1, 9)
        ranks = fleet.apply_scores([(t, q) for t in streams])
        for i, t in enumerate(streams):
            np.testing.assert_array_equal(ranks[i],
                                          singles[t].score_batch(q))
        assert fleet.shards == 1


def _stream(n, seed=0, sep=0.8):
    rng = np.random.default_rng(seed)
    labels = rng.random(n) < 0.5
    scores = (rng.standard_normal(n) + sep * labels).astype(np.float32)
    return scores, labels


class TestIncremental:
    def test_geometry_stable_reuse_saves_the_jax_bytes(self):
        fleet = TenantFleetIndex(device="cpu", compact_every=32, shards=2)
        ref = JaxFleet(compact_every=32, shards=2)
        streams = {f"t{k}": _stream(200, seed=k) for k in range(6)}
        for tid, (s, l) in streams.items():
            for i in range(0, 200, 40):
                fleet.apply_inserts([(tid, s[i:i + 40], l[i:i + 40])])
                ref.apply_inserts([(tid, s[i:i + 40], l[i:i + 40])])
        m = fleet.metrics.snapshot()
        assert _v(m, "bytes_h2d_saved") > 0
        assert _v(m, "pack_replaces_total") > _v(m, "pack_full_replaces_total")
        _same_packs(fleet, ref)
        for tid, (s, l) in streams.items():
            single = ExactAucIndex(device="cpu", compact_every=32)
            single.insert_batch(s, l)
            assert fleet.wins2(tid) == single._wins2 == ref.wins2(tid), tid

    @pytest.mark.parametrize("shards", [1, 2])
    def test_promotes_onto_the_mesh_bit_identical(self, shards):
        fleet = TenantFleetIndex(device="cpu", compact_every=32,
                                 shards=shards, whale_threshold=150)
        single = ExactAucIndex(device="cpu", compact_every=32)
        small = ExactAucIndex(device="cpu", compact_every=32)
        s, l = _stream(400, seed=3)
        ss, sl = _stream(60, seed=4)
        for i in range(0, 400, 37):
            fleet.apply_inserts([("w", s[i:i + 37], l[i:i + 37])])
            single.insert_batch(s[i:i + 37], l[i:i + 37])
        fleet.apply_inserts([("small", ss, sl)])
        small.insert_batch(ss, sl)
        assert fleet.is_whale("w") and not fleet.is_whale("small")
        whale = fleet._by_tid["w"].idx
        assert whale.shards == shards and whale._mesh is fleet._mesh
        assert fleet.wins2("w") == single._wins2
        assert fleet.auc("w") == single.auc()
        assert fleet.wins2("small") == small._wins2
        q = np.linspace(-1, 1, 7)
        ranks = fleet.apply_scores([("w", q), ("small", q)])
        np.testing.assert_array_equal(ranks[0], single.score_batch(q))
        np.testing.assert_array_equal(ranks[1], small.score_batch(q))

    @pytest.mark.parametrize("shards", [2, 4])
    def test_randomized_promote_demote_soak(self, shards):
        rng = np.random.default_rng(7 + shards)
        fleet = TenantFleetIndex(device="cpu", window=160, compact_every=24,
                                 shards=shards, whale_threshold=120)
        singles = {}
        tids = [f"t{k}" for k in range(5)]
        weights = np.asarray([8.0, 3.0, 1.0, 1.0, 1.0])
        weights /= weights.sum()
        for _ in range(40):
            items = []
            for tid in tids:
                if rng.random() > weights[int(tid[1])] * 3:
                    continue
                k = int(rng.integers(1, 30))
                labels = rng.random(k) < 0.5
                scores = (rng.standard_normal(k) + 0.8 * labels).astype(
                    np.float32)
                items.append((tid, scores, labels))
                singles.setdefault(tid, ExactAucIndex(
                    window=160, compact_every=24, device="cpu")
                ).insert_batch(scores, labels)
            if items:
                fleet.apply_inserts(items)
            flip = tids[int(rng.integers(len(tids)))]
            if rng.random() < 0.2:
                if fleet.is_whale(flip):
                    fleet.demote(flip)
                else:
                    fleet.promote(flip)
        for tid, ref in singles.items():
            assert fleet.wins2(tid) == ref._wins2, (shards, tid)
            assert fleet.auc(tid) == ref.auc(), (shards, tid)

    def test_chaos_mid_promotion_aborts_cleanly_then_retries(self):
        """A fault during the promotion's placement that outlasts the
        whale's retries aborts the promotion with the pack state
        untouched; the next promotion succeeds."""
        fleet = TenantFleetIndex(device="cpu", compact_every=32, shards=2,
                                 whale_threshold=10_000,
                                 retry_backoff_s=0.0)
        single = ExactAucIndex(device="cpu", compact_every=32)
        s, l = _stream(200, seed=8)
        fleet.apply_inserts([("w", s, l)])
        single.insert_batch(s, l)
        fleet.chaos = FaultInjector.from_spec({"faults": [
            {"point": "place_base", "on_call": k, "action": "error"}
            for k in range(1, 5)]})
        assert fleet.promote("w") is False
        assert _v(fleet.metrics.snapshot(), "fleet_whale_promote_aborts") == 1
        assert not fleet.is_whale("w")
        assert fleet.wins2("w") == single._wins2
        assert fleet.promote("w") is True
        s2, l2 = _stream(50, seed=9)
        fleet.apply_inserts([("w", s2, l2)])
        single.insert_batch(s2, l2)
        assert fleet.wins2("w") == single._wins2

    def test_device_loss_after_promotion_heals_bit_identical(self):
        chaos = FaultInjector.from_spec({"faults": [
            {"point": "sharded_count", "on_call": 2, "action": "error",
             "dropped": [1]}]})
        fleet = TenantFleetIndex(device="cpu", compact_every=32, shards=2,
                                 whale_threshold=100, chaos=chaos,
                                 retry_backoff_s=0.0)
        single = ExactAucIndex(device="cpu", compact_every=32)
        s, l = _stream(150, seed=10)
        fleet.apply_inserts([("w", s, l)])
        single.insert_batch(s, l)
        assert fleet.is_whale("w")
        s2, l2 = _stream(80, seed=11)
        fleet.apply_inserts([("w", s2, l2)])
        single.insert_batch(s2, l2)
        assert chaos.snapshot()["fired"].get("sharded_count") == 1
        assert fleet.wins2("w") == single._wins2
        assert fleet.auc("w") == single.auc()
        assert _v(fleet.metrics.snapshot(), "reshard_events") >= 1
        assert fleet._by_tid["w"].idx.shards == 1


class TestFleetKernel:
    def test_parity_with_promotion_demotion_and_drop(self):
        rng = np.random.default_rng(31)
        fleet = TenantFleetIndex(device="cpu", window=150, compact_every=24,
                                 shards=2, whale_threshold=100,
                                 count_kernel=True)
        singles = {}

        def push(tid, k):
            labels = rng.random(k) < 0.5
            scores = (rng.standard_normal(k) + 0.8 * labels).astype(
                np.float32)
            if tid not in singles:
                singles[tid] = ExactAucIndex(window=150, compact_every=24,
                                             device="cpu")
            singles[tid].insert_batch(scores, labels)
            return (tid, scores, labels)

        for step in range(16):
            items = [push("whale", 30)]
            items += [push(f"s{k}", 6) for k in range(4)]
            fleet.apply_inserts(items)
            if step == 8:
                fleet.drop("s0")
                singles.pop("s0")
            for tid, idx in singles.items():
                assert fleet.wins2(tid) == idx._wins2, (step, tid)
        assert fleet.is_whale("whale")
        fleet.demote("whale")
        fleet.apply_inserts([push("whale", 10)])
        assert fleet.wins2("whale") == singles["whale"]._wins2
        snap = fleet.metrics.snapshot()
        assert snap["count_kernel_calls_total"]["value"] > 0
        assert snap["count_kernel_fallbacks_total"]["value"] == 0
        assert snap["fleet_whale_promotions"]["value"] >= 1

    @pytest.mark.parametrize("T", [1, 32, 256])
    def test_parity_across_fleet_sizes(self, T):
        rng = np.random.default_rng(59 + T)
        plain = TenantFleetIndex(device="cpu", compact_every=64, shards=2)
        ker = TenantFleetIndex(device="cpu", compact_every=64, shards=2,
                               count_kernel=True)
        ref = JaxFleet(compact_every=64, shards=2)
        for _ in range(3):
            items = []
            for t in range(T):
                labels = rng.random(3) < 0.5
                s = (rng.standard_normal(3) + 0.8 * labels).astype(
                    np.float32)
                items.append((f"t{t}", s, labels))
            for f in (plain, ker, ref):
                f.apply_inserts(list(items))
        want = {t: ref.wins2(t) for t in ref.tenants()}
        assert {t: plain.wins2(t) for t in plain.tenants()} == want
        assert {t: ker.wins2(t) for t in ker.tenants()} == want
        snap = ker.metrics.snapshot()
        assert snap["count_kernel_calls_total"]["value"] == 3
        assert snap["count_kernel_fallbacks_total"]["value"] == 0
        _same_packs(ker, ref)


class TestMeshResize:
    def test_resize_parity_grow_and_shrink(self):
        fleet = TenantFleetIndex(device="cpu", shards=2, compact_every=32)
        ref = JaxFleet(shards=2, compact_every=32)
        singles = {}
        rng = np.random.default_rng(5)

        def feed(k):
            items = []
            for t in range(6):
                s = rng.standard_normal(k).astype(np.float32)
                l = rng.random(k) < 0.5
                tid = f"t{t}"
                items.append((tid, s, l))
                singles.setdefault(tid, ExactAucIndex(
                    compact_every=32, device="cpu")).insert_batch(s, l)
            fleet.apply_inserts(items)
            ref.apply_inserts(items)

        feed(60)
        assert fleet.resize_shards(4) and ref.resize_shards(4)
        assert fleet.shards == 4
        feed(60)
        assert fleet.resize_shards(8) and ref.resize_shards(8)
        feed(30)
        assert fleet.resize_shards(1) and ref.resize_shards(1)
        feed(60)
        assert not fleet.resize_shards(1)      # no-op width
        assert not fleet.resize_shards(1024)   # beyond the pool
        for tid, idx in singles.items():
            assert fleet.wins2(tid) == idx._wins2 == ref.wins2(tid)
            assert fleet.auc(tid) == idx.auc()
        m = fleet.metrics.snapshot()
        assert m["mesh_width"]["value"] == 1
        assert m["reshard_events"]["value"] == 3
        _same_packs(fleet, ref)

    def test_unsharded_fleet_refuses(self):
        assert not TenantFleetIndex(device="cpu").resize_shards(2)


class TestFleetEngineOnTheMesh:
    @pytest.mark.parametrize("count_kernel", [False, True])
    def test_replay_fleet_with_chaos_on_the_mesh(self, count_kernel):
        """MultiTenantEngine(mesh_shards=4) under a chaos schedule (a
        batcher crash, a compactor crash, a lost worker, poison): every
        tenant's AUC equals its oracle over the admitted events, and the
        fault-free mesh replay over them."""
        s, l, t = make_tenant_stream(2400, 16, seed=5)
        spec = {"faults": [
            {"point": "batcher", "on_call": 3, "action": "error"},
            {"point": "compactor_build", "on_call": 1, "action": "error"},
            {"point": "sharded_count", "on_call": 4, "action": "error",
             "dropped": [2]},
            {"point": "poison", "at_events": [10, 500], "value": "nan"}]}
        cfg = ServingConfig(device="cpu", policy="block", mesh_shards=4,
                            compact_every=32, count_kernel=count_kernel,
                            bg_compact=True)
        rec = replay_fleet(s, l, t, config=cfg, chaos=spec,
                           max_inflight=64)
        f = rec["faults"]
        assert f["chaos"]["fired"] == {"batcher": 1, "compactor_build": 1,
                                       "sharded_count": 1}
        assert f["batcher_restarts"] >= 1 and f["reshard_events"] >= 1
        assert rec["events_poison_rejected"] == 2
        assert rec["tenant_auc_max_abs_err"] == 0.0
        assert rec["fleet"]["shards"] == 3
        keep = np.ones(len(s), dtype=bool)
        keep[[10, 500]] = False
        clean = replay_fleet(s[keep], l[keep], t[keep], config=cfg,
                             max_inflight=64)
        assert clean["tenant_auc_max_abs_err"] == 0.0
        assert clean["events_applied"] == rec["events_applied"]
