"""The port's TenantFleetIndex against the JAX package's
(``TenantFleetIndex(shards=None)``) on the same events: per-tenant wins2
after every apply, AUC and ``apply_scores`` ranks equal bit for bit, with
and without a window, with the count kernel (its plain version on the
CPU; the JAX side in Pallas interpret mode) and without, through drops
and slot reuse, whale promotion and demotion, and background
compaction; one fleet count per apply; the dirty-row placement
accounting. Mirrors tests/test_tenancy.py and
tests/test_fleet_incremental.py of the JAX package."""

import numpy as np
import pytest
import torch

from tuplewise_tpu.serving.tenancy import TenantFleetIndex as JaxFleet
from tuplewise_tpu_torch.obs.flight import FlightRecorder
from tuplewise_tpu_torch.obs.tracing import Tracer
from tuplewise_tpu_torch.serving.index import ExactAucIndex
from tuplewise_tpu_torch.serving.tenancy import TenantFleetIndex


def _fleet(**kw):
    return TenantFleetIndex(device="cpu", **kw)


def _stream(n, seed=0, sep=0.8):
    rng = np.random.default_rng(seed)
    labels = rng.random(n) < 0.5
    scores = rng.standard_normal(n) + sep * labels
    return scores, labels


def _tenant_streams(n_tenants, n_events, seed=0):
    return {f"t{k}": _stream(n_events, seed=seed * 1000 + k)
            for k in range(n_tenants)}


def _batches(streams, seed=1, max_k=40):
    """Random coalesced multi-tenant batches over per-tenant streams."""
    n = len(next(iter(streams.values()))[0])
    pos = {t: 0 for t in streams}
    rng = np.random.default_rng(seed)
    while any(pos[t] < n for t in streams):
        items = []
        for t in streams:
            if pos[t] >= n or rng.random() > 0.7:
                continue
            k = int(rng.integers(1, max_k))
            s, lab = streams[t]
            items.append((t, s[pos[t]:pos[t] + k], lab[pos[t]:pos[t] + k]))
            pos[t] += k
        if items:
            yield items


def _drive(fleets, streams, **kw):
    """Feed the same batches to every fleet; after each apply the
    touched tenants' wins2 must be equal."""
    applies = 0
    for items in _batches(streams, **kw):
        for f in fleets:
            f.apply_inserts(items)
        applies += 1
        for t, _, _ in items:
            assert len({f.wins2(t) for f in fleets}) == 1, t
    return applies


def _v(fleet, name):
    return fleet.metrics.snapshot().get(name, {}).get("value", 0)


class TestFleetParity:
    @pytest.mark.parametrize("count_kernel", [True, False])
    @pytest.mark.parametrize("window", [None, 100])
    @pytest.mark.parametrize("n_tenants", [1, 8, 37])
    def test_wins2_and_scores_equal_jax(self, n_tenants, window,
                                        count_kernel):
        streams = _tenant_streams(n_tenants, 120, seed=n_tenants)
        kw = dict(window=window, compact_every=32, count_kernel=count_kernel)
        jax_fleet = JaxFleet(**kw)
        fleet = _fleet(**kw)
        _drive([jax_fleet, fleet], streams)
        q = np.random.default_rng(4).standard_normal(13)
        items = [(t, q) for t in streams]
        for got, want in zip(fleet.apply_scores(items),
                             jax_fleet.apply_scores(items)):
            np.testing.assert_array_equal(got, want)
        for t in streams:
            assert fleet.auc(t) == jax_fleet.auc(t)
            assert fleet.tenant_state(t) == jax_fleet.tenant_state(t)
        assert fleet.state()["t_bucket"] == jax_fleet.state()["t_bucket"]

    def test_equals_dedicated_single_tenant_indexes(self):
        streams = _tenant_streams(5, 300, seed=2)
        fleet = _fleet(window=100, compact_every=64)
        singles = {t: ExactAucIndex(window=100, compact_every=64,
                                    device="cpu") for t in streams}
        for items in _batches(streams):
            fleet.apply_inserts(items)
            for t, s, lab in items:
                singles[t].insert_batch(s, lab)
        for t in streams:
            assert fleet.wins2(t) == singles[t]._wins2
            assert fleet.auc(t) == singles[t].auc()

    def test_oracle_values_roundtrip(self):
        streams = _tenant_streams(2, 150, seed=5)
        fleet = _fleet(window=80, compact_every=16)
        singles = {t: ExactAucIndex(window=80, compact_every=16,
                                    device="cpu") for t in streams}
        for items in _batches(streams):
            fleet.apply_inserts(items)
            for t, s, lab in items:
                singles[t].insert_batch(s, lab)
        for t in streams:
            fp, fn = fleet.oracle_values(t)
            sp, sn = singles[t].oracle_values()
            np.testing.assert_array_equal(np.sort(fp), np.sort(sp))
            np.testing.assert_array_equal(np.sort(fn), np.sort(sn))

    def test_rejects_duplicates_and_bad_scores(self):
        fleet = _fleet()
        with pytest.raises(ValueError, match="duplicate tenant"):
            fleet.apply_inserts([("a", [1.0], [1]), ("a", [2.0], [0])])
        with pytest.raises(ValueError, match="finite"):
            fleet.insert_batch("b", [np.nan], [1])
        with pytest.raises(ValueError, match="length mismatch"):
            fleet.insert_batch("b", [1.0, 2.0], [1])


class TestOneCountCall:
    @pytest.mark.parametrize("count_kernel", [True, False])
    def test_one_call_per_apply(self, count_kernel):
        streams = _tenant_streams(6, 120, seed=7)
        fleet = _fleet(compact_every=1024, count_kernel=count_kernel)
        n_applies = 0
        for pos in range(0, 120, 30):
            fleet.apply_inserts([(t, s[pos:pos + 30], lab[pos:pos + 30])
                                 for t, (s, lab) in streams.items()])
            n_applies += 1
        assert fleet.state()["count_calls"] == n_applies
        assert _v(fleet, "fleet_count_calls_total") == n_applies
        assert _v(fleet, "fleet_count_tenant_queries_total") == n_applies * 6
        assert _v(fleet, "count_kernel_calls_total") == (
            n_applies if count_kernel else 0)
        assert _v(fleet, "count_kernel_fallbacks_total") == 0

    def test_calls_independent_of_tenant_count(self):
        calls = {}
        for T in (2, 6):
            streams = _tenant_streams(T, 90, seed=8)
            fleet = _fleet(compact_every=1024)
            for pos in range(0, 90, 30):
                fleet.apply_inserts(
                    [(t, s[pos:pos + 30], lab[pos:pos + 30])
                     for t, (s, lab) in streams.items()])
            calls[T] = fleet.state()["count_calls"]
        assert calls[2] == calls[6] == 3


class TestLifecycle:
    def test_drop_and_slot_reuse_equal_jax(self):
        streams = _tenant_streams(3, 60, seed=13)
        jax_fleet, fleet = JaxFleet(compact_every=8), _fleet(compact_every=8)
        _drive([jax_fleet, fleet], streams)
        assert fleet.drop("t1") and jax_fleet.drop("t1")
        assert not fleet.has("t1") and not fleet.drop("t1")
        s, lab = _stream(80, seed=14)
        for f in (jax_fleet, fleet):
            f.apply_inserts([("newbie", s, lab)])
        assert fleet.wins2("newbie") == jax_fleet.wins2("newbie")
        ref = ExactAucIndex(compact_every=8, device="cpu")
        ref.insert_batch(s, lab)
        assert fleet.wins2("newbie") == ref._wins2
        assert fleet.auc("newbie") == ref.auc()
        assert sorted(fleet.tenants()) == sorted(jax_fleet.tenants())

    def test_flight_events(self):
        fr = FlightRecorder(capacity=64)
        fleet = _fleet(flight=fr)
        fleet.create("a")
        fleet.drop("a")
        counts = fr.counts()
        assert counts.get("tenant_created") == 1
        assert counts.get("tenant_evicted") == 1

    def test_idle_tenants(self):
        fleet = _fleet()
        fleet.create("a")
        assert fleet.idle_tenants(1e9) == []
        assert fleet.idle_tenants(-1.0) == ["a"]

    def test_unported_options_raise(self):
        # shards, mesh, chaos and the tracer are ported
        with pytest.raises(TypeError, match="Tracer"):
            _fleet(tracer=object())
        tr = Tracer()
        fleet = _fleet(tracer=tr, compact_every=4)
        s, lab = _stream(16)
        fleet.apply_inserts([("a", s[:8], lab[:8]), ("b", s[8:], lab[8:])])
        assert {"fleet.count", "fleet.compact"} <= {
            x["name"] for x in tr.spans()}
        with pytest.raises(ValueError, match="shards must be"):
            _fleet(shards=0)
        assert _fleet(shards=2).state()["shards"] == 2


class TestDirtyRowPlacement:
    def test_geometry_stable_reuse_saves_bytes(self):
        streams = {f"t{k}": _stream(200, seed=k) for k in range(6)}
        jax_fleet, fleet = JaxFleet(compact_every=32), _fleet(compact_every=32)
        for tid, (s, lab) in streams.items():
            for i in range(0, 200, 40):
                for f in (jax_fleet, fleet):
                    f.apply_inserts([(tid, s[i:i + 40], lab[i:i + 40])])
                assert fleet.wins2(tid) == jax_fleet.wins2(tid)
        assert _v(fleet, "bytes_h2d_saved") > 0
        for name in ("pack_replaces_total", "pack_full_replaces_total"):
            assert _v(fleet, name) == _v(jax_fleet, name), name
        assert (_v(fleet, "pack_replaces_total")
                > _v(fleet, "pack_full_replaces_total"))

    def test_one_dirty_tenant_of_256_ships_one_row(self):
        fleet = _fleet(compact_every=8)
        fleet.apply_inserts([(f"t{k}", *_stream(4, seed=k))
                             for k in range(256)])
        fleet.apply_inserts([("t0", *_stream(2, seed=999))])
        base_bytes = _v(fleet, "bytes_h2d")
        base_saved = _v(fleet, "bytes_h2d_saved")
        cap = fleet.state()["pack_caps"]["pos"]
        # dirty exactly one tenant (a compaction), then place through the
        # next count
        fleet.apply_inserts([("t7", *_stream(16, seed=500))])
        fleet.apply_scores([("t0", np.zeros(2))])
        shipped = _v(fleet, "bytes_h2d") - base_bytes
        saved = _v(fleet, "bytes_h2d_saved") - base_saved
        # one row a pack, and the rest of both packs saved
        assert shipped == 2 * cap * 4
        assert saved == 2 * 255 * cap * 4

    def test_t_bucket_growth_forces_full_ship(self):
        fleet = _fleet(compact_every=4, min_tenant_bucket=4)
        for k in range(4):
            fleet.apply_inserts([(f"t{k}", *_stream(8, seed=k))])
        full_before = _v(fleet, "pack_full_replaces_total")
        fleet.apply_inserts([("t4", *_stream(8, seed=9))])
        assert _v(fleet, "pack_full_replaces_total") > full_before
        assert fleet.state()["t_bucket"] == 8

    def test_incremental_off_restores_full_pack_path(self):
        fleet = _fleet(compact_every=16, incremental_placement=False)
        for k in range(3):
            s, lab = _stream(120, seed=k)
            for i in range(0, 120, 30):
                fleet.apply_inserts([(f"t{k}", s[i:i + 30], lab[i:i + 30])])
        assert (_v(fleet, "pack_replaces_total")
                == _v(fleet, "pack_full_replaces_total"))
        assert _v(fleet, "bytes_h2d_saved") == 0


class TestWhalePromotion:
    def test_promotes_and_stays_equal_to_jax(self):
        kw = dict(compact_every=32, whale_threshold=150)
        jax_fleet, fleet = JaxFleet(**kw), _fleet(**kw)
        s, lab = _stream(400, seed=3)
        ss, sl = _stream(60, seed=4)
        for i in range(0, 400, 37):
            for f in (jax_fleet, fleet):
                f.apply_inserts([("w", s[i:i + 37], lab[i:i + 37])])
            assert fleet.wins2("w") == jax_fleet.wins2("w")
        for f in (jax_fleet, fleet):
            f.apply_inserts([("small", ss, sl)])
        assert fleet.is_whale("w") and not fleet.is_whale("small")
        assert _v(fleet, "fleet_whale_promotions") == 1
        for t in ("w", "small"):
            assert fleet.wins2(t) == jax_fleet.wins2(t)
            assert fleet.auc(t) == jax_fleet.auc(t)
        q = np.linspace(-1, 1, 7)
        items = [("w", q), ("small", q)]
        for got, want in zip(fleet.apply_scores(items),
                             jax_fleet.apply_scores(items)):
            np.testing.assert_array_equal(got, want)
        assert fleet.tenant_state("w")["promoted"] is True
        assert fleet.state()["whales"] == 1

    def test_demotes_on_shrink(self):
        kw = dict(compact_every=16, whale_threshold=100)
        jax_fleet, fleet = JaxFleet(**kw), _fleet(**kw)
        s, lab = _stream(30, seed=5)
        for f in (jax_fleet, fleet):
            f.apply_inserts([("t", s, lab)])
            assert f.promote("t") and f.is_whale("t")
        s2, l2 = _stream(10, seed=6)
        for f in (jax_fleet, fleet):
            f.apply_inserts([("t", s2, l2)])    # 40 < 50: demote
        assert not fleet.is_whale("t")
        assert _v(fleet, "fleet_whale_demotions") == 1
        assert fleet.wins2("t") == jax_fleet.wins2("t")
        assert fleet.auc("t") == jax_fleet.auc("t")
        assert not fleet.demote("t") and not fleet.promote("absent")

    @pytest.mark.parametrize("count_kernel", [True, False])
    def test_randomized_promote_demote_soak(self, count_kernel):
        rng = np.random.default_rng(7)
        kw = dict(window=160, compact_every=24, whale_threshold=120,
                  count_kernel=count_kernel)
        jax_fleet, fleet = JaxFleet(**kw), _fleet(**kw)
        tids = [f"t{k}" for k in range(5)]
        weights = np.asarray([8.0, 3.0, 1.0, 1.0, 1.0])
        weights /= weights.sum()
        seen = set()
        for _ in range(40):
            items = []
            for tid in tids:
                if rng.random() > weights[int(tid[1])] * 3:
                    continue
                k = int(rng.integers(1, 30))
                labels = rng.random(k) < 0.5
                items.append((tid, rng.standard_normal(k) + 0.8 * labels,
                              labels))
                seen.add(tid)
            if items:
                for f in (jax_fleet, fleet):
                    f.apply_inserts(items)
            flip = tids[int(rng.integers(len(tids)))]
            if rng.random() < 0.2:
                for f in (jax_fleet, fleet):
                    f.demote(flip) if f.is_whale(flip) else f.promote(flip)
            if rng.random() < 0.3:
                q = rng.standard_normal(5)
                live = [(t, q) for t in tids if t in seen]
                for got, want in zip(fleet.apply_scores(live),
                                     jax_fleet.apply_scores(live)):
                    np.testing.assert_array_equal(got, want)
            for t in seen:
                assert fleet.wins2(t) == jax_fleet.wins2(t), t
                assert fleet.is_whale(t) == jax_fleet.is_whale(t), t

    def test_whale_counts_through_its_own_index(self):
        fleet = _fleet(compact_every=16, whale_threshold=40,
                       count_kernel=True)
        s, lab = _stream(200, seed=11)
        for i in range(0, 200, 20):
            fleet.apply_inserts([("w", s[i:i + 20], lab[i:i + 20])])
        assert fleet.is_whale("w")
        idx = fleet._by_tid["w"].idx
        assert isinstance(idx, ExactAucIndex) and idx.count_kernel
        assert idx.metrics is fleet.metrics


class TestOffBatcherBuilds:
    def test_bg_parity(self):
        jax_fleet = JaxFleet(compact_every=16, bg_compact=True)
        fleet = _fleet(compact_every=16, bg_compact=True)
        streams = _tenant_streams(3, 250, seed=12)
        _drive([jax_fleet, fleet], streams, max_k=25)
        fleet.wait_idle()
        jax_fleet.wait_idle()
        for t in streams:
            assert fleet.wins2(t) == jax_fleet.wins2(t)
            assert fleet.auc(t) == jax_fleet.auc(t)
        assert _v(fleet, "compactions_total") > 0
        fleet.close()
        jax_fleet.close()

    def test_bg_windowed_eviction_parity(self):
        jax_fleet = JaxFleet(window=60, compact_every=8, bg_compact=True)
        fleet = _fleet(window=60, compact_every=8, bg_compact=True)
        s, lab = _stream(300, seed=13)
        for i in range(0, 300, 11):
            for f in (jax_fleet, fleet):
                f.apply_inserts([("t", s[i:i + 11], lab[i:i + 11])])
            assert fleet.wins2("t") == jax_fleet.wins2("t")
        fleet.wait_idle()
        assert fleet.auc("t") == jax_fleet.auc("t")
        fleet.close()
        jax_fleet.close()

    def test_bg_crash_aborts_cleanly_and_recovers(self, monkeypatch):
        fleet = _fleet(compact_every=8, bg_compact=True)
        ref = ExactAucIndex(compact_every=8, device="cpu")
        merged = fleet._merged
        crashed = []

        def crash_once(*a):
            if not crashed:
                crashed.append(True)
                raise RuntimeError("injected build crash")
            return merged(*a)

        monkeypatch.setattr(fleet, "_merged", crash_once)
        s, lab = _stream(130, seed=14)
        for i in range(0, 120, 10):
            fleet.apply_inserts([("t", s[i:i + 10], lab[i:i + 10])])
            ref.insert_batch(s[i:i + 10], lab[i:i + 10])
        fleet.wait_idle()
        # The crashed build may have run only after the last apply (the
        # compactor thread's timing on a loaded machine); it rolled its
        # claim back, so the next trigger compacts what it had claimed.
        fleet.apply_inserts([("t", s[120:], lab[120:])])
        ref.insert_batch(s[120:], lab[120:])
        fleet.wait_idle()
        assert _v(fleet, "fleet_compact_aborts") == 1
        assert "injected build crash" in fleet.state()["last_compactor_error"]
        assert fleet.wins2("t") == ref._wins2
        assert _v(fleet, "compactions_total") >= 1
        fleet.close()


class TestStaleRowReclaim:
    def test_drop_marks_row_stale_then_reclaims(self):
        fleet = _fleet(compact_every=8)
        for k in range(3):
            fleet.apply_inserts([(f"t{k}", *_stream(24, seed=k))])
        assert _v(fleet, "pack_occupancy") > 0
        assert fleet.drop("t1")
        assert _v(fleet, "pack_stale_rows") >= 1
        fleet.apply_scores([("t0", np.zeros(3))])
        assert _v(fleet, "pack_stale_rows") == 0
        s, lab = _stream(30, seed=9)
        fleet.apply_inserts([("fresh", s, lab)])
        ref = ExactAucIndex(compact_every=8, device="cpu")
        ref.insert_batch(s, lab)
        assert fleet.wins2("fresh") == ref._wins2

    def test_packs_stay_on_the_fleet_device(self):
        fleet = _fleet(compact_every=8)
        fleet.apply_inserts([("a", *_stream(20, seed=1))])
        assert fleet._pos_pack.dev.device == torch.device("cpu")
        assert fleet._pos_pack.dev.dtype == torch.float32
