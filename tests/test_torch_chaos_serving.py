"""Serving fault tolerance of the port's mesh form, case for case with
tests/test_chaos_serving.py (TestShardDeath, TestCompactorCrash, the
chaos cases of TestEngineHardening, TestChaosParity) and the heal cases
of tests/test_pallas_counts.py: under a scheduled fault (a lost worker, a
compactor or batcher crash, poison events) the port completes and wins2
and every AUC equal a fault-free run over the admitted events, and the
JAX index under the same schedule.

The JAX package falls back from its Pallas kernel to XLA (a forced
failure, ``TUPLEWISE_SERVING_PALLAS``); the port does not: its inversions
of tests/test_pallas_counts.py's fallback cases pin that a failing kernel
route raises, counts no fallback, and that no environment switch turns
the kernel on or off."""

import numpy as np
import pytest

from tuplewise_tpu.serving import ExactAucIndex as JaxIndex
from tuplewise_tpu.serving import ServingConfig as JaxConfig
from tuplewise_tpu.serving import replay as jax_replay
from tuplewise_tpu.serving.replay import make_stream
from tuplewise_tpu.testing.chaos import FaultInjector as JaxInjector
from tuplewise_tpu_torch.parallel import sharded_counts as sc
from tuplewise_tpu_torch.parallel.self_heal import HealExhaustedError
from tuplewise_tpu_torch.serving import (
    EngineClosedError, ExactAucIndex, MicroBatchEngine, ServingConfig,
    TenantFleetIndex, replay,
)
from tuplewise_tpu_torch.testing import FaultInjector, InjectedFault


def _stream(n, seed=7):
    return make_stream(n, pos_frac=0.45, separation=1.0, seed=seed)


class TestShardDeath:
    @pytest.mark.parametrize("count_kernel", [False, True])
    def test_self_heal_preserves_exactness(self, count_kernel):
        """A worker lost mid-count: probe, shrink over the survivor,
        re-place, retry; wins2 stays equal to the unfaulted index."""
        scores, labels = _stream(1200, seed=11)
        spec = {"faults": [{"point": "sharded_count", "on_call": 7,
                            "action": "error", "dropped": [1]}]}
        hurt = ExactAucIndex(device="cpu", compact_every=64, shards=2,
                             chaos=FaultInjector.from_spec(spec),
                             count_kernel=count_kernel)
        plain = ExactAucIndex(device="cpu", compact_every=64)
        ref = JaxIndex(engine="jax", compact_every=64, shards=2,
                       chaos=JaxInjector.from_spec(spec))
        for i in range(0, 1200, 41):
            j = min(i + 41, 1200)
            for x in (hurt, plain, ref):
                x.insert_batch(scores[i:j], labels[i:j])
            assert hurt._wins2 == plain._wins2 == ref._wins2, i
        assert hurt.auc() == plain.auc() == ref.auc()
        assert hurt.shards == 1 == ref.shards
        m = hurt.metrics.snapshot()
        assert m["reshard_events"]["value"] == 1
        assert m["shard_retries_total"]["value"] == 1
        assert m["recovery_time_s"]["count"] == 1
        assert m["mesh_width"]["value"] == 1
        assert m["count_kernel_fallbacks_total"]["value"] == 0
        hurt.close()

    def test_retry_bound_surfaces_persistent_failure(self):
        scores, labels = _stream(100, seed=1)
        faults = [{"point": "sharded_count", "on_call": k,
                   "action": "error"} for k in range(1, 10)]
        idx = ExactAucIndex(device="cpu", compact_every=8, shards=2,
                            chaos=FaultInjector.from_spec(
                                {"faults": faults}),
                            shard_retries=2, retry_backoff_s=0.001)
        with pytest.raises(InjectedFault):
            idx.insert_batch(scores[:32], labels[:32])
        idx.close()

    def test_fixed_width_without_a_spare_exhausts(self):
        """The fixed-width policy (the batch path) on a mesh of 8 with no
        spare slot cannot replace a lost worker."""
        from tuplewise_tpu_torch.parallel.mesh import make_mesh
        from tuplewise_tpu_torch.parallel.self_heal import MeshHealer

        inj = FaultInjector.from_spec({"faults": [
            {"point": "sharded_count", "on_call": 1, "action": "error",
             "dropped": [3]}]})
        h = MeshHealer(make_mesh(8, "cpu"), fixed_width=8, chaos=inj)
        with pytest.raises(HealExhaustedError, match="sustain"):
            h.run(lambda: inj.fire("sharded_count"))

    def test_every_worker_lost_exhausts_and_counts(self):
        scores, labels = _stream(200, seed=2)
        inj = FaultInjector.from_spec({"faults": [
            {"point": "sharded_count", "on_call": 1, "action": "error",
             "dropped": [0, 1]}]})
        idx = ExactAucIndex(device="cpu", compact_every=16, shards=2,
                            chaos=inj, retry_backoff_s=0.0)
        before = idx._wins2
        with pytest.raises(HealExhaustedError):
            idx.insert_batch(scores[:40], labels[:40])
        assert idx._wins2 == before      # the count failed first
        assert idx.metrics.snapshot()["heal_exhausted_total"]["value"] == 1

    def test_place_base_fault_heals(self):
        """A placement fault of a compaction heals and retries, as a
        count's does."""
        scores, labels = _stream(900, seed=4)
        inj = FaultInjector.from_spec({"faults": [
            {"point": "place_base", "on_call": 2, "action": "error"}]})
        idx = ExactAucIndex(device="cpu", compact_every=48, shards=4,
                            window=400, chaos=inj, retry_backoff_s=0.0)
        plain = ExactAucIndex(device="cpu", compact_every=48, window=400)
        for i in range(0, 900, 53):
            idx.insert_batch(scores[i:i + 53], labels[i:i + 53])
            plain.insert_batch(scores[i:i + 53], labels[i:i + 53])
            assert idx._wins2 == plain._wins2, i
        assert inj.snapshot()["fired"] == {"place_base": 1}
        assert idx.metrics.snapshot()["shard_retries_total"]["value"] == 1
        assert idx.shards == 4


class TestCompactorCrash:
    @pytest.mark.parametrize("shards", [None, 2])
    def test_watchdog_restarts_and_statistic_survives(self, shards):
        scores, labels = _stream(2000, seed=3)
        inj = FaultInjector.from_spec({"faults": [
            {"point": "compactor_build", "on_call": 1,
             "action": "error"}]})
        kw = dict(engine="numpy") if shards is None else dict(
            device="cpu", shards=shards)
        hurt = ExactAucIndex(compact_every=32, bg_compact=True, chaos=inj,
                             **kw)
        sync = ExactAucIndex(engine="numpy", compact_every=32)
        for i in range(0, 2000, 37):
            j = min(i + 37, 2000)
            hurt.insert_batch(scores[i:j], labels[i:j])
            sync.insert_batch(scores[i:j], labels[i:j])
            assert hurt._wins2 == sync._wins2, i
        hurt.compact()      # must not hang on the crashed build
        assert hurt.auc() == sync.auc()
        m = hurt.metrics.snapshot()
        assert m["bg_compactor_restarts"]["value"] >= 1
        assert hurt.n_compactions > 0
        assert "InjectedFault" in hurt.state()["last_compactor_error"]
        hurt.close()

    def test_wait_idle_survives_crashed_build(self):
        scores, labels = _stream(400, seed=9)
        inj = FaultInjector.from_spec({"faults": [
            {"point": "compactor_build", "on_call": 1,
             "action": "error"}]})
        idx = ExactAucIndex(device="cpu", shards=2, compact_every=32,
                            bg_compact=True, chaos=inj)
        idx.insert_batch(scores, labels)
        idx.wait_idle(timeout=10.0)
        idx.close()


class TestEngineHardening:
    def test_batcher_supervisor_restarts(self):
        inj = FaultInjector.from_spec({"faults": [
            {"point": "batcher", "on_call": 2, "action": "error"}]})
        with MicroBatchEngine(ServingConfig(engine="numpy", device="cpu",
                                            policy="block"),
                              chaos=inj) as eng:
            for i in range(10):
                eng.insert([float(i)], [i % 2]).result(10)
            snap = eng.flush()
        assert snap["metrics"]["batcher_restarts"]["value"] >= 1
        assert snap["index"]["n_events"] == 10
        assert eng.flight.counts().get("chaos_inject", 0) >= 1

    def test_submit_after_close_is_typed(self):
        eng = MicroBatchEngine(ServingConfig(engine="numpy", device="cpu"))
        eng.close()
        with pytest.raises(EngineClosedError):
            eng.insert([1.0], [1])


class TestChaosParity:
    @pytest.mark.parametrize("count_kernel", [False, True])
    def test_combined_schedule_bit_identical(self, count_kernel):
        """A lost worker, a compactor crash and poison in one replay on a
        mesh of 2: every recovery counter fires and the final AUC equals
        the fault-free run over the admitted events, and the JAX replay
        under the same schedule."""
        n = 1200
        scores, labels = _stream(n, seed=21)
        # the port makes one count a micro-batch (the JAX index one a
        # side): the fault is scheduled inside the port's fewer calls
        spec = {"faults": [
            {"point": "sharded_count", "on_call": 5, "action": "error",
             "dropped": [1]},
            {"point": "compactor_build", "on_call": 1, "action": "error"},
            {"point": "poison", "at_events": [77, 500, 501],
             "value": "nan"},
        ]}
        cfg = ServingConfig(device="cpu", policy="block", mesh_shards=2,
                            bg_compact=True, compact_every=64,
                            count_kernel=count_kernel)
        rec = replay(scores, labels, config=cfg, chaos=spec,
                     max_inflight=64)
        f = rec["faults"]
        assert f["chaos"]["fired"] == {"sharded_count": 1,
                                       "compactor_build": 1}
        assert f["reshard_events"] > 0
        assert f["bg_compactor_restarts"] > 0
        assert f["poison_rejects"] == 3
        assert rec["shed_events"] == [77, 500, 501]
        assert rec["n_admitted"] == n - 3
        assert rec["auc_abs_err"] == 0.0
        admitted = np.ones(n, dtype=bool)
        admitted[rec["shed_events"]] = False
        ref = replay(scores[admitted], labels[admitted],
                     config=ServingConfig(device="cpu", policy="block",
                                          bg_compact=True,
                                          compact_every=64),
                     max_inflight=64)
        assert rec["auc_exact"] == ref["auc_exact"]
        jrec = jax_replay(scores, labels, config=JaxConfig(
            policy="block", mesh_shards=2, bg_compact=True,
            compact_every=64), chaos=spec, max_inflight=64)
        assert rec["auc_exact"] == jrec["auc_exact"]

    def test_randomized_schedule(self):
        """A seeded random schedule on a mesh of 2: whatever fires, the
        engine completes and parity holds on the admitted events."""
        n = 900
        scores, labels = _stream(n, seed=100)
        inj = FaultInjector.random(0, n)
        cfg = ServingConfig(device="cpu", policy="block", mesh_shards=2,
                            bg_compact=True, compact_every=64)
        rec = replay(scores, labels, config=cfg, chaos=inj, max_inflight=64)
        admitted = np.ones(n, dtype=bool)
        admitted[rec["shed_events"]] = False
        ref = replay(scores[admitted], labels[admitted],
                     config=ServingConfig(device="cpu", policy="block",
                                          compact_every=64),
                     max_inflight=64)
        assert rec["auc_exact"] == ref["auc_exact"]


# --------------------------------------------------------------------- #
# tests/test_pallas_counts.py: heals with the kernel on, and the         #
# port's inversions of the fallback cases                                #
# --------------------------------------------------------------------- #

def _kstream(n, seed=0, sep=0.8, dup_every=13):
    rng = np.random.default_rng(seed)
    labels = rng.random(n) < 0.5
    scores = (rng.standard_normal(n) + sep * labels).astype(np.float32)
    scores[::dup_every] = np.round(scores[::dup_every], 1)
    return scores, labels


class TestChaosHealWithKernel:
    def test_device_loss_heals_bit_identical(self):
        scores, labels = _kstream(700, seed=23)
        inj = FaultInjector.from_spec({"faults": [
            {"point": "sharded_count", "on_call": 7, "action": "error",
             "dropped": [1]}]})
        hurt = ExactAucIndex(device="cpu", compact_every=48, window=200,
                             shards=2, chaos=inj, count_kernel=True)
        plain = ExactAucIndex(device="cpu", compact_every=48, window=200)
        for i in range(0, 700, 41):
            j = min(i + 41, 700)
            hurt.insert_batch(scores[i:j], labels[i:j])
            plain.insert_batch(scores[i:j], labels[i:j])
            assert hurt._wins2 == plain._wins2, i
        snap = hurt.metrics.snapshot()
        assert snap["reshard_events"]["value"] >= 1
        assert hurt.shards == 1
        assert snap["count_kernel_calls_total"]["value"] > 0
        assert snap["count_kernel_fallbacks_total"]["value"] == 0
        # the tombstone mirror was re-placed on the healed mesh
        for side in (hurt._pos, hurt._neg):
            if side.tomb_dev is not None:
                assert side.tomb_dev.shape[0] == 1

    def test_fleet_device_loss_heals_bit_identical(self):
        scores, labels = _kstream(400, seed=29)
        inj = FaultInjector.from_spec({"faults": [
            {"point": "sharded_count", "on_call": 5, "action": "error",
             "dropped": [1]}]})
        hurt = TenantFleetIndex(device="cpu", compact_every=48, shards=2,
                                chaos=inj, count_kernel=True)
        ref = TenantFleetIndex(device="cpu", compact_every=48)
        for i in range(0, 400, 80):
            items = [("a", scores[i:i + 40], labels[i:i + 40]),
                     ("b", scores[i + 40:i + 80], labels[i + 40:i + 80])]
            hurt.apply_inserts(list(items))
            ref.apply_inserts(list(items))
        for t in ("a", "b"):
            assert hurt.wins2(t) == ref.wins2(t)
        assert hurt.metrics.snapshot()["reshard_events"]["value"] >= 1
        assert hurt.shards == 1


class TestNoFallback:
    def test_forced_kernel_failure_raises(self, monkeypatch):
        """Inversion of test_forced_failure_falls_back_bit_identical: the
        kernel route failing (monkeypatched where a CUDA tensor takes
        it) raises after the bounded retries; nothing serves the
        searchsorted route instead, no fallback counts, and wins2 is
        untouched (the count precedes every mutation)."""
        def broken(*a, **k):
            raise RuntimeError("forced kernel failure")

        scores, labels = _kstream(300, seed=17)
        ker = ExactAucIndex(device="cpu", compact_every=64, shards=2,
                            count_kernel=True, retry_backoff_s=0.0)
        ker.insert_batch(scores[:64], labels[:64])
        ker.compact()
        before = ker._wins2
        monkeypatch.setattr(sc, "signed_count_mesh", broken)
        with pytest.raises(RuntimeError, match="forced kernel failure"):
            ker.insert_batch(scores[64:124], labels[64:124])
        assert ker._wins2 == before
        snap = ker.metrics.snapshot()
        assert snap["count_kernel_fallbacks_total"]["value"] == 0
        assert snap["shard_retries_total"]["value"] == ker.shard_retries

    def test_fleet_forced_kernel_failure_raises(self, monkeypatch):
        def broken(*a, **k):
            raise RuntimeError("forced kernel failure")

        fleet = TenantFleetIndex(device="cpu", compact_every=8, shards=2,
                                 count_kernel=True, retry_backoff_s=0.0)
        scores, labels = _kstream(120, seed=19)
        fleet.apply_inserts([("a", scores[:20], labels[:20])])
        before = fleet.wins2("a")
        monkeypatch.setattr(sc, "tenant_count_mesh", broken)
        with pytest.raises(RuntimeError, match="forced kernel failure"):
            fleet.apply_inserts([("a", scores[20:40], labels[20:40])])
        assert fleet.wins2("a") == before
        assert fleet.metrics.snapshot()[
            "count_kernel_fallbacks_total"]["value"] == 0

    def test_no_env_kill_switch(self, monkeypatch):
        """Inversion of test_env_off_kill_switch: the JAX switch's value
        does not turn the port's kernel off."""
        monkeypatch.setenv("TUPLEWISE_SERVING_PALLAS", "off")
        idx = ExactAucIndex(device="cpu", shards=2, count_kernel=True,
                            compact_every=32)
        scores, labels = _kstream(120, seed=1)
        for i in range(0, 120, 40):
            idx.insert_batch(scores[i:i + 40], labels[i:i + 40])
        assert idx.metrics.snapshot()[
            "count_kernel_calls_total"]["value"] > 0

    def test_no_env_force_enable(self, monkeypatch):
        """Inversion of test_env_interpret_force_enables: the switch does
        not turn the kernel on either; the config alone decides."""
        monkeypatch.setenv("TUPLEWISE_SERVING_PALLAS", "interpret")
        idx = ExactAucIndex(device="cpu", shards=2, compact_every=32)
        ker = ExactAucIndex(device="cpu", shards=2, compact_every=32,
                            count_kernel=True)
        scores, labels = _kstream(120, seed=2)
        for i in range(0, 120, 40):
            idx.insert_batch(scores[i:i + 40], labels[i:i + 40])
            ker.insert_batch(scores[i:i + 40], labels[i:i + 40])
        assert idx._wins2 == ker._wins2
        assert idx.metrics.snapshot()[
            "count_kernel_calls_total"]["value"] == 0
        assert ker.metrics.snapshot()[
            "count_kernel_calls_total"]["value"] > 0


def test_heal_racing_background_builds_stays_exact():
    """A lost worker healed on the request thread while the compactor
    thread builds minors and majors (switch interval shortened so the
    threads interleave finely): every batch's wins2 equals the
    single-device index, and the final placements are on the healed
    mesh."""
    import sys

    scores, labels = _kstream(3000, seed=41)
    inj = FaultInjector.from_spec({"faults": [
        {"point": "sharded_count", "on_call": k, "action": "error",
         "dropped": [d]} for k, d in ((20, 3), (45, 0))]})
    hurt = ExactAucIndex(device="cpu", compact_every=32, window=900,
                         shards=4, bg_compact=True, chaos=inj,
                         max_delta_runs=2, retry_backoff_s=0.0)
    plain = ExactAucIndex(device="cpu", compact_every=32, window=900)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(0, 3000, 41):
            hurt.insert_batch(scores[i:i + 41], labels[i:i + 41])
            plain.insert_batch(scores[i:i + 41], labels[i:i + 41])
            assert hurt._wins2 == plain._wins2, i
        hurt.wait_idle(timeout=30.0)
    finally:
        sys.setswitchinterval(old)
    assert inj.snapshot()["fired"] == {"sharded_count": 2}
    assert hurt.shards == 2 and hurt.n_major_merges > 0
    for side in (hurt._pos, hurt._neg):
        for dev in (side.base_dev, side.delta_dev, side.tomb_dev):
            assert dev is None or dev.shape[0] == 2
    q = scores[:50].astype(np.float32)
    np.testing.assert_array_equal(hurt.score_batch(q), plain.score_batch(q))
    hurt.compact()
    assert hurt.auc() == plain.auc()
    hurt.close()
