"""The port's MultiTenantEngine and replay_fleet against the JAX
package's: admission control with typed, tenant-attributed errors, the
deficit-round-robin drain order (equal to the JAX engine's for the same
submissions), tenant lifecycle, control-plane throttles, weights and
quotas, tenant-attributed close, the tenant-metric cap, and
replay_fleet's record (the JAX record's keys, every tenant's AUC equal
to its float32 oracle). Mirrors tests/test_tenancy.py and
tests/test_fleet_incremental.py of the JAX package."""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from tuplewise_tpu.serving.engine import ServingConfig as JaxConfig
from tuplewise_tpu.serving.replay import make_tenant_stream as jax_stream
from tuplewise_tpu.serving.replay import replay_fleet as jax_replay_fleet
from tuplewise_tpu.serving.tenancy import MultiTenantEngine as JaxEngine
from tuplewise_tpu.serving.tenancy import TenancyConfig as JaxTenancy
from tuplewise_tpu.serving.tenancy import _FleetRequest as JaxRequest
from tuplewise_tpu.serving.tenancy import tenant_seed as jax_tenant_seed
from tuplewise_tpu_torch.serving import (
    EngineClosedError, MultiTenantEngine, PoisonEventError, ServingConfig,
    StreamingIncompleteU, TenancyConfig, TenantRejectedError,
    TenantThrottledError, make_tenant_stream, replay_fleet, tenant_seed,
)
from tuplewise_tpu_torch.obs.tracing import Tracer
from tuplewise_tpu_torch.serving.tenancy import _FleetRequest


def _engine(tenancy=None, **kw):
    return MultiTenantEngine(ServingConfig(device="cpu", **kw), tenancy)


class TestAdmissionControl:
    def test_tenant_cap_typed(self):
        with _engine(TenancyConfig(max_tenants=2)) as eng:
            eng.insert("a", 1.0, 1).result(10.0)
            eng.insert("b", 0.5, 0).result(10.0)
            with pytest.raises(TenantRejectedError) as ei:
                eng.insert("c", 0.1, 1)
            assert ei.value.tenant == "c" and "c" in str(ei.value)
            m = eng.metrics.snapshot()
            assert m["tenant_rejected_total"]["value"] == 1
            assert m["tenant_rejected_total{tenant=c}"]["value"] == 1

    def test_tenant_quota_typed(self):
        with _engine(TenancyConfig(tenant_quota=3), max_batch=4,
                     flush_timeout_s=0.2) as eng:
            futs, rejected = [], 0
            for i in range(40):
                try:
                    futs.append(eng.insert("flood", float(i), i % 2))
                except TenantRejectedError as e:
                    assert e.tenant == "flood"
                    rejected += 1
            assert rejected > 0
            for f in futs:
                f.result(10.0)

    def test_poison_rejected_with_tenant(self):
        with _engine() as eng:
            with pytest.raises(PoisonEventError, match="tenant=bad"):
                eng.insert("bad", float("nan"), 1)
            with pytest.raises(PoisonEventError, match="shape mismatch"):
                eng.insert("bad", [1.0, 2.0], [1])
            assert eng.metrics.snapshot()["poison_rejects"]["value"] == 2

    def test_closed_engine_attributes_tenant(self):
        eng = _engine()
        eng.close()
        with pytest.raises(EngineClosedError) as ei:
            eng.insert("zoe", 1.0, 1)
        assert ei.value.tenant == "zoe"

    def test_throttle_sheds_typed_and_clears(self):
        with _engine() as eng:
            eng.throttle_tenant("hot", retry_after_s=30.0)
            assert eng.throttled_tenants() == ["hot"]
            with pytest.raises(TenantThrottledError) as ei:
                eng.insert("hot", 1.0, 1)
            assert ei.value.tenant == "hot" and ei.value.retry_after_s > 0
            eng.insert("cold", 1.0, 1).result(10.0)
            assert eng.clear_throttles("hot") == 1
            eng.insert("hot", 1.0, 1).result(10.0)
            eng.throttle_tenant("a", 30.0)
            eng.throttle_tenant("b", 30.0)
            assert eng.clear_throttles() == 2
            m = eng.metrics.snapshot()
            assert m["tenant_throttled_total"]["value"] == 1
            assert m["tenant_throttled_total{tenant=hot}"]["value"] == 1

    def test_quota_override(self):
        with _engine(TenancyConfig(tenant_quota=64), max_batch=4,
                     flush_timeout_s=0.2) as eng:
            eng.set_tenant_quota("x", 1)
            rejected = 0
            futs = []
            for i in range(20):
                try:
                    futs.append(eng.insert("x", float(i), 1))
                except TenantRejectedError:
                    rejected += 1
            assert rejected > 0
            eng.set_tenant_quota("x", None)
            for f in futs:
                f.result(10.0)

    def test_unported_options_raise(self, tmp_path):
        # recovery and tracing are ported: a snapshot directory is made
        # and owned, a tracer gives every request a root span
        tr = Tracer()
        d = tmp_path / "snap"
        with MultiTenantEngine(ServingConfig(device="cpu",
                                             snapshot_dir=str(d)),
                               tracer=tr) as eng:
            eng.insert("a", [0.5, 0.25], [1, 0]).result(10.0)
        assert (d / "snapshot.npz").exists() and (d / "events.wal").exists()
        assert "request.insert" in {s["name"] for s in tr.spans()}
        with pytest.raises(TypeError, match="Tracer"):
            MultiTenantEngine(ServingConfig(device="cpu"), tracer=object())
        # mesh_shards and chaos are ported
        with MultiTenantEngine(ServingConfig(device="cpu",
                                             mesh_shards=2)) as eng:
            assert eng.fleet.state()["shards"] == 2
        with pytest.raises(ValueError, match="exact AUC fleet"):
            MultiTenantEngine(ServingConfig(device="cpu", kernel="hinge"))


def _drain_order(make_request, engine, weights=None):
    """Queue 6 heavy and 2 light requests directly, then drain them."""
    with engine._cv:
        engine._pending = {
            "heavy": collections.deque(
                make_request("insert", "heavy", np.ones(1), np.ones(1))
                for _ in range(6)),
            "light": collections.deque(
                make_request("insert", "light", np.ones(1), np.ones(1))
                for _ in range(2)),
        }
        engine._rotation = ["heavy", "light"]
        engine._n_pending = 8
        for tid, w in (weights or {}).items():
            engine.set_tenant_weight(tid, w)
        return [r.tenant for r in engine._drr_take(8)]


class TestFairScheduling:
    @pytest.mark.parametrize("weights", [None, {"light": 1, "heavy": 3}])
    def test_drr_order_equals_jax_engine(self, weights):
        eng = _engine(TenancyConfig(weight=2))
        eng.close()      # park the worker; drain directly
        jeng = JaxEngine(JaxConfig(), JaxTenancy(weight=2))
        jeng.close()
        got = _drain_order(_FleetRequest, eng, weights)
        want = _drain_order(JaxRequest, jeng, weights)
        assert got == want
        if weights is None:
            assert got == ["heavy", "heavy", "light", "light", "heavy",
                           "heavy", "heavy", "heavy"]

    def test_waves_keep_each_tenant_order(self):
        kinds = ["insert", "insert", "score", "insert", "query", "insert"]
        tenants = ["a", "b", "a", "a", "b", "b"]
        batch = [_FleetRequest(k, t, np.ones(1), np.ones(1))
                 for k, t in zip(kinds, tenants)]
        jbatch = [JaxRequest(k, t, np.ones(1), np.ones(1))
                  for k, t in zip(kinds, tenants)]

        def shape(waves):
            return [{k: [(tid, len(reqs)) for tid, reqs in v]
                     for k, v in w.items()} for w in waves]

        assert (shape(MultiTenantEngine._waves(batch))
                == shape(JaxEngine._waves(jbatch)))

    def test_light_tenant_served_alongside_flood(self):
        with _engine(TenancyConfig(weight=2, tenant_quota=4096), max_batch=8,
                     flush_timeout_s=0.01, queue_size=4096) as eng:
            heavy = [eng.insert("heavy", float(i), i % 2) for i in range(200)]
            light = eng.insert("light", 0.5, 1)
            light.result(5.0)
            for f in heavy:
                f.result(10.0)
            assert eng.tenant_stats("light")["n_events"] == 1
            assert eng.pending_by_tenant() == {}


class TestTenantLifecycle:
    def test_idle_eviction(self):
        with _engine(TenancyConfig(idle_evict_s=0.15), max_batch=8,
                     flush_timeout_s=0.001) as eng:
            eng.insert("old", 1.0, 1).result(5.0)
            deadline = time.monotonic() + 5.0
            while eng.fleet.has("old") and time.monotonic() < deadline:
                eng.insert("fresh", 0.5, 0).result(5.0)
                time.sleep(0.05)
            assert not eng.fleet.has("old") and eng.fleet.has("fresh")
            m = eng.metrics.snapshot()
            assert m["tenants_evicted_total"]["value"] >= 1
            eng.insert("old", 2.0, 1).result(5.0)
            assert eng.tenant_stats("old")["n_events"] == 1

    def test_drop_then_recreate_and_stats(self):
        with _engine() as eng:
            eng.insert("a", [1.0, 0.0], [1, 0]).result(5.0)
            snap = eng.query("a").result(5.0)
            assert snap["auc_exact"] == 1.0 and snap["n_events"] == 2
            assert "estimate_incomplete" in snap
            ranks = eng.score("a", [0.5, -1.0]).result(5.0)
            np.testing.assert_array_equal(ranks, [1.0, 0.0])
            assert eng.drop_tenant("a") and not eng.drop_tenant("a")
            eng.insert("a", 3.0, 1).result(5.0)
            assert eng.tenant_stats("a")["n_events"] == 1
            st = eng.stats()
            assert st["tenants_live"] == 1 and st["fleet"]["tenants"] == 1

    def test_drop_while_inserts_queued_recreates_stream(self):
        """Port-only: a tenant dropped while its inserts wait in the queue
        is re-created when the wave applies (the JAX engine raises
        KeyError there and fails the wave). The wave resolves, and the
        tenant's statistic holds only the events after the drop."""
        eng = _engine(max_batch=64, flush_timeout_s=0.001)
        try:
            eng.insert("a", [1.0, 0.0], [1, 0]).result(5.0)
            old_stream = eng._streams["a"]
            created = eng.metrics.snapshot()["tenants_created_total"]["value"]
            apply = eng.fleet.apply_inserts
            started, release = threading.Event(), threading.Event()

            def gated_apply(items):
                if not started.is_set():
                    started.set()
                    assert release.wait(10.0)
                return apply(items)

            eng.fleet.apply_inserts = gated_apply
            f0 = eng.insert("u0", 1.0, 1)
            assert started.wait(10.0)           # the worker holds u0's wave
            queued = [eng.insert("a", [2.0, 0.5], [1, 0]),
                      eng.insert("a", 0.1, 0)]
            assert eng.pending_by_tenant() == {"a": 2}
            assert eng.drop_tenant("a") and "a" not in eng._streams
            release.set()
            assert f0.result(5.0) == 1
            assert [f.result(5.0) for f in queued] == [2, 1]
            eng.flush()
            assert eng._streams["a"] is not old_stream
            m = eng.metrics.snapshot()
            assert m["tenants_created_total"]["value"] == created + 2
            assert eng.tenant_stats("a")["n_events"] == 3
            assert eng.tenant_stats("a")["auc_exact"] == 1.0
        finally:
            eng.close()

    def test_tenant_streams_deterministic_seeds(self):
        assert tenant_seed(3, "t7") == jax_tenant_seed(3, "t7")
        assert tenant_seed(3, "t7") != tenant_seed(3, "t8")
        with _engine(budget=8) as eng:
            eng.create_tenant("t7")
            ref = StreamingIncompleteU(kernel="auc", budget=8,
                                       seed=tenant_seed(0, "t7"))
            s, lab = make_tenant_stream(300, 1, seed=2)[:2]
            eng._streams["t7"].extend(s, lab)
            ref.extend(s, lab)
            assert eng._streams["t7"].estimate() == ref.estimate()


class TestCloseAttribution:
    def test_fleet_close_names_tenants(self):
        eng = _engine()
        apply = eng.fleet.apply_inserts
        started = threading.Event()

        def slow_apply(items):
            started.set()
            time.sleep(0.8)
            return apply(items)

        eng.fleet.apply_inserts = slow_apply
        f0 = eng.insert("u0", 1.0, 1)
        assert started.wait(10.0)    # u0 is being applied
        f1 = eng.insert("u1", 1.0, 1)
        f2 = eng.insert("u2", 0.5, 0)
        eng.close()
        assert f0.result(5.0) == 1
        seen = set()
        for f in (f1, f2):
            with pytest.raises(EngineClosedError) as ei:
                f.result(5.0)
            seen.add(ei.value.tenant)
            assert f"tenant={ei.value.tenant}" in str(ei.value)
        assert seen == {"u1", "u2"}


class TestTenantMetricCap:
    def test_cap_bounds_series_and_counts_collapsed(self):
        with _engine(TenancyConfig(tenant_metric_cap=2), max_batch=16,
                     flush_timeout_s=0.001) as eng:
            for k in range(5):
                eng.insert(f"u{k}", float(k), k % 2).result(10.0)
            eng.flush()
            m = eng.metrics.snapshot()
        labeled = sorted(k for k in m if k.startswith("insert_latency_s{"))
        assert len(labeled) == 3, labeled
        assert "insert_latency_s{tenant=__other__}" in labeled
        assert m["tenant_metric_collapsed"]["value"] == 3
        assert m["insert_latency_s{tenant=__other__}"]["count"] >= 3

    def test_uncapped_default_keeps_per_tenant_series(self):
        with _engine(max_batch=16, flush_timeout_s=0.001) as eng:
            for k in range(4):
                eng.insert(f"u{k}", float(k), k % 2).result(10.0)
            m = eng.metrics.snapshot()
        labeled = [k for k in m if k.startswith("insert_latency_s{")]
        assert len(labeled) == 4


# the JAX record's keys that the port does not produce: the SLO and
# control-plane blocks, metrics export and fault injection are not
# ported yet
UNPORTED_RECORD_KEYS = {"slo", "controller", "metrics_out", "faults"}


class TestReplayFleet:
    def test_zipf_stream_equals_jax(self):
        got = make_tenant_stream(2000, 8, skew=1.2, seed=5)
        want = jax_stream(2000, 8, skew=1.2, seed=5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        scores, labels, tenants = got
        counts = {t: int((tenants == t).sum()) for t in np.unique(tenants)}
        assert counts["t0"] > counts[max(counts)]
        _, _, uni = make_tenant_stream(2000, 8, skew=0.0, seed=5)
        assert len(np.unique(uni)) == 8
        with pytest.raises(ValueError):
            make_tenant_stream(10, 0)

    @pytest.mark.parametrize("count_kernel", [True, False])
    def test_record_contract_and_parity(self, count_kernel):
        scores, labels, tenants = make_tenant_stream(1200, 6, seed=6)
        kw = dict(window=200, compact_every=64, max_batch=64,
                  policy="block", flush_timeout_s=0.001,
                  count_kernel=count_kernel)
        rec = replay_fleet(scores, labels, tenants,
                           config=ServingConfig(device="cpu", **kw),
                           chunk=3, max_inflight=64)
        assert rec["events_applied"] == 1200
        assert rec["n_tenants"] == 6
        assert rec["tenant_auc_max_abs_err"] == 0
        assert 0 < rec["fleet_count_calls"] <= rec["batches"]
        assert rec["admission"]["tenants_created_total"] == 6
        assert set(rec["tenant_insert_p99_ms"]) == {f"t{k}" for k in range(6)}
        assert rec["report"]["tenancy"]["tenants_live"] == 6
        assert rec["host_tax"]["coverage"] == pytest.approx(1.0)
        jrec = jax_replay_fleet(scores, labels, tenants,
                                config=JaxConfig(**kw), chunk=3,
                                max_inflight=64)
        assert set(jrec) - UNPORTED_RECORD_KEYS <= set(rec)
        assert set(jrec["report"]) <= set(rec["report"]) | {"controller"}
        assert set(jrec["admission"]) == set(rec["admission"])
        assert set(jrec["report"]["tenancy"]) == set(rec["report"]["tenancy"])
        assert rec["tenants_live"] == jrec["tenants_live"]

    def test_unported_options_raise(self, tmp_path):
        scores, labels, tenants = make_tenant_stream(10, 2)
        # every option is ported: the control plane rides the SLO
        # monitor, and without one it raises the reference's error
        with pytest.raises(ValueError, match="controller_spec needs "
                                             "slo_spec"):
            replay_fleet(scores, labels, tenants,
                         config=ServingConfig(device="cpu"),
                         controller_spec={})
        rec = replay_fleet(
            scores, labels, tenants, config=ServingConfig(device="cpu"),
            slo_spec={"objectives": [{"name": "p99", "type": "latency",
                                      "metric": "insert_latency_s",
                                      "quantile": "p99",
                                      "threshold_ms": 1e6}]},
            controller_spec={"knobs": ["shed"]},
            metrics_out=str(tmp_path / "m.jsonl"),
            flight_out=str(tmp_path / "f.jsonl"))
        assert rec["slo"]["healthy"] and rec["report"]["slo"]["healthy"]
        assert rec["controller"]["knobs"] == {
            "shed": {"level": 0, "used": 0, "budget": 64}}
        assert rec["report"]["controller"]["actuations_total"] == 0
        assert rec["metrics_out"] == str(tmp_path / "m.jsonl")
        assert (tmp_path / "m.jsonl").exists()
        assert (tmp_path / "f.jsonl").exists()

    def test_engine_wins2_equal_jax_engine(self):
        """Both engines fed the same submissions end with the same
        per-tenant wins2 (it depends only on each tenant's event
        order)."""
        scores, labels, tenants = make_tenant_stream(900, 5, seed=9)
        kw = dict(compact_every=32, max_batch=32, policy="block",
                  flush_timeout_s=0.001, window=150, queue_size=4096)
        engines = (MultiTenantEngine(ServingConfig(device="cpu", **kw),
                                     TenancyConfig(tenant_quota=4096)),
                   JaxEngine(JaxConfig(**kw), JaxTenancy(tenant_quota=4096)))
        for eng in engines:
            futs = [eng.insert(t, s, lab)
                    for s, lab, t in zip(scores, labels, tenants)]
            for f in futs:
                f.result(30.0)
            eng.flush()
        port, ref = engines
        for t in np.unique(tenants):
            assert port.fleet.wins2(str(t)) == ref.fleet.wins2(str(t))
        for eng in engines:
            eng.close()


def test_engine_runs_on_the_configured_device():
    with _engine() as eng:
        eng.insert("a", [1.0, 0.0, 0.5], [1, 0, 1]).result(5.0)
        assert eng.fleet.device == torch.device("cpu")
        assert eng.fleet._neg_pack.dev.device == torch.device("cpu")
