"""The port's streaming estimators, MicroBatchEngine and replay against
the JAX package: StreamingIncompleteU on fixed batches (auc and hinge
equal, logistic within rel 1e-12: another log1p/exp), StreamingEstimator,
replay's exact AUC against the JAX replay and the oracle with the same
record keys; and the engine's request path (ordering, coalescing,
backpressure, poison, deadlines, close) as tests/test_serving_engine.py
and tests/test_chaos_serving.py pin it. Every wait has a timeout."""

import threading
import time

import numpy as np
import pytest

from tuplewise_tpu.estimators.streaming import (
    StreamingEstimator as JaxStreamingEstimator,
)
from tuplewise_tpu.serving import ServingConfig as JaxServingConfig
from tuplewise_tpu.serving.replay import replay as jax_replay
from tuplewise_tpu.serving.streaming import (
    StreamingIncompleteU as JaxStreamingIncompleteU,
)
from tuplewise_tpu_torch import StreamingEstimator
from tuplewise_tpu_torch.models.metrics import auc_score
from tuplewise_tpu_torch.obs.health import EstimateHealth
from tuplewise_tpu_torch.serving import (
    BackpressureError, DeadlineExceededError, EngineClosedError,
    MicroBatchEngine, PoisonEventError, ServingConfig, StreamingIncompleteU,
    make_stream, replay,
)

T = 10.0    # seconds any future or join may wait


def _cfg(**kw):
    kw.setdefault("engine", "numpy")   # host counting: fast
    kw.setdefault("policy", "block")
    kw.setdefault("device", "cpu")
    return ServingConfig(**kw)


@pytest.mark.parametrize("design", ["swr", "swor"])
@pytest.mark.parametrize("kernel", ["auc", "hinge", "logistic"])
def test_streaming_incomplete_u_equals_jax(kernel, design):
    scores, labels = make_stream(2000, seed=4)
    ours = StreamingIncompleteU(kernel, budget=16, reservoir=300,
                                design=design, seed=3,
                                health=EstimateHealth(retain_terms=True))
    ref = JaxStreamingIncompleteU(kernel, budget=16, reservoir=300,
                                  design=design, seed=3)
    for i, sz in enumerate([1, 5, 64, 200, 7, 333, 1000, 390]):
        off = sum([1, 5, 64, 200, 7, 333, 1000, 390][:i])
        s, l_ = scores[off:off + sz], labels[off:off + sz]
        assert ours.extend(s, l_) == ref.extend(s, l_)
        if kernel == "logistic":
            assert ours.estimate() == pytest.approx(ref.estimate(),
                                                    rel=1e-12, abs=0)
        else:
            assert ours.estimate() == ref.estimate()
    np.testing.assert_array_equal(ours._pos.items, ref._pos.items)
    assert ours.state().keys() - {"health"} == ref.state().keys()
    check = ours.health.offline_check()
    assert check["abs_err"]["mean"] < 1e-12


def test_streaming_estimator_equals_jax():
    scores, labels = make_stream(3000, seed=12)
    ours = StreamingEstimator(window=700, compact_every=64, device="cpu",
                              count_kernel=True, budget=8, seed=2)
    ref = JaxStreamingEstimator(window=700, compact_every=64,
                                engine="jax", budget=8, seed=2)
    for i in range(0, 3000, 211):
        ours.extend(scores[i:i + 211], labels[i:i + 211])
        ref.extend(scores[i:i + 211], labels[i:i + 211])
        assert ours.auc() == ref.auc()
        assert ours.estimate() == ref.estimate()
    np.testing.assert_array_equal(ours.score([0.0, 1.5]),
                                  ref.score([0.0, 1.5]))
    assert (ours.n_pos, ours.n_neg) == (ref.n_pos, ref.n_neg)
    hinge = StreamingEstimator("hinge", device="cpu")
    hinge.observe(1.0, 1)
    hinge.observe(0.0, 0)
    assert hinge.auc() is None and hinge.estimate() == 0.0
    with pytest.raises(ValueError, match="exact index"):
        hinge.score([0.5])


@pytest.mark.parametrize("window", [None, 700])
def test_replay_auc_equals_jax_replay_and_oracle(window):
    scores, labels = make_stream(3000, seed=6)
    kw = dict(policy="block", max_batch=64, flush_timeout_s=0.001,
              window=window, compact_every=128, budget=8)
    rec = replay(scores, labels, max_inflight=64,
                 config=ServingConfig(device="cpu", count_kernel=True, **kw))
    ref = jax_replay(scores, labels, max_inflight=64,
                     config=JaxServingConfig(engine="jax", **kw))
    assert rec["events_applied"] == 3000
    assert rec["auc_exact"] == ref["auc_exact"] == rec["auc_oracle"]
    assert rec["auc_abs_err"] == 0.0
    tail = slice(None) if window is None else slice(-window, None)
    s32, lt = scores[tail].astype(np.float32), labels[tail]
    assert rec["auc_exact"] == auc_score(s32[lt], s32[~lt])
    assert set(ref) <= set(rec)
    assert set(ref["report"]) <= set(rec["report"]) | {"slo"}
    assert set(ref["host_tax"]) == set(rec["host_tax"])
    assert abs(rec["host_tax"]["coverage"] - 1.0) < 1e-6
    assert abs(rec["stage_attribution"]["coverage"] - 1.0) < 1e-6
    assert rec["index"]["count_kernel"] is True
    assert rec["report"]["rejected_total"] == 0


class TestRequestPath:
    def test_insert_then_query_sees_events(self):
        with MicroBatchEngine(_cfg()) as eng:
            eng.insert([1.0, 2.0, 0.5], [1, 1, 0]).result(T)
            snap = eng.query().result(T)
        assert snap["index"]["n_events"] == 3
        assert snap["auc_exact"] == 1.0

    def test_score_matches_index(self):
        scores, labels = make_stream(400, seed=1)
        with MicroBatchEngine(_cfg(engine="torch",
                                   count_kernel=True)) as eng:
            eng.insert(scores, labels).result(T)
            ranks = eng.score([0.0, 1.0]).result(T)
            direct = eng.index.score_batch([0.0, 1.0])
        np.testing.assert_array_equal(ranks, direct)

    def test_coalescing_preserves_kind_order(self):
        with MicroBatchEngine(_cfg(flush_timeout_s=0.05,
                                   max_batch=64)) as eng:
            futs = []
            for i in range(10):
                futs.append(eng.insert([float(i)], [i % 2]))
                futs.append(eng.query())
            results = [f.result(T) for f in futs]
        for i in range(10):
            assert results[2 * i + 1]["index"]["n_events"] >= i + 1

    def test_runs_split_consecutive_kinds(self):
        class R:
            def __init__(self, kind):
                self.kind = kind
        reqs = [R(k) for k in ("insert", "insert", "score", "query",
                               "query", "insert")]
        runs = MicroBatchEngine._runs(reqs)
        assert [(k, len(rs)) for k, rs in runs] == [
            ("insert", 2), ("score", 1), ("query", 2), ("insert", 1)]

    def test_non_auc_kernel_has_no_index(self):
        with MicroBatchEngine(_cfg(kernel="hinge")) as eng:
            eng.insert([1.0, 0.0], [1, 0]).result(T)
            with pytest.raises(ValueError, match="exact AUC index"):
                eng.score([0.5]).result(T)
            snap = eng.query().result(T)
        assert "index" not in snap
        assert "estimate_incomplete" in snap

    def test_metrics_snapshot_shape(self):
        scores, labels = make_stream(300, seed=10)
        with MicroBatchEngine(_cfg(max_batch=16)) as eng:
            for i in range(0, 300, 3):
                eng.insert(scores[i:i + 3], labels[i:i + 3])
            snap = eng.flush(timeout=T)
        m = snap["metrics"]
        assert m["events_total"]["value"] == 300
        assert m["request_latency_s"]["count"] >= 100
        assert 0 < m["batch_fill"]["mean"] <= 1.0
        assert m["incomplete_pairs_total"]["value"] > 0
        assert m["host_tax_waves_total"]["value"] >= 1

    def test_unported_options_raise(self):
        with pytest.raises(NotImplementedError):
            MicroBatchEngine(_cfg(snapshot_dir="x"))
        with pytest.raises(NotImplementedError):
            MicroBatchEngine(_cfg(recover=True))
        # mesh_shards and chaos are ported: their checks
        with pytest.raises(ValueError, match="delta_fraction"):
            _cfg(delta_fraction=-1.0)
        with MicroBatchEngine(_cfg(engine="torch", mesh_shards=2)) as eng:
            assert eng.index.state()["shards"] == 2
        with pytest.raises(NotImplementedError, match="tracing"):
            MicroBatchEngine(_cfg(), tracer=object())
        with pytest.raises(NotImplementedError, match="slo_spec"):
            replay([0.0], [1], config=_cfg(), slo_spec={"x": 1})
        with pytest.raises(ValueError, match="engine"):
            ServingConfig(engine="jax")


def _stalled_engine(**kw):
    """Engine whose batcher is held until ``release`` is set."""
    eng = MicroBatchEngine(_cfg(**kw))
    orig = eng._apply_inserts
    release = threading.Event()

    def slow(run):
        release.wait(timeout=T)
        orig(run)
    eng._apply_inserts = slow
    return eng, release


class TestBackpressureAndLifecycle:
    def test_reject_policy_raises_and_counts(self):
        eng, release = _stalled_engine(policy="reject", queue_size=4,
                                       max_batch=1, flush_timeout_s=0.0)
        try:
            eng.insert([0.0], [0])
            time.sleep(0.05)
            rejected = 0
            for i in range(20):
                try:
                    eng.insert([float(i)], [i % 2])
                except BackpressureError:
                    rejected += 1
            assert rejected > 0
            assert eng.metrics.snapshot()["rejected_total"]["value"] \
                == rejected
        finally:
            release.set()
            eng.close()

    def test_drop_oldest_fails_stale_future(self):
        eng, release = _stalled_engine(policy="drop_oldest", queue_size=2,
                                       max_batch=1, flush_timeout_s=0.0)
        try:
            first = eng.insert([0.0], [0])
            time.sleep(0.05)
            futs = [eng.insert([float(i)], [i % 2]) for i in range(8)]
            release.set()
            outcomes = []
            for f in futs:
                try:
                    f.result(T)
                    outcomes.append("ok")
                except BackpressureError:
                    outcomes.append("dropped")
            assert "dropped" in outcomes and "ok" in outcomes
            assert first.result(T) == 1
            assert eng.metrics.snapshot()["dropped_total"]["value"] \
                == outcomes.count("dropped")
        finally:
            release.set()
            eng.close()

    def test_block_policy_close_fails_queued_producers(self):
        eng, release = _stalled_engine(policy="block", queue_size=2,
                                       max_batch=1, flush_timeout_s=0.0)
        eng.insert([0.0], [0])          # occupies the batcher
        time.sleep(0.05)
        outcomes = []

        def producer(i):
            try:
                eng.insert([float(i)], [i % 2]).result(T)
                outcomes.append("ok")
            except EngineClosedError:
                outcomes.append("closed")
        threads = [threading.Thread(target=producer, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        closer = threading.Thread(target=eng.close, kwargs={"timeout": T})
        closer.start()
        time.sleep(0.1)
        release.set()
        closer.join(timeout=T)
        for t in threads:
            t.join(timeout=T)
            assert not t.is_alive(), "producer stuck through close()"
        assert not closer.is_alive()
        assert len(outcomes) == 6 and "closed" in outcomes
        with pytest.raises(EngineClosedError):
            eng.insert([1.0], [1])
        eng.close()                      # idempotent

    def test_close_fails_queued_requests_with_tenant(self):
        eng, release = _stalled_engine(max_batch=1, flush_timeout_s=0.0)
        eng.insert([0.0], [0])
        time.sleep(0.05)
        queued = eng.insert([1.0], [1], tenant="t7")
        closer = threading.Thread(target=eng.close, kwargs={"timeout": T})
        closer.start()
        time.sleep(0.1)
        release.set()
        closer.join(timeout=T)
        assert not closer.is_alive()
        with pytest.raises(EngineClosedError) as err:
            queued.result(T)
        assert err.value.tenant == "t7"

    def test_poison_rejected_at_edge(self):
        with MicroBatchEngine(_cfg()) as eng:
            with pytest.raises(PoisonEventError, match="non-finite"):
                eng.insert([np.nan, 1.0], [1, 0])
            with pytest.raises(PoisonEventError, match="mismatch"):
                eng.insert([1.0, 2.0], [1])
            eng.insert([1.0, 0.0], [1, 0]).result(T)
            snap = eng.flush(timeout=T)
        assert snap["metrics"]["poison_rejects"]["value"] == 2
        assert snap["index"]["n_events"] == 2
        assert eng.flight.counts()["poison_reject"] == 2

    def test_deadline_expires_stale_requests(self):
        eng, release = _stalled_engine(deadline_s=0.05, max_batch=4,
                                       flush_timeout_s=0.0)
        first = eng.insert([0.0], [0])       # holds the batcher...
        time.sleep(0.2)                      # ...past the deadline
        late = eng.insert([1.0], [1])
        time.sleep(0.2)
        release.set()
        with pytest.raises(DeadlineExceededError):
            late.result(T)
        first.result(T)        # already dispatched: deadline unchecked
        snap = eng.flush(timeout=T)
        eng.close()
        assert snap["metrics"]["deadline_expired_total"]["value"] >= 1

    def test_batcher_supervisor_restarts(self):
        with MicroBatchEngine(_cfg()) as eng:
            orig = eng._dispatch
            calls = []

            def crash_once(batch):
                if not calls:
                    calls.append(1)
                    for r in batch:
                        r.future.set_result(None)
                    raise SystemError("injected batcher crash")
                orig(batch)
            eng._dispatch = crash_once
            eng.insert([0.5], [1]).result(T)
            for i in range(5):
                eng.insert([float(i)], [i % 2]).result(T)
            snap = eng.flush(timeout=T)
        assert snap["metrics"]["batcher_restarts"]["value"] == 1
        assert snap["index"]["n_events"] == 5
