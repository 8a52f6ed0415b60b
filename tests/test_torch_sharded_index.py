"""The port's sharded ExactAucIndex (a LocalComm mesh, device="cpu")
against the JAX package's sharded index on its 8 virtual CPU devices,
case for case with tests/test_sharded_index.py at S = 1, 2 and 4: wins2,
every AUC and every fractional rank bit for bit, through the delta
tiers (minor, tombstone multiset, on-mesh major merge, the host path)
and with the byte and occupancy counters equal; plus the occupancy and
skew gauges of tests/test_health.py and the sharded background
compaction of tests/test_bg_compaction.py."""

import numpy as np
import pytest

from tuplewise_tpu.serving import ExactAucIndex as JaxIndex
from tuplewise_tpu.serving.replay import make_stream as jax_make_stream
from tuplewise_tpu.testing.chaos import FaultInjector as JaxInjector
from tuplewise_tpu_torch.models.metrics import auc_score
from tuplewise_tpu_torch.parallel.mesh import make_mesh
from tuplewise_tpu_torch.serving import (
    ExactAucIndex, MicroBatchEngine, ServingConfig, make_stream,
)
from tuplewise_tpu_torch.testing import FaultInjector


def _stream(n, seed=7, pos_frac=0.45):
    scores, labels = make_stream(n, pos_frac=pos_frac, separation=1.0,
                                 seed=seed)
    js, jl = jax_make_stream(n, pos_frac=pos_frac, separation=1.0,
                             seed=seed)
    np.testing.assert_array_equal(scores, js)
    return scores.astype(np.float32), labels


def _oracle(scores, labels):
    pos, neg = scores[labels], scores[~labels]
    if len(pos) == 0 or len(neg) == 0:
        return None
    return auc_score(pos.astype(np.float64), neg.astype(np.float64))


_COUNTERS = ("bytes_h2d", "bytes_h2d_saved", "major_merges_total",
             "major_merge_fallbacks", "compactions_total")


def _same_state(idx, ref, where):
    """wins2, AUC, byte and occupancy counters equal to the JAX index."""
    assert idx._wins2 == ref._wins2, where
    assert idx.auc() == ref.auc(), where
    assert idx.shard_occupancy() == ref.shard_occupancy(), where
    got, want = idx.metrics.snapshot(), ref.metrics.snapshot()
    for k in _COUNTERS:
        assert got[k]["value"] == want[k]["value"], (k, where)


@pytest.mark.parametrize("shards", [1, 2, 4])
class TestShardedBitParity:
    def test_prefix_wins2_bit_identical_to_single_host(self, shards):
        scores, labels = _stream(1500)
        sharded = ExactAucIndex(device="cpu", compact_every=96,
                                shards=shards)
        ref = JaxIndex(engine="jax", compact_every=96, shards=shards)
        single = ExactAucIndex(device="cpu", compact_every=96)
        off = 0
        for c in (1, 2, 50, 96, 97, 200, 513, 777, 1024, 1500):
            sharded.insert_batch(scores[off:c], labels[off:c])
            ref.insert_batch(scores[off:c], labels[off:c])
            single.insert_batch(scores[off:c], labels[off:c])
            off = c
            _same_state(sharded, ref, c)
            assert sharded._wins2 == single._wins2, c
            oracle = _oracle(scores[:c], labels[:c])
            if oracle is not None:
                assert sharded.auc() == pytest.approx(oracle, abs=1e-6)
        assert sharded.n_compactions > 0

    def test_windowed_eviction_parity(self, shards):
        scores, labels = _stream(1200, seed=5)
        W = 300
        sharded = ExactAucIndex(device="cpu", window=W, compact_every=48,
                                shards=shards)
        ref = JaxIndex(engine="jax", window=W, compact_every=48,
                       shards=shards)
        for i in range(0, 1200, 29):
            k = min(i + 29, 1200)
            sharded.insert_batch(scores[i:k], labels[i:k])
            ref.insert_batch(scores[i:k], labels[i:k])
            _same_state(sharded, ref, k)
        assert sharded.auc() == pytest.approx(
            _oracle(scores[-W:], labels[-W:]), abs=1e-6)

    def test_score_batch_bit_identical(self, shards):
        scores, labels = _stream(900, seed=3)
        sharded = ExactAucIndex(device="cpu", compact_every=64,
                                shards=shards)
        ref = JaxIndex(engine="jax", compact_every=64, shards=shards)
        sharded.insert_batch(scores, labels)
        ref.insert_batch(scores, labels)
        q = np.linspace(-3, 3, 37, dtype=np.float32)
        np.testing.assert_array_equal(sharded.score_batch(q),
                                      ref.score_batch(q))


class TestShardedConfig:
    def test_rejects_numpy_engine(self):
        with pytest.raises(ValueError, match="engine='torch'"):
            ExactAucIndex(engine="numpy", shards=2)

    def test_existing_mesh_accepted(self):
        idx = ExactAucIndex(mesh=make_mesh(2, "cpu"), compact_every=32)
        scores, labels = _stream(200, seed=9)
        idx.insert_batch(scores, labels)
        assert idx.shards == 2
        assert idx.auc() == pytest.approx(_oracle(scores, labels), abs=1e-6)
        with pytest.raises(ValueError, match="1-D mesh"):
            from tuplewise_tpu_torch.parallel.mesh import make_mesh_2d

            ExactAucIndex(mesh=make_mesh_2d(2, 2, "cpu"))

    def test_state_reports_shards(self):
        idx = ExactAucIndex(device="cpu", shards=2)
        assert idx.state()["shards"] == 2
        assert idx.state()["delta_compact"] is True
        assert ExactAucIndex(device="cpu").state()["shards"] is None
        assert not ExactAucIndex(device="cpu", shards=2,
                                 delta_fraction=0).state()["delta_compact"]


class TestEngineIntegration:
    def test_mesh_shards_through_the_engine(self):
        scores, labels = _stream(800, seed=13)
        with MicroBatchEngine(ServingConfig(
                device="cpu", mesh_shards=2, compact_every=64,
                policy="block")) as eng:
            eng.insert(scores, labels).result(30.0)
            snap = eng.flush()
        assert snap["index"]["shards"] == 2
        assert snap["metrics"]["mesh_width"]["value"] == 2
        assert snap["auc_exact"] == pytest.approx(
            _oracle(scores, labels), abs=1e-6)


@pytest.mark.parametrize("shards", [1, 2, 4])
class TestDeltaCompaction:
    """The delta tiers are invisible to the statistic, and place what the
    JAX index places."""

    def test_randomized_insert_evict_compact_schedule(self, shards):
        rng = np.random.default_rng(shards)
        scores, labels = _stream(2200, seed=40 + shards)
        kw = dict(compact_every=48, shards=shards, window=500,
                  delta_fraction=0.25, max_delta_runs=3)
        delta = ExactAucIndex(device="cpu", **kw)
        ref = JaxIndex(engine="jax", **kw)
        single = ExactAucIndex(device="cpu", compact_every=48, window=500)
        off = 0
        saw_delta = False
        while off < len(scores):
            k = min(off + int(rng.integers(1, 70)), len(scores))
            for x in (delta, ref, single):
                x.insert_batch(scores[off:k], labels[off:k])
            off = k
            _same_state(delta, ref, off)
            assert delta._wins2 == single._wins2, off
            saw_delta = saw_delta or delta.state()["delta_events"] > 0
            if rng.random() < 0.05:
                delta.compact()     # full consolidation mid-stream
                ref.compact()
                _same_state(delta, ref, off)
        st = delta.state()
        assert saw_delta, "schedule never produced a delta run"
        assert st["n_major_merges"] > 0, "no major merge triggered"
        assert delta.n_evicted > 0
        assert delta.auc() == pytest.approx(
            _oracle(scores[-500:], labels[-500:]), abs=1e-6)
        q = np.linspace(-3, 3, 29, dtype=np.float32)
        np.testing.assert_array_equal(delta.score_batch(q),
                                      ref.score_batch(q))
        for a, b in zip(delta.oracle_values(), ref.oracle_values()):
            np.testing.assert_array_equal(a, b)

    def test_tombstones_subtract_exactly(self, shards):
        scores, labels = _stream(1500, seed=60 + shards)
        kw = dict(compact_every=32, shards=shards, window=300,
                  delta_fraction=0.5, max_delta_runs=4)
        delta = ExactAucIndex(device="cpu", **kw)
        ref = JaxIndex(engine="jax", **kw)
        for i in range(0, 1500, 37):
            k = min(i + 37, 1500)
            delta.insert_batch(scores[i:k], labels[i:k])
            ref.insert_batch(scores[i:k], labels[i:k])
            _same_state(delta, ref, k)
        assert delta.auc() == pytest.approx(
            _oracle(scores[-300:], labels[-300:]), abs=1e-6)

    def test_host_merge_mode_disables_tiers(self, shards):
        scores, labels = _stream(600, seed=70 + shards)
        kw = dict(compact_every=64, shards=shards, delta_fraction=0.0)
        idx = ExactAucIndex(device="cpu", **kw)
        ref = JaxIndex(engine="jax", **kw)
        idx.insert_batch(scores, labels)
        ref.insert_batch(scores, labels)
        st = idx.state()
        assert not st["delta_compact"]
        assert st["n_major_merges"] == 0 and st["delta_events"] == 0
        _same_state(idx, ref, "end")
        got = idx.metrics.snapshot()["compaction_bytes"]
        want = ref.metrics.snapshot()["compaction_bytes"]
        assert (got["count"], got["sum"]) == (want["count"], want["sum"])


class TestOnMeshMajorMerge:
    def test_on_mesh_path_taken_and_bytes_saved(self):
        scores, labels = _stream(1600, seed=5)
        kw = dict(compact_every=64, shards=2, delta_fraction=0.25,
                  max_delta_runs=3)
        idx = ExactAucIndex(device="cpu", **kw)
        ref = JaxIndex(engine="jax", **kw)
        for x in (idx, ref):
            x.insert_batch(scores, labels)
            for i in range(3):
                x.insert_batch(scores[i::3], labels[i::3])
        snap = idx.metrics.snapshot()
        assert idx.n_major_merges == ref.n_major_merges > 0
        assert snap["major_merge_fallbacks"]["value"] == 0
        assert snap["bytes_h2d_saved"]["value"] > 0
        _same_state(idx, ref, "end")

    def test_chaos_major_merge_takes_the_host_path(self):
        """An injected major_merge fault takes the counted host path; the
        statistic is untouched."""
        spec = {"faults": [{"point": "major_merge", "on_call": 1,
                            "action": "error"}]}
        chaos = FaultInjector.from_spec(spec)
        scores, labels = _stream(1200, seed=6)
        kw = dict(compact_every=64, shards=2, delta_fraction=0.25,
                  max_delta_runs=3)
        idx = ExactAucIndex(device="cpu", chaos=chaos, **kw)
        ref = JaxIndex(engine="jax", chaos=JaxInjector.from_spec(spec),
                       **kw)
        single = ExactAucIndex(device="cpu", compact_every=64)
        for i in range(0, 1200, 97):
            k = min(i + 97, 1200)
            for x in (idx, ref, single):
                x.insert_batch(scores[i:k], labels[i:k])
            assert idx._wins2 == single._wins2 == ref._wins2, k
        assert idx.metrics.snapshot()["major_merge_fallbacks"]["value"] == 1
        assert ref.metrics.snapshot()["major_merge_fallbacks"]["value"] == 1
        assert "InjectedFault" in idx.last_major_merge_error \
            or "InjectedDeviceError" in idx.last_major_merge_error
        assert chaos.snapshot()["fired"].get("major_merge") == 1

    def test_other_merge_failures_propagate(self, monkeypatch):
        """A known divergence from the JAX index, which catches every
        exception of the on-mesh merge: the port takes the host path only
        for an injected fault or a worker the healer finds lost, and any
        other exception (a fault of the code) propagates."""
        from tuplewise_tpu_torch.serving import index as index_mod

        def broken(*a, **k):
            raise ArithmeticError("a fault of the merge's own code")

        monkeypatch.setattr(index_mod, "sharded_major_merge", broken)
        scores, labels = _stream(1200, seed=6)
        idx = ExactAucIndex(device="cpu", compact_every=64, shards=2,
                            delta_fraction=0.25, max_delta_runs=3)
        with pytest.raises(ArithmeticError):
            for i in range(0, 1200, 97):
                idx.insert_batch(scores[i:i + 97], labels[i:i + 97])
        assert idx.metrics.snapshot()["major_merge_fallbacks"]["value"] == 0

    def test_lost_worker_takes_the_host_path(self, monkeypatch):
        """A merge failure the healer's probe classes as a lost worker is
        a counted fallback, as an injected fault is."""
        from tuplewise_tpu_torch.parallel import faults
        from tuplewise_tpu_torch.serving import index as index_mod

        def lost(*a, **k):
            raise RuntimeError("device lost mid-merge")

        monkeypatch.setattr(index_mod, "sharded_major_merge", lost)
        monkeypatch.setattr(faults, "detect_dropped_workers",
                            lambda mesh, timeout_s=None: (1,))
        scores, labels = _stream(1200, seed=6)
        idx = ExactAucIndex(device="cpu", compact_every=64, shards=2,
                            delta_fraction=0.25, max_delta_runs=3)
        single = ExactAucIndex(device="cpu", compact_every=64)
        for i in range(0, 1200, 97):
            idx.insert_batch(scores[i:i + 97], labels[i:i + 97])
            single.insert_batch(scores[i:i + 97], labels[i:i + 97])
            assert idx._wins2 == single._wins2
        assert idx.metrics.snapshot()["major_merge_fallbacks"]["value"] >= 1
        assert "device lost" in idx.last_major_merge_error


class TestShardedIndexGauges:
    def test_shard_occupancy_and_skew_gauges(self):
        idx = ExactAucIndex(device="cpu", shards=2, compact_every=64)
        ref = JaxIndex(engine="jax", shards=2, compact_every=64)
        rng = np.random.default_rng(0)
        for i in range(0, 512, 64):
            labels = rng.random(64) < 0.5
            s = rng.standard_normal(64).astype(np.float32)
            idx.insert_batch(s, labels)
            ref.insert_batch(s, labels)
        occ = idx.shard_occupancy()
        assert occ == ref.shard_occupancy() and len(occ) == 2
        placed = sum(
            len(side.placed_base if side.placed_base is not None
                else side.base) + len(side.delta_run)
            for side in (idx._pos, idx._neg))
        assert sum(occ) == placed > 0
        snap = idx.metrics.snapshot()
        assert 1.0 <= snap["shard_skew"]["value"] < 1.1
        assert snap["shard_skew"]["value"] == \
            ref.metrics.snapshot()["shard_skew"]["value"]
        assert snap["shard_balance_cv"]["value"] == \
            ref.metrics.snapshot()["shard_balance_cv"]["value"]


def test_sharded_plus_bg_compact():
    """Sharded runs with a background compactor stay bit-identical to the
    single-device index (tests/test_bg_compaction.py)."""
    scores, labels = _stream(1200, seed=17)
    both = ExactAucIndex(device="cpu", compact_every=64, shards=2,
                         bg_compact=True, window=500)
    plain = ExactAucIndex(device="cpu", compact_every=64, window=500)
    for i in range(0, 1200, 41):
        k = min(i + 41, 1200)
        both.insert_batch(scores[i:k], labels[i:k])
        plain.insert_batch(scores[i:k], labels[i:k])
        assert both._wins2 == plain._wins2, k
    both.compact()
    assert both.auc() == plain.auc()
    both.close()


@pytest.mark.parametrize("count_kernel", [False, True])
def test_sharded_delta_plus_bg_compact(count_kernel):
    """Delta tiers racing the background compactor against a sliding
    window stay bit-identical, and a major merge lands."""
    scores, labels = _stream(2400, seed=23)
    rng = np.random.default_rng(2)
    both = ExactAucIndex(device="cpu", compact_every=48, shards=2,
                         bg_compact=True, window=500, delta_fraction=0.25,
                         max_delta_runs=3, count_kernel=count_kernel)
    plain = ExactAucIndex(device="cpu", compact_every=48, window=500)
    off = 0
    while off < len(scores):
        k = min(off + int(rng.integers(1, 64)), len(scores))
        both.insert_batch(scores[off:k], labels[off:k])
        plain.insert_batch(scores[off:k], labels[off:k])
        off = k
        assert both._wins2 == plain._wins2, off
        assert both.auc() == plain.auc(), off
    both.wait_idle()
    assert both.state()["n_major_merges"] > 0
    assert both.state()["last_compactor_error"] is None
    both.compact()
    assert both._wins2 == plain._wins2
    assert both.auc() == pytest.approx(
        _oracle(scores[-500:], labels[-500:]), abs=1e-6)
    both.close()


@pytest.mark.parametrize("shards,window", [(1, 120), (2, None), (2, 150),
                                           (4, 100)])
def test_kernel_route_bit_identical_stream(shards, window):
    """tests/test_pallas_counts.py TestIndexKernelParity: count_kernel on
    (the worker-axis plain version here) against the JAX kernel-on index,
    with the tombstone multiset counted in the kernel."""
    rng = np.random.default_rng(3)
    labels = rng.random(500) < 0.5
    scores = (rng.standard_normal(500) + 0.8 * labels).astype(np.float32)
    scores[::13] = np.round(scores[::13], 1)
    kw = dict(compact_every=48, window=window, shards=shards,
              delta_fraction=0.25, max_delta_runs=3, count_kernel=True)
    ker = ExactAucIndex(device="cpu", **kw)
    ref = JaxIndex(engine="jax", **kw)
    i = 0
    for step, sz in enumerate([67, 1, 33, 0, 128, 97, 174] * 2):
        j = min(i + sz, len(scores))
        ker.insert_batch(scores[i:j], labels[i:j])
        ref.insert_batch(scores[i:j], labels[i:j])
        i = j
        _same_state(ker, ref, step)
        q = scores[max(0, j - 9):j]
        assert np.array_equal(np.nan_to_num(ker.score_batch(q)),
                              np.nan_to_num(ref.score_batch(q)))
    snap = ker.metrics.snapshot()
    assert snap["count_kernel_calls_total"]["value"] > 0
    assert snap["count_kernel_fallbacks_total"]["value"] == 0
    for a, b in zip(ker.oracle_values(), ref.oracle_values()):
        assert np.array_equal(a, b)


def test_one_worker_axis_count_per_insert_batch():
    """One fused count a micro-batch on the mesh: eviction queries ride
    the insert's count."""
    scores, labels = _stream(360, seed=13)
    ker = ExactAucIndex(device="cpu", compact_every=1000, window=100,
                        shards=2, count_kernel=True)
    ker.insert_batch(scores[:45], labels[:45])
    ker.compact()
    before = ker.metrics.snapshot()["count_kernel_calls_total"]["value"]
    n_batches = 0
    for i in range(45, 360, 45):
        ker.insert_batch(scores[i:i + 45], labels[i:i + 45])
        n_batches += 1
    calls = ker.metrics.snapshot()["count_kernel_calls_total"][
        "value"] - before
    assert calls == n_batches


def test_seed_and_export_state_on_a_mesh():
    """The handoff the fleet's whales use, onto a mesh: the seeded index
    places its runs and goes on equal to the donor."""
    scores, labels = _stream(900, seed=31)
    donor = ExactAucIndex(device="cpu", compact_every=64, window=400)
    donor.insert_batch(scores[:600], labels[:600])
    idx = ExactAucIndex(device="cpu", compact_every=64, window=400,
                        shards=4, count_kernel=True)
    idx.seed_state(*donor.export_state())
    assert idx._pos.base_dev is not None
    for i in range(600, 900, 50):
        donor.insert_batch(scores[i:i + 50], labels[i:i + 50])
        idx.insert_batch(scores[i:i + 50], labels[i:i + 50])
        assert idx._wins2 == donor._wins2
    assert idx.auc() == donor.auc()
