"""The port's ExactAucIndex (device="cpu") against the JAX package's
ExactAucIndex(engine="jax"): wins2, auc() and score_batch bit-identical
at every step, with and without the fused count kernel, synchronous and
background compaction, unbounded and windowed; the one-count-per-insert
-batch witness; the seed_state/export_state handoff between the two
packages; and the prefix-parity contract of tests/test_serving_index.py
against the midrank oracle."""

import threading

import numpy as np
import pytest

from tuplewise_tpu.serving.index import ExactAucIndex as JaxIndex
from tuplewise_tpu_torch.models.metrics import auc_score
from tuplewise_tpu_torch.serving import ExactAucIndex, make_stream


def _stream(n, seed=0, sep=0.8, dup_every=13):
    rng = np.random.default_rng(seed)
    labels = rng.random(n) < 0.5
    scores = (rng.standard_normal(n) + sep * labels).astype(np.float32)
    # duplicated values exercise the left/right tie boundaries
    scores[::dup_every] = np.round(scores[::dup_every], 1)
    return scores, labels


def _oracle(scores, labels):
    pos, neg = scores[labels], scores[~labels]
    if len(pos) == 0 or len(neg) == 0:
        return None
    return auc_score(pos.astype(np.float64), neg.astype(np.float64))


def _check_parity(window, count_kernel, bg_compact, gate=None):
    """Drive the port's index and the JAX index through the same stream
    and hold wins2, auc() and score_batch equal at every step. ``gate``
    (bg_compact only) holds every background build of the port's index
    until the stream is in, so every insert and score runs against the
    buffer alone, as it does when the compactor thread is starved."""
    scores, labels = _stream(500, seed=3)
    kw = dict(compact_every=48, window=window, bg_compact=bg_compact)
    ref = JaxIndex(engine="jax", count_kernel=count_kernel, **kw)
    idx = ExactAucIndex(device="cpu", count_kernel=count_kernel, **kw)
    if gate is not None:
        idx._bg_test_hook = lambda side: gate.wait(timeout=30.0)
    sizes = [67, 1, 33, 0, 128, 97, 174]
    i = 0
    for step, sz in enumerate(sizes * 2):
        j = min(i + sz, len(scores))
        ref.insert_batch(scores[i:j], labels[i:j])
        idx.insert_batch(scores[i:j], labels[i:j])
        i = j
        assert idx._wins2 == ref._wins2, step
        assert idx.auc() == ref.auc(), step
        q = scores[max(0, j - 9):j]
        assert np.array_equal(np.nan_to_num(idx.score_batch(q)),
                              np.nan_to_num(ref.score_batch(q)))
    if gate is not None:
        gate.set()
    idx.wait_idle(timeout=30.0)
    ref.wait_idle(timeout=30.0)
    for a, b in zip(idx.oracle_values(), ref.oracle_values()):
        np.testing.assert_array_equal(a, b)
    assert idx.n_compactions > 0
    # Once both are idle, every side has a base run, so this score is one
    # count on the device. Before it, a count may never have run: a count
    # with no base run has nothing to search and is no call, and with
    # bg_compact the first base lands whenever the compactor thread runs.
    q = scores[::7]
    assert np.array_equal(idx.score_batch(q), ref.score_batch(q))
    snap = idx.metrics.snapshot()
    assert (snap["count_kernel_calls_total"]["value"] > 0) == count_kernel
    assert snap["count_kernel_fallbacks_total"]["value"] == 0
    idx.close()
    ref.close()


@pytest.mark.parametrize("bg_compact", [False, True])
@pytest.mark.parametrize("count_kernel", [True, False])
@pytest.mark.parametrize("window", [None, 120])
def test_bit_identical_to_jax_index(window, count_kernel, bg_compact):
    _check_parity(window, count_kernel, bg_compact)


@pytest.mark.parametrize("count_kernel", [True, False])
@pytest.mark.parametrize("window", [None, 120])
def test_bit_identical_with_a_stalled_compactor(window, count_kernel):
    """No background build lands before the last insert (the timing of
    a loaded machine, made certain): the index stays equal to the JAX
    index, and the count witness still sees the kernel."""
    _check_parity(window, count_kernel, True, gate=threading.Event())


def test_one_count_call_per_insert_batch():
    scores, labels = _stream(360, seed=13)
    idx = ExactAucIndex(device="cpu", compact_every=1000, window=100,
                        count_kernel=True)
    # before the base runs exist a batch needs no device count at all
    idx.insert_batch(scores[:45], labels[:45])
    idx.compact()
    before = idx.metrics.snapshot()["count_kernel_calls_total"]["value"]
    n_batches = 0
    for i in range(45, 360, 45):
        idx.insert_batch(scores[i:i + 45], labels[i:i + 45])
        n_batches += 1
    calls = idx.metrics.snapshot()["count_kernel_calls_total"]["value"]
    assert calls - before == n_batches
    # the device copy of a base run is placed once per compaction
    assert idx.metrics.snapshot()["bytes_h2d"]["value"] == 2 * 256 * 4
    idx.close()


@pytest.mark.parametrize("count_kernel", [True, False])
def test_count_kernel_picks_only_the_route(count_kernel, monkeypatch):
    """Both routes take the fused insert+evict path: one count call per
    insert batch; count_kernel decides only whether it is the kernel."""
    from tuplewise_tpu_torch.serving import index as ix

    seen = []
    real = ix.signed_pair_counts

    def spy(*args, **kwargs):
        seen.append(kwargs["kernel"])
        return real(*args, **kwargs)

    monkeypatch.setattr(ix, "signed_pair_counts", spy)
    scores, labels = _stream(360, seed=13)
    idx = ExactAucIndex(device="cpu", compact_every=1000, window=100,
                        count_kernel=count_kernel)
    idx.insert_batch(scores[:45], labels[:45])
    idx.compact()
    seen.clear()
    for i in range(45, 360, 45):
        idx.insert_batch(scores[i:i + 45], labels[i:i + 45])
    assert seen == [True if count_kernel else None] * 7
    idx.close()


@pytest.mark.parametrize("count_kernel", [True, False])
def test_state_handoff_with_jax_index(count_kernel):
    """A JAX index exported mid-stream seeds the port's index (and the
    other way round); both then stay bit-identical."""
    scores, labels = _stream(700, seed=5)
    ref = JaxIndex(engine="jax", window=150, compact_every=40)
    for i in range(0, 330, 55):
        ref.insert_batch(scores[i:i + 55], labels[i:i + 55])
    idx = ExactAucIndex(device="cpu", window=150, compact_every=40,
                        count_kernel=count_kernel)
    idx.seed_state(*ref.export_state())
    back = JaxIndex(engine="jax", window=150, compact_every=40)
    back.seed_state(*idx.export_state())
    for i in range(330, 700, 37):
        for x in (ref, idx, back):
            x.insert_batch(scores[i:i + 37], labels[i:i + 37])
        assert idx._wins2 == ref._wins2 == back._wins2
        assert idx.auc() == ref.auc()
        q = scores[i:i + 5]
        assert np.array_equal(idx.score_batch(q), ref.score_batch(q))
    got, want = idx.export_state(), ref.export_state()
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()
    assert got[2] == want[2] and got[3:] == want[3:]
    for x in (ref, idx, back):
        x.close()


@pytest.mark.parametrize("engine", ["numpy", "torch"])
class TestPrefixParity:
    def test_every_checkpointed_prefix(self, engine):
        scores, labels = make_stream(1500, pos_frac=0.45, seed=7)
        scores = scores.astype(np.float32)
        idx = ExactAucIndex(engine=engine, device="cpu", compact_every=96)
        off = 0
        for c in [1, 2, 7, 50, 96, 97, 200, 500, 777, 1024, 1500]:
            idx.insert_batch(scores[off:c], labels[off:c])
            off = c
            oracle = _oracle(scores[:c], labels[:c])
            if oracle is None:
                assert idx.auc() is None
            else:
                assert idx.auc() == oracle, c
        assert idx.n_compactions > 0

    def test_bit_stable_across_compaction(self, engine):
        scores, labels = _stream(600, seed=11)
        idx = ExactAucIndex(engine=engine, device="cpu",
                            compact_every=10_000)
        idx.insert_batch(scores, labels)
        before = idx.auc()
        assert idx.n_compactions == 0
        idx.compact()
        assert idx.n_compactions > 0
        assert idx.auc() == before

    def test_window_eviction_tracks_tail_oracle(self, engine):
        scores, labels = _stream(1200, seed=5)
        W = 300
        idx = ExactAucIndex(engine=engine, device="cpu", window=W,
                            compact_every=48, count_kernel=True)
        for i in range(0, 1200, 29):
            k = min(i + 29, 1200)
            idx.insert_batch(scores[i:k], labels[i:k])
            oracle = _oracle(scores[max(0, k - W):k], labels[max(0, k - W):k])
            if oracle is not None:
                assert idx.auc() == oracle, k
            assert idx.n_events == min(k, W)
        assert idx.n_evicted == 1200 - W

    def test_window_smaller_than_one_batch(self, engine):
        scores, labels = _stream(400, seed=9)
        idx = ExactAucIndex(engine=engine, device="cpu", window=64)
        idx.insert_batch(scores, labels)
        assert idx.auc() == _oracle(scores[-64:], labels[-64:])
        assert idx.n_events == 64


def test_duplicate_values_and_ties():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, size=600).astype(np.float32)
    labels = rng.random(600) < 0.5
    idx = ExactAucIndex(device="cpu", window=200, compact_every=32,
                        count_kernel=True)
    for i in range(0, 600, 23):
        idx.insert_batch(scores[i:i + 23], labels[i:i + 23])
    assert idx.auc() == _oracle(scores[-200:], labels[-200:])
    pos, neg = idx.oracle_values()
    np.testing.assert_array_equal(pos, np.sort(scores[-200:][labels[-200:]]))
    np.testing.assert_array_equal(neg,
                                  np.sort(scores[-200:][~labels[-200:]]))


def test_score_batch_and_edge_cases():
    idx = ExactAucIndex(device="cpu", count_kernel=True)
    assert idx.auc() is None
    idx.insert_batch([1.0, 2.0], [1, 1])
    assert idx.auc() is None
    assert np.isnan(idx.score_batch([0.5])).all()
    idx.insert_batch([0.0], [0])
    assert idx.auc() == 1.0
    with pytest.raises(ValueError, match="finite"):
        idx.insert_batch([np.nan], [1])
    scores, labels = _stream(500, seed=2)
    idx.insert_batch(scores, labels)
    idx.compact()
    neg = np.sort(np.concatenate([[0.0], scores[~labels]]))
    q = np.asarray([-3.0, 0.0, 3.0], dtype=np.float32)
    lo = np.searchsorted(neg, q, "left")
    want = (lo + 0.5 * (np.searchsorted(neg, q, "right") - lo)) / len(neg)
    np.testing.assert_allclose(idx.score_batch(q), want, rtol=0, atol=0)


def test_crashed_background_build_restarts_and_stays_exact():
    scores, labels = _stream(400, seed=9)
    bg = ExactAucIndex(device="cpu", compact_every=32, window=150,
                       bg_compact=True, count_kernel=True)
    sync = ExactAucIndex(device="cpu", compact_every=32, window=150)
    fired = threading.Event()

    def hook(side):
        if not fired.is_set():
            fired.set()
            raise RuntimeError("injected build failure")
    bg._bg_test_hook = hook
    for i in range(0, 400, 25):
        bg.insert_batch(scores[i:i + 25], labels[i:i + 25])
        sync.insert_batch(scores[i:i + 25], labels[i:i + 25])
        assert bg._wins2 == sync._wins2, i
    bg.wait_idle(timeout=10.0)
    assert fired.is_set() and "injected" in bg.last_compactor_error
    assert bg.metrics.snapshot()["bg_compactor_restarts"]["value"] >= 1
    for a, b in zip(bg.oracle_values(), sync.oracle_values()):
        np.testing.assert_array_equal(a, b)
    bg.close()
    bg.close()


@pytest.mark.parametrize("n,m,grid", [(5000, 1024, False), (500, 200, True),
                                      (50, 50, True), (1, 1, False)])
def test_remove_sorted_equals_jax(n, m, grid):
    """The vectorised tombstone removal equals the JAX index's loop,
    duplicates included (each copy takes the next slot of its run)."""
    from tuplewise_tpu.serving.index import _remove_sorted as jax_remove
    from tuplewise_tpu_torch.serving.index import _remove_sorted

    rng = np.random.default_rng(n)
    arr = rng.standard_normal(n).astype(np.float32)
    arr = np.sort(np.round(arr) if grid else arr)
    vals = rng.choice(arr, m, replace=False).tolist()
    got = _remove_sorted(arr, vals)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_remove(arr, vals))
    assert _remove_sorted(arr, []) is arr
    with pytest.raises(RuntimeError, match="not present"):
        _remove_sorted(arr, [float(arr.max()) + 1.0])


def test_unported_options_raise():
    # shards and chaos are ported: their checks
    with pytest.raises(ValueError, match="engine='torch'"):
        ExactAucIndex(engine="numpy", shards=2)
    with pytest.raises(ValueError, match="shards must be"):
        ExactAucIndex(device="cpu", shards=0)
    assert ExactAucIndex(device="cpu", shards=2).state()["shards"] == 2
    with pytest.raises(NotImplementedError, match="tracing"):
        ExactAucIndex(device="cpu", tracer=object())
    with pytest.raises(ValueError, match="engine"):
        ExactAucIndex(engine="jax", device="cpu")
    state = ExactAucIndex(engine="numpy").state()
    assert state["device"] is None and state["shards"] is None
