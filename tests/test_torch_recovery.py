"""Crash-safe recovery of the port's single-tenant engine: snapshots and
the write-ahead log (``serving/recovery.py``), held against the JAX
package.

The mirror of ``tests/test_chaos_serving.py::TestCrashRecovery`` and
``TestDeltaRecovery``: an engine abandoned (daemon threads, no close) or
SIGKILLed mid-stream recovers from its snapshot and WAL tail, and wins2
and every later AUC equal the JAX package's uninterrupted
``ExactAucIndex`` bit for bit (the integers are the same; the float32
index against the JAX float32 one, the float64 ``numpy`` engine against
the JAX numpy one). The SIGKILL legs start the port's serving child
(``tuplewise_tpu_torch/testing/serve_child.py``)
with ``python -c``, each with its own timeout.

Format parity: the two packages' engines, fed the same stream one
request a batch at the same ``snapshot_every``, write equal WAL records
and snapshots with the same keys and equal arrays, and config blocks
equal except ``engine``.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from tuplewise_tpu.serving import ExactAucIndex as JaxIndex
from tuplewise_tpu.serving import MicroBatchEngine as JaxEngine
from tuplewise_tpu.serving import ServingConfig as JaxConfig
from tuplewise_tpu.serving.recovery import EventLog as JaxEventLog
from tuplewise_tpu_torch.serving import (
    MicroBatchEngine, ServingConfig, make_stream,
)
from tuplewise_tpu_torch.serving.recovery import (
    SNAPSHOT_FILE, WAL_FILE, EventLog,
)
from tuplewise_tpu_torch.testing import FaultInjector
from tuplewise_tpu_torch.utils.checkpoint import load_checkpoint

T = 10.0    # seconds any future may wait
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _stream(n, seed=7):
    return make_stream(n, pos_frac=0.45, separation=1.0, seed=seed)


def _cfg(**kw):
    kw.setdefault("engine", "numpy")
    return ServingConfig(device="cpu", policy="block", **kw)


def _ref(scores, labels, engine="numpy", **kw):
    """The JAX package's index over the same events: the reference."""
    idx = JaxIndex(engine=engine, compact_every=64, **kw)
    if len(scores):
        idx.insert_batch(scores, labels)
    return idx


def _abandon(eng):
    """A crash in miniature: park the batcher, no close(), no final
    snapshot; the WAL was flushed a batch, the last snapshot may be
    stale."""
    eng._closed = True
    eng._worker.join(timeout=T)


def run_child(spec: dict, lines, n_ack: int, rest, timeout=180):
    """Start the serving child, send ``lines[:n_ack]``, wait for every
    acknowledgement (so the WAL provably holds them), SIGKILL it, then
    restart it with ``recover=True`` on ``rest`` and return its replies."""
    code = ("import sys; from tuplewise_tpu_torch.testing.serve_child "
            "import main; main(sys.argv[1])")
    env = dict(os.environ, PYTHONPATH=REPO)

    def start(sp):
        return subprocess.Popen(
            [sys.executable, "-c", code, json.dumps(sp)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env, cwd=REPO)

    p1 = start(spec)
    try:
        for ln in lines[:n_ack]:
            p1.stdin.write(ln + "\n")
        p1.stdin.flush()
        for _ in range(n_ack):
            assert json.loads(p1.stdout.readline())["ok"]
    finally:
        os.kill(p1.pid, signal.SIGKILL)
        p1.wait(timeout=30)
    spec2 = dict(spec, config=dict(spec["config"], recover=True))
    p2 = start(spec2)
    try:
        out, _ = p2.communicate("\n".join(rest) + "\n", timeout=timeout)
    finally:
        if p2.poll() is None:
            p2.kill()
            p2.wait(timeout=30)
    resp = [json.loads(ln) for ln in out.strip().splitlines()]
    assert all(r["ok"] for r in resp)
    return resp


def _insert_lines(scores, labels, tenants=None):
    return [json.dumps(dict({"op": "insert", "score": float(s),
                             "label": int(b)},
                            **({} if tenants is None
                               else {"tenant": str(tenants[k])})))
            for k, (s, b) in enumerate(zip(scores, labels))]


class TestCrashRecovery:
    @pytest.mark.parametrize("engine,count_kernel,jax_engine", [
        ("numpy", False, "numpy"),
        ("torch", True, "jax"),
    ])
    def test_recover_resumes_bit_identical(self, tmp_path, engine,
                                           count_kernel, jax_engine):
        """Abandon an engine mid-stream, recover from its snapshot and
        WAL, continue: every later prefix equals the uninterrupted JAX
        index bit for bit (the float32 index with the count kernel's
        plain version on the CPU)."""
        d = str(tmp_path / "reco")
        scores, labels = _stream(1400, seed=5)
        kw = dict(engine=engine, count_kernel=count_kernel,
                  snapshot_dir=d, snapshot_every=300, compact_every=64)
        eng = MicroBatchEngine(_cfg(**kw))
        for i in range(0, 700, 7):
            eng.insert(scores[i:i + 7], labels[i:i + 7])
        eng.flush()
        _abandon(eng)

        eng2 = MicroBatchEngine(_cfg(recover=True, **kw))
        assert eng2._recovery.seq == 700
        dt = np.float32 if engine == "torch" else np.float64
        ref = _ref(scores[:700].astype(dt), labels[:700], jax_engine)
        assert eng2.index._wins2 == ref._wins2
        for i in range(700, 1400, 11):
            j = min(i + 11, 1400)
            eng2.insert(scores[i:j], labels[i:j]).result(T)
            eng2.flush()
            ref.insert_batch(scores[i:j].astype(dt), labels[i:j])
            assert eng2.index._wins2 == ref._wins2, i
            assert eng2.index.auc() == ref.auc(), i
        # the incomplete-U estimator recovered too (sums, reservoirs and
        # the RNG state round-trip through the snapshot)
        assert eng2.streaming.n_arrivals == 1400
        eng2.close()

    def test_last_recovery_accounts_for_the_tail(self, tmp_path):
        """The manager's ``last_recovery`` names the snapshot it
        restored, and the records and events it replayed after it: the
        WAL's own count of the records at or past the snapshot's seq."""
        d = str(tmp_path / "acct")
        scores, labels = _stream(700, seed=7)
        kw = dict(snapshot_dir=d, snapshot_every=256, compact_every=64)
        eng = MicroBatchEngine(_cfg(**kw))
        for i in range(0, 700, 7):
            eng.insert(scores[i:i + 7], labels[i:i + 7]).result(T)
        _abandon(eng)
        eng._recovery._drain_writer()
        snap = load_checkpoint(os.path.join(d, SNAPSHOT_FILE))["step"]
        tail = [r for r in EventLog.replay_all_records(
            os.path.join(d, WAL_FILE)) if int(r["seq"]) >= snap]
        assert 0 < snap < 700 and tail
        eng2 = MicroBatchEngine(_cfg(recover=True, **kw))
        got = eng2._recovery.last_recovery
        assert got["snapshot_seq"] == snap and got["seq"] == 700
        assert got["records"] == len(tail)
        assert got["events"] == sum(len(r["s"]) for r in tail) == 700 - snap
        assert got["restore_s"] >= 0 and got["replay_s"] >= 0
        eng2.close()
        fresh = MicroBatchEngine(_cfg(snapshot_dir=str(tmp_path / "new")))
        assert fresh._recovery.last_recovery is None
        fresh.close()

    def test_recover_rejects_mismatched_config(self, tmp_path):
        d = str(tmp_path / "reco2")
        scores, labels = _stream(100, seed=2)
        eng = MicroBatchEngine(_cfg(snapshot_dir=d, snapshot_every=50))
        eng.insert(scores, labels).result(T)
        eng.flush()
        eng.close()     # graceful: final snapshot
        with pytest.raises(ValueError, match="config mismatch"):
            MicroBatchEngine(_cfg(snapshot_dir=d, window=10, recover=True))

    def test_inserts_proceed_during_slow_snapshot(self, tmp_path):
        """Snapshot writes run on a side thread behind an atomic capture:
        while a stuck write is in flight, inserts keep completing."""
        d = str(tmp_path / "slow")
        scores, labels = _stream(400, seed=31)
        kw = dict(snapshot_dir=d, snapshot_every=50, compact_every=32)
        eng = MicroBatchEngine(_cfg(**kw))
        gate = threading.Event()
        started = threading.Event()

        def stall(seq):
            started.set()
            assert gate.wait(timeout=20.0)
        eng._recovery._write_test_hook = stall
        for i in range(0, 60, 6):       # cross the snapshot threshold
            eng.insert(scores[i:i + 6], labels[i:i + 6]).result(T)
        eng.flush()
        assert started.wait(timeout=T), "snapshot capture never ran"
        for i in range(60, 360, 6):
            assert eng.insert(scores[i:i + 6],
                              labels[i:i + 6]).result(T) == 6
        assert not gate.is_set()
        assert eng.flush()["index"]["n_events"] == 360
        gate.set()
        eng.close()
        eng2 = MicroBatchEngine(_cfg(recover=True, **kw))
        assert eng2.index._wins2 == _ref(scores[:360], labels[:360])._wins2
        eng2.close()

    def test_crash_with_stuck_writer_loses_nothing(self, tmp_path):
        """A crash while the writer is stuck: the sealed segment and the
        live WAL replay every admitted event."""
        d = str(tmp_path / "stuck")
        scores, labels = _stream(300, seed=33)
        kw = dict(snapshot_dir=d, snapshot_every=80, compact_every=32)
        eng = MicroBatchEngine(_cfg(**kw))
        eng._recovery._write_test_hook = (
            lambda seq: threading.Event().wait(60.0))   # wedged
        for i in range(0, 300, 5):
            eng.insert(scores[i:i + 5], labels[i:i + 5]).result(T)
        eng.flush()
        _abandon(eng)
        assert EventLog.segments(os.path.join(d, WAL_FILE))
        eng2 = MicroBatchEngine(_cfg(recover=True, **kw))
        assert eng2._recovery.seq == 300
        assert eng2.index._wins2 == _ref(scores, labels)._wins2
        eng2.close()

    def test_wal_fsync_batch_mode_round_trips(self, tmp_path):
        """``wal_fsync="batch"`` changes durability only."""
        d = str(tmp_path / "fs")
        scores, labels = _stream(200, seed=37)
        kw = dict(snapshot_dir=d, snapshot_every=1000, wal_fsync="batch")
        eng = MicroBatchEngine(_cfg(**kw))
        assert eng._recovery._wal.fsync
        eng.insert(scores, labels).result(T)
        eng.flush()
        _abandon(eng)       # everything lives in the fsync'd WAL
        eng2 = MicroBatchEngine(_cfg(recover=True, **kw))
        assert eng2.index._wins2 == _ref(scores, labels)._wins2
        eng2.close()

    def test_wal_fsync_validated(self):
        with pytest.raises(ValueError, match="wal_fsync"):
            ServingConfig(wal_fsync="always")
        with pytest.raises(ValueError, match="wal_fsync"):
            JaxConfig(wal_fsync="always")

    def test_sigkill_mid_stream_recovers(self, tmp_path):
        """SIGKILL a serving process after 350 acknowledged inserts,
        restart it with recover, finish the stream with a query every 50
        events: every queried prefix equals the JAX index's."""
        scores, labels = _stream(600, seed=13)
        lines = _insert_lines(scores, labels)
        spec = {"config": dict(device="cpu", engine="numpy",
                               policy="block",
                               snapshot_dir=str(tmp_path / "rk"),
                               snapshot_every=100, compact_every=64)}
        feed, prefixes = [], []
        for k in range(350, 600):
            feed.append(lines[k])
            if (k + 1) % 50 == 0:
                feed.append(json.dumps({"op": "query"}))
                prefixes.append(k + 1)
        resp = run_child(spec, lines, 350, feed)
        aucs = [r["auc_exact"] for r in resp if "auc_exact" in r]
        assert len(aucs) == len(prefixes) == 5
        for prefix, got in zip(prefixes, aucs):
            assert got == _ref(scores[:prefix], labels[:prefix]).auc()


class TestDeltaRecovery:
    """The sharded index (S = 2 workers on the CPU) recovers mid-delta:
    its snapshot holds a delta run and a tombstone multiset."""

    _KW = dict(engine="torch", mesh_shards=2, compact_every=64, window=500,
               delta_fraction=4.0, max_delta_runs=64, snapshot_every=300)

    def test_snapshot_restores_mid_delta_state(self, tmp_path):
        d = str(tmp_path / "delta_reco")
        scores, labels = _stream(1200, seed=11)
        eng = MicroBatchEngine(_cfg(snapshot_dir=d, **self._KW))
        for i in range(0, 700, 7):
            eng.insert(scores[i:i + 7], labels[i:i + 7]).result(T)
        snap = eng.flush()
        assert snap["index"]["delta_events"] > 0
        assert snap["index"]["tombstones"] > 0
        _abandon(eng)
        ck = load_checkpoint(os.path.join(d, SNAPSHOT_FILE))
        assert any(len(ck["extra"][f"{s}_delta_run"])
                   for s in ("pos", "neg"))
        assert any(len(ck["extra"][f"{s}_tomb_run"])
                   for s in ("pos", "neg"))

        eng2 = MicroBatchEngine(_cfg(snapshot_dir=d, recover=True,
                                     **self._KW))
        assert eng2.index.state()["delta_events"] > 0
        ref = _ref(scores[:700].astype(np.float32), labels[:700], "jax",
                   window=500)
        assert eng2.index._wins2 == ref._wins2
        for i in range(700, 1200, 11):
            j = min(i + 11, 1200)
            eng2.insert(scores[i:j], labels[i:j]).result(T)
            eng2.flush()
            ref.insert_batch(scores[i:j].astype(np.float32), labels[i:j])
            assert eng2.index._wins2 == ref._wins2, i
            assert eng2.index.auc() == ref.auc(), i
        eng2.close()

    def test_snapshot_after_a_heal_restores_at_full_width(self, tmp_path):
        """A snapshot captured after a heal (4 -> 3 workers) holds host
        arrays only, as the reference's does: restored into an engine
        built with mesh_shards=4 it is placed over 4 workers and gives
        the same values."""
        d = str(tmp_path / "healed")
        scores, labels = _stream(900, seed=23)
        kw = dict(self._KW, mesh_shards=4, count_kernel=True)
        drop = FaultInjector.from_spec({"faults": [
            {"point": "sharded_count", "on_call": 3, "action": "error",
             "dropped": [3]}]})
        eng = MicroBatchEngine(_cfg(snapshot_dir=d, **kw), chaos=drop)
        for i in range(0, 600, 6):
            eng.insert(scores[i:i + 6], labels[i:i + 6]).result(T)
        eng.flush()
        assert eng.index.shards == 3
        _abandon(eng)
        eng2 = MicroBatchEngine(_cfg(snapshot_dir=d, recover=True, **kw))
        assert eng2.index.shards == 4
        ref = _ref(scores[:600].astype(np.float32), labels[:600], "jax",
                   window=500)
        assert eng2.index._wins2 == ref._wins2
        for i in range(600, 900, 10):
            eng2.insert(scores[i:i + 10], labels[i:i + 10]).result(T)
            ref.insert_batch(scores[i:i + 10].astype(np.float32),
                             labels[i:i + 10])
            assert eng2.index._wins2 == ref._wins2, i
        eng2.close()

    def test_sigkill_mid_delta_recovers(self, tmp_path):
        scores, labels = _stream(600, seed=13)
        lines = _insert_lines(scores, labels)
        spec = {"config": dict(device="cpu", policy="block",
                               engine="torch", mesh_shards=2,
                               delta_fraction=4.0, max_delta_runs=64,
                               window=400, count_kernel=True,
                               snapshot_dir=str(tmp_path / "delta_rk"),
                               snapshot_every=100, compact_every=64)}
        resp = run_child(spec, lines, 350,
                          lines[350:] + [json.dumps({"op": "query"})])
        ref = _ref(scores.astype(np.float32), labels, "jax", window=400)
        assert resp[-1]["auc_exact"] == ref.auc()


class TestFormatParity:
    """The two packages write the same WAL records and snapshots for one
    stream: one request a batch, so snapshots land at the same seqs."""

    def _run(self, make_engine, d, scores, labels):
        eng = make_engine(d)
        for i in range(0, len(scores), 9):
            eng.insert(scores[i:i + 9], labels[i:i + 9]).result(T)
        eng.flush()
        eng._recovery._drain_writer()
        eng._closed = True
        eng._worker.join(timeout=T)
        recs = list(EventLog.replay_all_records(os.path.join(d, WAL_FILE)))
        return recs, load_checkpoint(os.path.join(d, SNAPSHOT_FILE))

    @pytest.mark.parametrize("engine,jax_engine",
                             [("numpy", "numpy"), ("torch", "jax")])
    def test_wal_and_snapshot_equal_the_reference(self, tmp_path, engine,
                                                  jax_engine):
        scores, labels = _stream(900, seed=17)
        kw = dict(policy="block", window=400, compact_every=64,
                  snapshot_every=250, seed=3)
        recs, ck = self._run(
            lambda d: MicroBatchEngine(ServingConfig(
                device="cpu", engine=engine, snapshot_dir=d, **kw)),
            str(tmp_path / "port"), scores, labels)
        jd = str(tmp_path / "jax")
        jrecs, jck = self._run(
            lambda d: JaxEngine(JaxConfig(engine=jax_engine,
                                          snapshot_dir=d, **kw)),
            jd, scores, labels)
        assert recs == jrecs and len(recs) > 0
        assert recs == list(JaxEventLog.replay_all_records(
            os.path.join(jd, WAL_FILE)))
        assert ck["step"] == jck["step"] > 0
        assert sorted(ck["extra"]) == sorted(jck["extra"])
        for k in ck["extra"]:
            a, b = ck["extra"][k], jck["extra"][k]
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        cfg, jcfg = dict(ck["config"]), dict(jck["config"])
        assert (cfg.pop("engine"), jcfg.pop("engine")) == (engine,
                                                          jax_engine)
        assert cfg == jcfg

    def test_port_recovers_from_the_references_wal(self, tmp_path):
        """The WAL is one format: a JAX engine's log replays into the
        port's engine (same engine kind, no snapshot) bit for bit."""
        d = str(tmp_path / "x")
        scores, labels = _stream(300, seed=19)
        jeng = JaxEngine(JaxConfig(engine="numpy", policy="block",
                                   snapshot_dir=d, snapshot_every=10_000))
        for i in range(0, 300, 10):
            jeng.insert(scores[i:i + 10], labels[i:i + 10]).result(T)
        jeng.flush()
        jeng._closed = True
        jeng._worker.join(timeout=T)
        eng = MicroBatchEngine(_cfg(snapshot_dir=d, snapshot_every=10_000,
                                    recover=True))
        assert eng._recovery.seq == 300
        assert eng.index._wins2 == _ref(scores, labels)._wins2
        eng.close()
