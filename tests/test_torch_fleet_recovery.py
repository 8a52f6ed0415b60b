"""Crash-safe recovery of the port's multi-tenant fleet, held against
the JAX package.

The mirror of ``tests/test_tenancy.py::TestFleetRecovery``,
``tests/test_fleet_incremental.py::TestWhaleRecovery`` and
``tests/test_pallas_counts.py::TestKernelRecovery`` (with
``count_kernel=True``, which takes the kernels' plain versions on the
CPU), plus a mesh fleet (S = 2 workers on the CPU) recovering into its
[S, T, cap] packs. Every recovered tenant's wins2 and AUC equal the JAX
package's uninterrupted ``TenantFleetIndex`` over the same per-tenant
events, bit for bit. The SIGKILL legs start
``tuplewise_tpu_torch/testing/serve_child.py`` through
``test_torch_recovery.run_child``.
"""

import json
import os

import numpy as np
import pytest

from tuplewise_tpu.serving.engine import ServingConfig as JaxConfig
from tuplewise_tpu.serving.tenancy import MultiTenantEngine as JaxEngine
from tuplewise_tpu.serving.tenancy import TenantFleetIndex as JaxFleet
from tuplewise_tpu_torch.serving import (
    ExactAucIndex, MultiTenantEngine, ServingConfig, TenancyConfig,
)
from tuplewise_tpu_torch.serving.recovery import (
    SNAPSHOT_FILE, WAL_FILE, EventLog, RecoveryManager,
)
from tuplewise_tpu_torch.serving.tenancy import (
    FleetRecoveryManager, capture_fleet_snapshot_state,
)
from tuplewise_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_recovery import run_child

T = 10.0


def _cfg(d, **kw):
    return ServingConfig(device="cpu", policy="block", snapshot_dir=str(d),
                         **kw)


def _abandon(eng):
    eng._closed = True
    eng._worker.join(timeout=T)


def _fill(eng, events):
    for t, s, b in events:
        eng.insert(t, s, b).result(T)


def _events(n, seed, tenants=("u0", "u1", "u2"), width=2):
    rng = np.random.default_rng(seed)
    return [(tenants[i % len(tenants)], rng.standard_normal(width),
             rng.random(width) < 0.5) for i in range(n)]


def _jax_wins2(events, **kw):
    """Per-tenant wins2 of the JAX fleet over the same events."""
    ref = JaxFleet(compact_every=kw.pop("compact_every", 512), **kw)
    for t, s, b in events:
        ref.apply_inserts([(t, np.asarray(s, np.float32), b)])
    return {t: ref.wins2(t) for t in ref.tenants()}, ref


class TestFleetRecovery:
    def test_snapshot_roundtrip_bit_identical(self, tmp_path):
        cfg = _cfg(tmp_path / "d", window=100, compact_every=32,
                   snapshot_every=90)
        events = _events(240, 21)
        with MultiTenantEngine(cfg) as eng:
            _fill(eng, events)
            eng.flush()
            ref = {t: (eng.fleet.wins2(t),
                       eng.tenant_stats(t)["estimate_incomplete"])
                   for t in eng.fleet.tenants()}
        with MultiTenantEngine(cfg, recover=True) as eng2:
            got = {t: (eng2.fleet.wins2(t),
                       eng2.tenant_stats(t)["estimate_incomplete"])
                   for t in eng2.fleet.tenants()}
        assert ref == got
        want, _ = _jax_wins2(events, window=100, compact_every=32)
        assert {t: w for t, (w, _) in got.items()} == want

    def test_crash_recovers_from_wal_tail(self, tmp_path):
        """Abandon the engine without a close: the snapshot and the
        tenant-tagged WAL tail rebuild every tenant bit for bit."""
        cfg = _cfg(tmp_path / "d", compact_every=16, snapshot_every=100)
        events = _events(170, 22)
        eng = MultiTenantEngine(cfg)
        _fill(eng, events)
        eng.flush()
        ref = {t: eng.fleet.wins2(t) for t in eng.fleet.tenants()}
        _abandon(eng)
        with MultiTenantEngine(cfg, recover=True) as eng2:
            got = {t: eng2.fleet.wins2(t) for t in eng2.fleet.tenants()}
            # the recovered fleet keeps serving exactly
            eng2.insert("u0", 0.25, 1).result(T)
            more = eng2.fleet.wins2("u0")
        assert ref == got == _jax_wins2(events, compact_every=16)[0]
        want, _ = _jax_wins2(events + [("u0", [0.25], [True])],
                             compact_every=16)
        assert more == want["u0"]

    def test_wal_records_carry_tenant(self, tmp_path):
        cfg = _cfg(tmp_path / "d", snapshot_every=10_000)
        with MultiTenantEngine(cfg) as eng:
            eng.insert("alpha", 1.0, 1).result(T)
            eng.insert("beta", 0.5, 0).result(T)
            eng.flush()
            recs = list(EventLog.replay_all_records(
                str(tmp_path / "d" / WAL_FILE)))
        assert {r.get("t") for r in recs} == {"alpha", "beta"}

    def test_capture_includes_every_tenant(self, tmp_path):
        cfg = _cfg(tmp_path / "d", snapshot_every=10_000)
        with MultiTenantEngine(cfg) as eng:
            _fill(eng, _events(60, 23))
            eng.flush()
            extra, meta = capture_fleet_snapshot_state(eng)
            assert sorted(meta["tenants"]) == ["u0", "u1", "u2"]
            assert len(meta["wins2"]) == 3
            for i in range(3):
                assert f"t{i}_pos_base" in extra
                assert f"t{i}_rpos_items" in extra

    def test_snapshot_keys_equal_the_reference(self, tmp_path):
        """The fleet snapshot has the JAX package's layout: the same
        keys, equal arrays and an equal manifest, for the same stream."""
        events = _events(120, 24)
        kw = dict(policy="block", window=80, compact_every=16,
                  snapshot_every=10_000)
        with MultiTenantEngine(ServingConfig(
                device="cpu", snapshot_dir=str(tmp_path / "p"),
                **kw)) as eng:
            _fill(eng, events)
        with JaxEngine(JaxConfig(snapshot_dir=str(tmp_path / "j"),
                                 **kw)) as jeng:
            _fill(jeng, events)
        ck = load_checkpoint(str(tmp_path / "p" / SNAPSHOT_FILE))
        jck = load_checkpoint(str(tmp_path / "j" / SNAPSHOT_FILE))
        assert ck["step"] == jck["step"] == 240
        assert sorted(ck["extra"]) == sorted(jck["extra"])
        for k in ck["extra"]:
            np.testing.assert_array_equal(ck["extra"][k], jck["extra"][k],
                                          err_msg=k)
        assert ck["config"] == jck["config"]

    def test_sigkill_fleet_recovers(self, tmp_path):
        """SIGKILL a fleet serving process after 150 acknowledged
        inserts, recover, finish: every tenant's final AUC equals the
        uninterrupted JAX fleet's."""
        rng = np.random.default_rng(31)
        events = [(f"u{i % 2}", float(rng.standard_normal()
                                      + 0.8 * (i % 3 == 0)),
                   int(i % 3 == 0)) for i in range(240)]
        lines = [json.dumps({"op": "insert", "tenant": t, "score": s,
                             "label": b}) for t, s, b in events]
        spec = {"config": dict(device="cpu", policy="block",
                               snapshot_dir=str(tmp_path / "rk"),
                               snapshot_every=60, compact_every=32),
                "tenancy": {"max_tenants": 8}}
        feed = lines[150:] + [json.dumps({"op": "query", "tenant": t})
                              for t in ("u0", "u1")]
        resp = run_child(spec, lines, 150, feed)
        got = {r["tenant"]: r["auc_exact"] for r in resp
               if "auc_exact" in r}
        ref = JaxFleet(compact_every=32)
        for t, s, b in events:
            ref.apply_inserts([(t, [s], [b])])
        assert got == {"u0": ref.auc("u0"), "u1": ref.auc("u1")}

    def test_manager_is_subclass_seam(self, tmp_path):
        assert isinstance(FleetRecoveryManager(str(tmp_path / "x")),
                          RecoveryManager)


class TestWhaleRecovery:
    def test_snapshot_roundtrip_preserves_promotion(self, tmp_path):
        cfg = _cfg(tmp_path / "d", compact_every=16, snapshot_every=60)
        ten = TenancyConfig(whale_threshold=80)
        rng = np.random.default_rng(15)
        events = []
        for _ in range(70):
            events.append(("w", rng.standard_normal(2),
                            rng.random(2) < 0.5))
            events.append(("s", rng.standard_normal(1),
                           rng.random(1) < 0.5))
        with MultiTenantEngine(cfg, ten) as eng:
            _fill(eng, events)
            eng.flush()
            assert eng.fleet.is_whale("w")
            ref = {t: eng.fleet.wins2(t) for t in eng.fleet.tenants()}
        with MultiTenantEngine(cfg, ten, recover=True) as eng2:
            assert eng2.fleet.is_whale("w")
            assert not eng2.fleet.is_whale("s")
            assert isinstance(eng2.fleet._by_tid["w"].idx, ExactAucIndex)
            got = {t: eng2.fleet.wins2(t) for t in eng2.fleet.tenants()}
            # and the recovered whale keeps serving exactly
            eng2.insert("w", 0.5, 1).result(T)
            after = eng2.fleet.wins2("w")
        assert ref == got
        want, jref = _jax_wins2(events + [("w", [0.5], [True])],
                                compact_every=16, whale_threshold=80)
        assert jref.is_whale("w") and after == want["w"]

    def test_wal_tail_replay_re_promotes(self, tmp_path):
        """Crash before any snapshot captured the promotion: the tagged
        WAL tail replays through apply_inserts, which crosses the
        threshold again."""
        cfg = _cfg(tmp_path / "d", compact_every=16,
                   snapshot_every=100_000)
        ten = TenancyConfig(whale_threshold=60)
        events = _events(50, 16, tenants=("w",))
        eng = MultiTenantEngine(cfg, ten)
        _fill(eng, events)
        eng.flush()
        assert eng.fleet.is_whale("w")
        ref = eng.fleet.wins2("w")
        _abandon(eng)
        with MultiTenantEngine(cfg, ten, recover=True) as eng2:
            assert eng2.fleet.is_whale("w")
            assert eng2.fleet.wins2("w") == ref
        want, _ = _jax_wins2(events, compact_every=16, whale_threshold=60)
        assert ref == want["w"]

    def test_sigkill_whale_recovers(self, tmp_path):
        rng = np.random.default_rng(17)
        events = [("whale" if i % 3 else "small",
                   float(rng.standard_normal() + 0.8 * (i % 2)),
                   int(i % 2)) for i in range(240)]
        lines = [json.dumps({"op": "insert", "tenant": t, "score": s,
                             "label": b}) for t, s, b in events]
        spec = {"config": dict(device="cpu", policy="block",
                               snapshot_dir=str(tmp_path / "rk"),
                               snapshot_every=50, compact_every=32),
                "tenancy": {"max_tenants": 8, "whale_threshold": 100}}
        feed = lines[160:] + [json.dumps({"op": "query", "tenant": t})
                              for t in ("whale", "small")] + [
            json.dumps({"op": "tenants"})]
        resp = run_child(spec, lines, 160, feed)
        got = {r["tenant"]: r["auc_exact"] for r in resp
               if "auc_exact" in r}
        assert [r["fleet"] for r in resp if "fleet" in r][-1]["whales"] == 1
        ref = JaxFleet(compact_every=32, whale_threshold=100)
        for t, s, b in events:
            ref.apply_inserts([(t, [s], [b])])
        assert got == {"whale": ref.auc("whale"), "small": ref.auc("small")}


class TestKernelRecovery:
    def test_fleet_snapshot_roundtrip_with_kernel(self, tmp_path):
        cfg = _cfg(tmp_path / "d", window=100, compact_every=32,
                   snapshot_every=90, count_kernel=True)
        events = _events(120, 47)
        with MultiTenantEngine(cfg) as eng:
            _fill(eng, events)
            eng.flush()
            ref = {t: eng.fleet.wins2(t) for t in eng.fleet.tenants()}
        with MultiTenantEngine(cfg, recover=True) as eng2:
            got = {t: eng2.fleet.wins2(t) for t in eng2.fleet.tenants()}
            assert eng2.fleet.count_kernel
        assert ref == got == _jax_wins2(events, window=100,
                                        compact_every=32)[0]

    def test_sigkill_recover_with_kernel(self, tmp_path):
        """SIGKILL a count-kernel index engine on a 2-worker mesh, recover,
        finish: the final AUC equals the JAX index with the kernel off."""
        from tuplewise_tpu.serving import ExactAucIndex as JaxIndex

        rng = np.random.default_rng(53)
        events = [(float(rng.standard_normal() + 0.8 * (i % 3 == 0)),
                   int(i % 3 == 0)) for i in range(200)]
        lines = [json.dumps({"op": "insert", "score": s, "label": b})
                 for s, b in events]
        spec = {"config": dict(device="cpu", policy="block",
                               count_kernel=True, mesh_shards=2,
                               snapshot_dir=str(tmp_path / "rk"),
                               snapshot_every=60, compact_every=32)}
        resp = run_child(spec, lines, 120,
                          lines[120:] + [json.dumps({"op": "query"})])
        ref = JaxIndex(compact_every=32)
        ref.insert_batch(np.asarray([s for s, _ in events], np.float32),
                         np.asarray([b for _, b in events], bool))
        assert resp[-1]["auc_exact"] == ref.auc()


class TestMeshFleetRecovery:
    """A fleet sharded over S = 2 workers recovers into [S, T, cap]
    packs; its tenants equal the JAX fleet's, and the recovered packs
    count on the mesh."""

    @pytest.mark.parametrize("count_kernel", [False, True])
    def test_mesh_fleet_recovers(self, tmp_path, count_kernel):
        kw = dict(window=120, compact_every=16, snapshot_every=70,
                  mesh_shards=2, count_kernel=count_kernel)
        ten = TenancyConfig(whale_threshold=90)
        events = _events(150, 29, tenants=("a", "b", "a", "c"))
        eng = MultiTenantEngine(_cfg(tmp_path / "d", **kw), ten)
        _fill(eng, events[:100])
        eng.flush()
        assert eng.fleet.state()["shards"] == 2
        _abandon(eng)
        with MultiTenantEngine(_cfg(tmp_path / "d", recover=True, **kw),
                               ten) as eng2:
            assert eng2.fleet.state()["shards"] == 2
            _fill(eng2, events[100:])
            eng2.flush()
            got = {t: eng2.fleet.wins2(t) for t in eng2.fleet.tenants()}
            assert eng2.fleet._pos_pack.dev.shape[0] == 2
            assert eng2.fleet.is_whale("a")
        want, jref = _jax_wins2(events, window=120, compact_every=16,
                                whale_threshold=90)
        assert got == want and jref.is_whale("a")
        assert os.path.exists(tmp_path / "d" / "flight.jsonl")
