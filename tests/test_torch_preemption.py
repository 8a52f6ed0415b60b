"""Preemption tolerance of the port's batch path, case for case with
tests/test_preemption.py:54-317.

1. The healer (parallel.self_heal.MeshHealer): bounded jittered backoff,
   probe -> fixed-width reshard over the pool's spare slots, retry bounds,
   the loud HealExhaustedError when the pool runs dry, the shrink policy;
   on a distributed mesh a declared drop is exhausted at once.
2. A worker lost mid-run is healed at the same logical width and the
   numbers do not move: the trainers' final params and loss histories,
   the harness's mean and variance (mesh and single-device) and the
   Estimator's value equal the fault-free run's bit for bit, because
   every draw folds (step or rep, logical worker) and never a slot. The
   recovery counters equal the reference's for the same schedule.
3. A sweep cut at a checkpoint resumes bit for bit (config 4's classes).
The CLI-driven SIGKILL cases (tests/test_preemption.py:412-446) wait for
the port's CLI.
"""

import dataclasses

import numpy as np
import pytest

from tuplewise_tpu.models import pairwise_sgd as J
from tuplewise_tpu.models import scorers as JS
from tuplewise_tpu.parallel.self_heal import Backoff as JBackoff
from tuplewise_tpu.testing.chaos import FaultInjector as JFaultInjector
from tuplewise_tpu_torch import Estimator
from tuplewise_tpu_torch.data import make_gaussians
from tuplewise_tpu_torch.harness.triplet_experiment import (
    triplet_mnist_statistic,
)
from tuplewise_tpu_torch.harness.variance import (
    VarianceConfig, run_variance_experiment,
)
from tuplewise_tpu_torch.models.pairwise_sgd import TrainConfig, train_pairwise
from tuplewise_tpu_torch.models.scorers import LinearScorer
from tuplewise_tpu_torch.models.triplet_sgd import (
    TripletTrainConfig, init_embed, train_triplet,
)
from tuplewise_tpu_torch.obs.flight import FlightRecorder
from tuplewise_tpu_torch.parallel.mesh import make_mesh
from tuplewise_tpu_torch.parallel.self_heal import (
    Backoff, HealExhaustedError, MeshHealer,
)
from tuplewise_tpu_torch.testing import FaultInjector, InjectedDeviceError
from tuplewise_tpu_torch.utils.profiling import MetricsRegistry


def _fast():
    return Backoff(base_s=0.0, cap_s=0.0, jitter=0.0)


def _drop_spec(point, on_call, dropped, cls=FaultInjector):
    return cls.from_spec({"faults": [
        {"point": point, "on_call": on_call, "action": "error",
         "dropped": list(dropped)}]})


class TestBackoff:
    def test_grows_and_caps(self):
        b = Backoff(base_s=0.1, cap_s=0.5, jitter=0.0)
        assert b.delay_s(1) == pytest.approx(0.1)
        assert b.delay_s(2) == pytest.approx(0.2)
        assert b.delay_s(5) == pytest.approx(0.5)     # capped

    def test_jitter_bounded_seeded_and_the_reference_s(self):
        a = [Backoff(base_s=0.1, jitter=0.5, seed=7).delay_s(1)
             for _ in range(3)]
        assert a == [JBackoff(base_s=0.1, jitter=0.5, seed=7).delay_s(1)
                     for _ in range(3)]
        for d in a:
            assert 0.1 <= d <= 0.15

    def test_rejects_bad_args(self):
        with pytest.raises(ValueError):
            Backoff(jitter=2.0)
        with pytest.raises(ValueError):
            Backoff().delay_s(0)


class TestMeshHealer:
    def test_retry_only_bound(self):
        """mesh=None degrades to retry-with-backoff; the bound surfaces
        the original error, retries are counted."""
        h = MeshHealer(None, backoff=_fast())
        calls = []

        def boom():
            calls.append(1)
            raise RuntimeError("persistent")

        with pytest.raises(RuntimeError, match="persistent"):
            h.run(boom, retries=2)
        assert len(calls) == 3
        assert h.retries_total == 2 and h.reshard_events == 0

    def test_fixed_width_backfills_from_pool(self):
        mesh = make_mesh(2, device="cpu")
        assert mesh.pool == tuple(range(8))       # 6 spare slots
        inj = _drop_spec("estimator", 1, [1])
        flight, metrics = FlightRecorder(), MetricsRegistry()
        h = MeshHealer(mesh, fixed_width=2, pool=mesh.pool, chaos=inj,
                       backoff=_fast(), flight=flight, metrics=metrics)
        healed, n_calls = [], [0]

        def flaky():
            n_calls[0] += 1
            inj.fire("estimator")
            return 42

        out = h.run(flaky, retries=2,
                    on_heal=lambda hh: healed.append(hh.mesh.slots))
        assert out == 42 and n_calls[0] == 2
        assert h.n_workers == 2 and h.reshard_events == 1
        # the dead slot 1 was replaced by a spare; the shape is kept
        assert healed == [(0, 2)] and h.mesh.shape == (2,)
        assert 1 not in h.mesh.pool
        snap = metrics.snapshot()
        assert snap["reshard_events"]["value"] == 1
        assert snap["shard_retries_total"]["value"] == 1
        assert snap["recovery_time_s"]["count"] == 1
        ev = flight.events("heal")[0]
        assert ev["mesh_changed"] and ev["mesh_width"] == 2

    def test_pool_exhaustion_is_loud(self):
        # the pool is the mesh's own slots: losing one cannot sustain
        # width 2 -> loud HealExhaustedError, no silent narrowing
        inj = _drop_spec("estimator", 1, [0])
        h = MeshHealer(make_mesh(2, device="cpu"), fixed_width=2, chaos=inj,
                       backoff=_fast())

        def flaky():
            inj.fire("estimator")
            return 0

        with pytest.raises(HealExhaustedError, match="resume"):
            h.run(flaky, retries=3)

    def test_shrink_policy_drops_to_survivors_and_resize(self):
        inj = _drop_spec("estimator", 1, [0])
        h = MeshHealer(make_mesh(2, device="cpu"), chaos=inj,
                       backoff=_fast())

        def flaky():
            inj.fire("estimator")
            return 1

        assert h.run(flaky, retries=1) == 1
        assert h.n_workers == 1 and h.mesh.slots == (1,)  # serving policy
        assert not h.resize(1) and not h.resize(3)
        fixed = MeshHealer(make_mesh(4, device="cpu"), fixed_width=4)
        assert not fixed.resize(2)
        h2 = MeshHealer(make_mesh(4, device="cpu"), pool=range(8))
        assert h2.resize(6) and h2.mesh.slots == tuple(range(6))
        assert h2.resize(2) and h2.n_workers == 2 and h2.reshard_events == 2

    def test_fixed_width_needs_a_mesh_of_that_width(self):
        with pytest.raises(ValueError, match="needs a mesh"):
            MeshHealer(None, fixed_width=2)
        with pytest.raises(ValueError, match="fixed_width=3"):
            MeshHealer(make_mesh(2, device="cpu"), fixed_width=3)
        with pytest.raises(NotImplementedError, match="tracing"):
            MeshHealer(None, tracer=object())

    def test_healthy_probe_retries_on_the_same_mesh(self):
        """A failure with no declared drop: the real probe finds every
        worker healthy, the mesh is kept and the retry succeeds."""
        mesh = make_mesh(4, device="cpu")
        h = MeshHealer(mesh, fixed_width=4, pool=mesh.pool, backoff=_fast())
        state = {"n": 0}

        def once():
            state["n"] += 1
            if state["n"] == 1:
                raise RuntimeError("transient")
            return "ok"

        assert h.run(once, retries=1) == "ok"
        assert h.mesh is mesh and h.retries_total == 1

    def test_distributed_mesh_policies(self, tmp_path):
        """A one-rank gloo group: a declared drop cannot be backfilled
        inside the process (HealExhaustedError at once), a failure with
        no drop retries on the same group, and the shrink policy (ported
        with the mesh form of serving) has no survivor to shrink to."""
        import torch.distributed as dist

        from tuplewise_tpu_torch.parallel import distributed

        assert distributed.initialize(
            num_processes=1, process_id=0, device="cpu",
            init_method=f"file://{tmp_path / 'store'}")
        try:
            mesh = make_mesh(distributed=True, device="cpu")
            assert mesh.slots == mesh.pool == (0,)
            shrink = MeshHealer(mesh, chaos=_drop_spec("estimator", 1, [0]),
                                backoff=_fast())
            with pytest.raises(HealExhaustedError, match="every mesh"):
                shrink.run(lambda: shrink.chaos.fire("estimator"))
            inj = _drop_spec("estimator", 1, [0])
            h = MeshHealer(mesh, fixed_width=1, chaos=inj, backoff=_fast())

            def flaky():
                inj.fire("estimator")
                return 0

            with pytest.raises(HealExhaustedError, match="rank cannot"):
                h.run(flaky, retries=3)
            inj = FaultInjector.from_spec({"faults": [
                {"point": "estimator", "on_call": 1, "action": "error"}]})
            h = MeshHealer(mesh, fixed_width=1, chaos=inj, backoff=_fast())
            assert h.run(flaky, retries=1) == 0 and h.mesh is mesh
        finally:
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def train_data():
    return make_gaussians(128, 128, dim=4, separation=1.0, seed=0)


class TestElasticTraining:
    def test_pairwise_device_loss_bit_identical(self, train_data, tmp_path):
        Xp, Xn = train_data
        scorer = LinearScorer(dim=4)
        cfg = TrainConfig(kernel="logistic", lr=0.2, steps=10, n_workers=2,
                          repartition_every=4, tile=32)
        ref_p, ref_h = train_pairwise(scorer, scorer.init(0), Xp, Xn, cfg,
                                      device="cpu")
        assert ref_h["recovery"]["retries_total"] == 0
        inj = _drop_spec("train_step", 2, [1])
        metrics = MetricsRegistry()
        p, h = train_pairwise(
            scorer, scorer.init(0), Xp, Xn, cfg, chaos=inj,
            checkpoint_path=str(tmp_path / "p.npz"), checkpoint_every=4,
            retry_backoff_s=0.001, metrics=metrics, device="cpu")
        for k in ref_p:
            assert p[k].tobytes() == ref_p[k].tobytes()
        assert h["loss"].tobytes() == ref_h["loss"].tobytes()
        assert h["recovery"] == {"resumed_from": 0, "reshard_events": 1,
                                 "retries_total": 1, "mesh_workers": 2}
        snap = metrics.snapshot()
        assert snap["train_step"]["value"] == 10
        assert snap["mesh_width"]["value"] == 2
        assert snap["train_chunk_s"]["count"] == 3
        assert snap["train_loss_last"]["value"] == float(h["loss"][-1])
        # the reference's counters for the same schedule
        js = JS.LinearScorer(dim=4)
        _, jh = J.train_pairwise(
            js, js.init(0), Xp, Xn, J.TrainConfig(**dataclasses.asdict(cfg)),
            chaos=_drop_spec("train_step", 2, [1], JFaultInjector),
            checkpoint_path=str(tmp_path / "j.npz"), checkpoint_every=4,
            retry_backoff_s=0.001)
        assert jh["recovery"] == h["recovery"]

    def test_triplet_device_loss_bit_identical(self, train_data):
        Xc, Xo = train_data
        cfg = TripletTrainConfig(steps=8, n_workers=2,
                                 triplets_per_worker=256,
                                 repartition_every=4)
        ref_p, ref_h = train_triplet(init_embed(4, 3, 0), Xc, Xo, cfg,
                                     device="cpu")
        inj = _drop_spec("train_step", 1, [0])
        p, h = train_triplet(init_embed(4, 3, 0), Xc, Xo, cfg, chaos=inj,
                             retry_backoff_s=0.001, device="cpu")
        assert p["W"].tobytes() == ref_p["W"].tobytes()
        assert h["loss"].tobytes() == ref_h["loss"].tobytes()
        assert h["recovery"]["reshard_events"] >= 1
        assert h["recovery"]["mesh_workers"] == 2

    def test_exhausted_pool_raises_not_narrows(self, train_data):
        """make_mesh(8) has no spare slot: a lost worker must fail
        loudly (resume-from-checkpoint territory), never continue at a
        different logical width."""
        Xp, Xn = train_data
        scorer = LinearScorer(dim=4)
        cfg = TrainConfig(kernel="logistic", steps=4, n_workers=8,
                          repartition_every=2, tile=32)
        inj = FaultInjector.from_spec({"faults": [
            {"point": "train_step", "on_call": k, "action": "error",
             "dropped": [1]} for k in (1, 2)]})
        with pytest.raises(HealExhaustedError):
            train_pairwise(scorer, scorer.init(0), Xp, Xn, cfg, chaos=inj,
                           retry_backoff_s=0.001, device="cpu")

    def test_spare_slots_keep_width_eight(self, train_data):
        Xp, Xn = train_data
        scorer = LinearScorer(dim=4)
        cfg = TrainConfig(kernel="hinge", lr=0.3, steps=6, n_workers=8,
                          repartition_every=2, loss_every=2)
        ref_p, ref_h = train_pairwise(scorer, scorer.init(0), Xp, Xn, cfg,
                                      device="cpu")
        p, h = train_pairwise(
            scorer, scorer.init(0), Xp, Xn, cfg,
            mesh=make_mesh(8, device="cpu", pool=12),
            chaos=_drop_spec("train_step", 1, [3]), retry_backoff_s=0.001)
        assert p["w"].tobytes() == ref_p["w"].tobytes()
        assert h["loss"].tobytes() == ref_h["loss"].tobytes()
        assert h["recovery"]["mesh_workers"] == 8

    def test_checkpoint_hook_fires_after_each_save(self, train_data,
                                                   tmp_path):
        Xp, Xn = train_data
        scorer = LinearScorer(dim=4)
        cfg = TrainConfig(kernel="hinge", steps=6, n_workers=2)
        path = str(tmp_path / "c.npz")
        inj = FaultInjector.from_spec({"faults": [
            {"point": "checkpoint", "on_call": 2, "action": "error"}]})
        with pytest.raises(Exception, match="checkpoint"):
            train_pairwise(scorer, scorer.init(0), Xp, Xn, cfg,
                           checkpoint_path=path, checkpoint_every=2,
                           chaos=inj, device="cpu")
        p, h = train_pairwise(scorer, scorer.init(0), Xp, Xn, cfg,
                              checkpoint_path=path, checkpoint_every=2,
                              device="cpu")
        ref_p, _ = train_pairwise(scorer, scorer.init(0), Xp, Xn, cfg,
                                  device="cpu")
        assert h["recovery"]["resumed_from"] == 4
        assert p["w"].tobytes() == ref_p["w"].tobytes()


class TestElasticMonteCarlo:
    CFG = VarianceConfig(kernel="auc", scheme="local", backend="mesh",
                         n_pos=256, n_neg=256, n_workers=2, n_reps=8,
                         seed=3)

    def test_device_loss_mid_sweep_bit_identical(self, tmp_path):
        """One worker lost mid-sweep: the sweep heals onto a spare slot
        and completes; the mean and variance equal the fault-free run's
        bit for bit; the record says so."""
        ref = run_variance_experiment(self.CFG, device="cpu")
        inj = _drop_spec("mesh_mc", 2, [1])
        res = run_variance_experiment(
            self.CFG, chaos=inj, checkpoint_path=str(tmp_path / "v.npz"),
            checkpoint_every=3, device="cpu")
        assert res["mean"] == ref["mean"]
        assert res["variance"] == ref["variance"]
        assert res["recovery"]["reshard_events"] >= 1
        assert res["recovery"]["retries_total"] == 1
        assert res["recovery"]["mesh_workers"] == 2
        assert res["recovery"]["chaos"]["fired"] == {"mesh_mc": 1}
        assert ref["recovery"]["retries_total"] == 0

    @pytest.mark.parametrize("scheme", ["complete", "repartitioned",
                                        "incomplete"])
    def test_every_scheme_heals_bit_identical(self, scheme):
        cfg = dataclasses.replace(self.CFG, scheme=scheme, n_rounds=2,
                                  n_pairs=500, n_pos=203, n_neg=157,
                                  n_workers=4, n_reps=70)
        ref = run_variance_experiment(cfg, device="cpu")
        inj = FaultInjector.from_spec({"faults": [
            {"point": "mesh_mc", "on_call": 2, "action": "error",
             "dropped": [0, 3]},
            {"point": "mc_chunk", "on_call": 1, "action": "error"}]})
        res = run_variance_experiment(cfg, chaos=inj, checkpoint_every=40,
                                      device="cpu")
        assert (res["mean"], res["variance"]) == (ref["mean"],
                                                  ref["variance"])
        assert res["recovery"]["retries_total"] == 2

    def test_nonmesh_backend_shares_retry_discipline(self):
        cfg = dataclasses.replace(self.CFG, backend="torch",
                                  scheme="incomplete", n_pairs=200)
        ref = run_variance_experiment(cfg, device="cpu")
        inj = FaultInjector.from_spec({"faults": [
            {"point": "mc_chunk", "on_call": 1, "action": "error"}]})
        res = run_variance_experiment(cfg, chaos=inj, device="cpu")
        assert res["mean"] == ref["mean"]
        assert res["recovery"]["retries_total"] == 1
        assert res["recovery"]["reshard_events"] == 0
        assert res["recovery"]["mesh_workers"] is None

    @pytest.mark.parametrize("dropped", [[1], []])
    def test_estimator_level_heal(self, dropped):
        """Estimator(heal_retries=...) on a mesh: a failed scheme call
        (a worker dropped, or none) heals at the same worker count and
        returns the bit-identical value."""
        rng = np.random.default_rng(0)
        s1 = rng.standard_normal(128) + 1.0
        s2 = rng.standard_normal(128)
        ref = Estimator("auc", backend="mesh", n_workers=2,
                        device="cpu").complete(s1, s2)
        inj = _drop_spec("estimator", 1, dropped)
        est = Estimator("auc", backend="mesh", n_workers=2, device="cpu",
                        heal_retries=2, chaos=inj)
        assert est.complete(s1, s2) == ref
        assert est._healer.reshard_events == 1
        assert est._healer.retries_total == 1
        assert est.backend.n_shards == 2
        assert est.backend.mesh.slots == ((0, 2) if dropped else (0, 1))

    def test_estimator_heal_keeps_options_and_schemes(self):
        rng = np.random.default_rng(1)
        s1, s2 = rng.standard_normal(300) + 0.5, rng.standard_normal(290)
        ref = Estimator("hinge", backend="mesh", n_workers=4, device="cpu",
                        impl="plain")
        inj = FaultInjector.from_spec({"faults": [
            {"point": "estimator", "on_call": k, "action": "error",
             "dropped": [k // 2]} for k in (1, 3, 5, 7)]})
        est = Estimator("hinge", backend="mesh", n_workers=4, device="cpu",
                        impl="plain", heal_retries=1, chaos=inj)
        assert est.complete(s1, s2) == ref.complete(s1, s2)
        assert est.local_average(s1, s2, seed=3) == ref.local_average(
            s1, s2, seed=3)
        assert est.repartitioned(s1, s2, n_rounds=2, seed=1) == \
            ref.repartitioned(s1, s2, n_rounds=2, seed=1)
        assert est.incomplete(s1, s2, n_pairs=400, seed=2) == \
            ref.incomplete(s1, s2, n_pairs=400, seed=2)
        # worker w's slot is lost at the w-th call: each heal takes the
        # pool's next spare
        assert est.backend.impl == "plain"
        assert est.backend.mesh.slots == est.backend.mesh.pool == (1, 3, 5,
                                                                    7)
        assert est._healer.retries_total == 4

    def test_single_device_estimator_retries(self):
        rng = np.random.default_rng(2)
        s1, s2 = rng.standard_normal(100), rng.standard_normal(90)
        inj = FaultInjector.from_spec({"faults": [
            {"point": "estimator", "on_call": 1, "action": "error"}]})
        est = Estimator("auc", device="cpu", heal_retries=1, chaos=inj)
        assert est.complete(s1, s2) == Estimator(
            "auc", device="cpu").complete(s1, s2)
        assert est._healer.retries_total == 1 and est._healer.mesh is None

    def test_retry_bound_surfaces_persistent_failure(self):
        inj = FaultInjector.from_spec({"faults": [
            {"point": "mc_chunk", "on_call": k, "action": "error"}
            for k in range(1, 6)]})
        cfg = dataclasses.replace(self.CFG, backend="torch",
                                  scheme="incomplete", n_pairs=100, n_reps=2)
        with pytest.raises(InjectedDeviceError):
            run_variance_experiment(cfg, chaos=inj, heal_retries=2,
                                    device="cpu")
        assert inj.snapshot()["calls"]["mc_chunk"] == 3

    def test_exhausted_mesh_sweep_raises(self):
        cfg = dataclasses.replace(self.CFG, n_workers=8)
        with pytest.raises(HealExhaustedError):
            run_variance_experiment(cfg, chaos=_drop_spec("mesh_mc", 1, [5]),
                                    device="cpu")


class TestTripletExperimentResume:
    def test_per_class_resume_bit_identical(self, tmp_path):
        kw = dict(n=300, n_pairs=500, seed=1, device="cpu")
        ref = triplet_mnist_statistic(**kw)
        p = str(tmp_path / "t.npz")
        # interrupt after 3 classes: in-process the injector raises at the
        # checkpoint hook
        inj = FaultInjector.from_spec({"faults": [
            {"point": "checkpoint", "on_call": 3, "action": "error"}]})
        with pytest.raises(Exception, match="checkpoint"):
            triplet_mnist_statistic(checkpoint_path=p, chaos=inj, **kw)
        res = triplet_mnist_statistic(checkpoint_path=p, **kw)
        assert res["recovery"]["resumed_from"] == 3
        assert res["per_class"] == ref["per_class"]
        assert res["mean"] == ref["mean"]
