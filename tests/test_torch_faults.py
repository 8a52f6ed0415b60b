"""Drop-and-renormalize and failure detection of the port
(parallel.faults), case for case with tests/test_faults.py.

* ``sample_failures`` makes the JAX package's numpy draws: equal bit for
  bit for every (seed, N, p).
* A dropped-worker local average equals the survivors' mean of the
  per-worker values, on the reference's own partition and per-worker
  values (auc counts: equal within 1e-12, float64 means of the same
  exact fractions).
* The collective probe is an all-reduce of ones through the mesh's
  communicator; a hung collective reports unhealthy and a hung worker
  probe reports that worker dropped, within the probe's bound, never
  hanging the caller. On a distributed mesh a failed collective leaves
  every other rank unknown: the detector raises.
"""

import time

import numpy as np
import pytest

from tuplewise_tpu.backends.numpy_backend import NumpyBackend
from tuplewise_tpu.ops.kernels import auc_kernel
from tuplewise_tpu.parallel import faults as jfaults
from tuplewise_tpu.parallel.partition import partition_two_sample
from tuplewise_tpu_torch import Estimator
from tuplewise_tpu_torch.backends.torch_backend import TorchBackend
from tuplewise_tpu_torch.data import make_gaussians
from tuplewise_tpu_torch.parallel import faults
from tuplewise_tpu_torch.parallel.faults import (
    alive_mask, check_mesh_health, detect_dropped_workers,
    normalize_dropped, run_with_fault_tolerance, sample_failures, survivors,
)
from tuplewise_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d


@pytest.fixture(scope="module")
def scores():
    X, Y = make_gaussians(1600, 1600, dim=1, separation=1.0, seed=3)
    return X[:, 0].astype(np.float32), Y[:, 0].astype(np.float32)


def _mesh_est(**kw):
    return Estimator("auc", backend="mesh", device="cpu", **kw)


class TestFaultHelpers:
    def test_normalize_and_mask(self):
        assert normalize_dropped([3, 1, 1], 4) == (1, 3)
        assert alive_mask(4, (1, 3)).tolist() == [1.0, 0.0, 1.0, 0.0]
        assert survivors(4, (1, 3)) == (0, 2)

    def test_cannot_drop_all(self):
        with pytest.raises(ValueError, match="cannot drop all"):
            normalize_dropped(range(4), 4)

    def test_out_of_range(self):
        with pytest.raises(ValueError, match="out of range"):
            normalize_dropped([4], 4)

    def test_sample_failures_leaves_survivor(self):
        for seed in range(20):
            assert len(sample_failures(seed, 4, 0.9)) < 4
        with pytest.raises(ValueError, match="p_fail"):
            sample_failures(0, 4, 1.0)

    def test_sample_failures_rate(self):
        counts = [len(sample_failures(s, 16, 0.25)) for s in range(200)]
        assert 2.0 < np.mean(counts) < 6.0  # E = 4

    @pytest.mark.parametrize("n_workers,p_fail", [(4, 0.9), (16, 0.25),
                                                  (8, 0.5), (1, 0.7)])
    def test_sample_failures_equal_reference(self, n_workers, p_fail):
        for seed in range(50):
            assert sample_failures(seed, n_workers, p_fail) == \
                jfaults.sample_failures(seed, n_workers, p_fail)


class TestDropRenormalize:
    @pytest.mark.parametrize("dropped", [(1, 2), (0,), (3,)])
    def test_equals_the_reference_survivor_mean(self, scores, dropped):
        """The reference's partition and per-worker values: the port's
        renormalized round equals their survivors' mean."""
        s1, s2 = scores
        be = NumpyBackend(auc_kernel)
        rng = np.random.default_rng(11)
        pi, ni = partition_two_sample(len(s1), len(s2), 4, rng, "swor")
        per_worker = []
        for w in range(4):
            s, c = be._pair_stats(s1[pi[w]].astype(np.float64),
                                  s2[ni[w]].astype(np.float64))
            per_worker.append(s / c)
        want = np.mean([per_worker[w] for w in survivors(4, dropped)])
        got = float(TorchBackend("auc", device="cpu").local_round_from_blocks(
            s1, s2, np.stack(pi), np.stack(ni), alive_mask(4, dropped)))
        assert abs(got - want) < 1e-12

    def test_unbiased_under_failures(self, scores):
        s1, s2 = scores
        est = _mesh_est(n_workers=8)
        u_n = est.complete(s1, s2)
        vals = [est.local_average(s1, s2, seed=m, dropped_workers=(0, 5))
                for m in range(30)]
        se = np.std(vals) / np.sqrt(len(vals)) + 1e-6
        assert abs(np.mean(vals) - u_n) < 5 * se

    def test_repartitioned_with_failures(self, scores):
        s1, s2 = scores
        est = _mesh_est(n_workers=8)
        u_n = est.complete(s1, s2)
        vals = [est.repartitioned(s1, s2, n_rounds=3, seed=m,
                                  dropped_workers=(3,)) for m in range(20)]
        se = np.std(vals) / np.sqrt(len(vals)) + 1e-6
        assert abs(np.mean(vals) - u_n) < 5 * se

    def test_dropped_changes_value_but_not_shape(self, scores):
        s1, s2 = scores
        est = _mesh_est(n_workers=4)
        assert est.local_average(s1, s2, seed=0) != est.local_average(
            s1, s2, seed=0, dropped_workers=(2,))

    def test_drop_renormalize_on_2d_mesh(self):
        """The alive mask indexes the row-major worker id: the (2, 4)
        mesh's renormalized local average equals the 1-D one."""
        X, Y = make_gaussians(512, 512, dim=1, separation=1.0, seed=3)
        s1, s2 = X[:, 0], Y[:, 0]
        flat = _mesh_est(n_workers=8)
        hier = _mesh_est(mesh=make_mesh_2d(2, 4, device="cpu"))
        for dropped in ((), (3,), (0, 6)):
            assert flat.local_average(s1, s2, seed=5,
                                      dropped_workers=dropped) == \
                hier.local_average(s1, s2, seed=5, dropped_workers=dropped)


class TestHealthProbes:
    @pytest.mark.parametrize("mesh", [
        lambda: make_mesh(8, device="cpu"),
        lambda: make_mesh_2d(2, 4, device="cpu"),
        lambda: make_mesh(1, device="cpu"),
    ])
    def test_health_check(self, mesh):
        # every axis of a 2-D mesh at once: summing one axis would count
        # 2 or 4 workers, not 8
        m = mesh()
        assert check_mesh_health(m)
        assert check_mesh_health(m, timeout_s=5.0)
        assert detect_dropped_workers(m) == ()

    def test_hung_collective_reports_unhealthy(self, monkeypatch):
        monkeypatch.setattr(faults, "_collective_probe",
                            lambda mesh: time.sleep(60))
        t0 = time.monotonic()
        assert check_mesh_health(make_mesh(1, device="cpu"),
                                 timeout_s=0.2) is False
        assert time.monotonic() - t0 < 5.0

    def test_hung_worker_counted_dropped(self, monkeypatch):
        monkeypatch.setattr(faults, "_collective_probe", lambda mesh: False)

        def probe(mesh, worker):
            if worker == 1:
                time.sleep(60)
            return True

        monkeypatch.setattr(faults, "_device_probe", probe)
        t0 = time.monotonic()
        assert detect_dropped_workers(make_mesh(2, device="cpu"),
                                      timeout_s=0.2) == (1,)
        assert time.monotonic() - t0 < 5.0

    def test_raising_collective_falls_back_to_worker_probes(
            self, monkeypatch):
        def dead(mesh):
            raise RuntimeError("collective died")

        monkeypatch.setattr(faults, "_collective_probe", dead)
        monkeypatch.setattr(faults, "_device_probe",
                            lambda mesh, w: w not in (2, 5))
        assert detect_dropped_workers(make_mesh(8, device="cpu")) == (2, 5)
        monkeypatch.setattr(faults, "_device_probe", lambda mesh, w: False)
        with pytest.raises(RuntimeError, match="all 8 workers"):
            detect_dropped_workers(make_mesh(8, device="cpu"))

    def test_distributed_mesh_does_not_guess(self, tmp_path, monkeypatch):
        """A one-rank gloo group: a failed collective raises with the
        reason instead of reporting a dropped set."""
        import torch.distributed as dist

        from tuplewise_tpu_torch.parallel import distributed

        assert distributed.initialize(
            num_processes=1, process_id=0, device="cpu",
            init_method=f"file://{tmp_path / 'store'}")
        try:
            mesh = make_mesh(distributed=True, device="cpu")
            assert check_mesh_health(mesh, timeout_s=10.0)
            assert detect_dropped_workers(mesh) == ()
            monkeypatch.setattr(faults, "_collective_probe",
                                lambda mesh: False)
            with pytest.raises(RuntimeError, match="own device"):
                detect_dropped_workers(mesh)
        finally:
            dist.destroy_process_group()

    def test_no_timeout_keeps_sync_path(self):
        assert check_mesh_health(make_mesh(1, device="cpu"))


class TestEndToEndFaultTolerance:
    def test_healthy_mesh_no_drops(self, scores):
        s1, s2 = scores
        est = _mesh_est(n_workers=8)
        assert run_with_fault_tolerance(est, "local", s1, s2, seed=0) == \
            est.local_average(s1, s2, seed=0)

    def test_injected_failure_survives(self, scores, monkeypatch):
        """A dead worker: the collective probe reports unhealthy and the
        probe of worker 3 raises. One call returns the drop-and-
        renormalize value for dropped={3}."""
        s1, s2 = scores
        est = _mesh_est(n_workers=8)
        monkeypatch.setattr(faults, "check_mesh_health",
                            lambda mesh, timeout_s=None: False)

        def probe(mesh, w):
            if w == 3:
                raise RuntimeError("injected dead worker")
            return True

        monkeypatch.setattr(faults, "_device_probe", probe)
        v = run_with_fault_tolerance(est, "repartitioned", s1, s2,
                                     n_rounds=2, seed=0)
        monkeypatch.undo()
        assert v == est.repartitioned(s1, s2, n_rounds=2, seed=0,
                                      dropped_workers=(3,))

    @pytest.mark.parametrize("backend", ["torch", "mesh"])
    def test_rejects_complete_scheme(self, scores, backend):
        s1, s2 = scores
        est = Estimator("auc", backend=backend, n_workers=4, device="cpu")
        with pytest.raises(ValueError, match="schemes"):
            run_with_fault_tolerance(est, "complete", s1, s2)

    def test_single_device_backend_detector_default(self, scores):
        """The single-device backend defaults to a no-failure detector."""
        s1, s2 = scores
        est = Estimator("auc", n_workers=4, device="cpu")
        assert run_with_fault_tolerance(est, "local", s1, s2, seed=1) == \
            est.local_average(s1, s2, seed=1)

    def test_custom_detector(self, scores):
        s1, s2 = scores
        est = _mesh_est(n_workers=4)
        got = run_with_fault_tolerance(est, "local", s1, s2, seed=2,
                                       detector=lambda: [2, 2, 0])
        assert got == est.local_average(s1, s2, seed=2,
                                        dropped_workers=(0, 2))


def test_probe_thread_is_a_daemon(monkeypatch):
    """A probe abandoned past its deadline must not keep the process
    alive: it runs on a daemon thread."""
    import threading

    seen = {}

    def slow():
        seen["daemon"] = threading.current_thread().daemon
        time.sleep(0.5)

    with pytest.raises(faults.ProbeTimeout):
        faults._run_bounded(slow, 0.05)
    assert seen["daemon"] is True
    assert faults._run_bounded(lambda: 7, 1.0) == 7
    with pytest.raises(KeyError):
        faults._run_bounded(lambda: {}["x"], 1.0)
