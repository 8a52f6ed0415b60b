"""The port's multi-process launch (parallel.distributed), case for case
with tests/test_distributed.py and the bring-up cases of
tests/test_preemption.py: four gloo CPU processes, brought up by the
TUPLEWISE_DIST_* flags over a ``file://`` store, form a (2, 2)
``global_mesh`` of DistComm workers whose estimates equal the worker
axis (LocalComm) of the same (2, 2) shape bit for bit: the same blocks,
the same per-worker sums and one all-reduce in worker order.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tuplewise_tpu_torch import Estimator
from tuplewise_tpu_torch.parallel import distributed
from tuplewise_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
from tuplewise_tpu_torch.parallel.distributed import initialize, global_mesh

assert initialize(device="cpu", init_method=sys.argv[1])
mesh = global_mesh(device="cpu")
assert mesh.distributed and mesh.axis_names == ("dcn", "w")
sys.path.insert(0, {tests!r})
from test_torch_distributed import estimates

out = estimates(mesh)
out["shape"] = list(mesh.shape)
out["rank"] = dist.get_rank()
print("RESULT", json.dumps(out), flush=True)
dist.barrier()          # no rank tears down while a peer still talks
dist.destroy_process_group()
"""


def estimates(mesh):
    """The values both the processes and the worker axis compute."""
    rng = np.random.default_rng(0)
    s1 = (rng.normal(size=203) + 0.5).astype(np.float32)
    s2 = rng.normal(size=157).astype(np.float32)
    X = rng.normal(size=(37, 3)).astype(np.float32)
    Y = (rng.normal(size=(29, 3)) + 0.3).astype(np.float32)
    out = {}
    for name in ("auc", "hinge"):
        e = Estimator(name, backend="mesh", mesh=mesh, device="cpu")
        out[name] = e.complete(s1, s2)
        out[name + "_full"] = e.complete(s1[:200], s2[:156])
        out[name + "_local"] = e.local_average(s1, s2, seed=2,
                                               dropped_workers=(1,))
        out[name + "_rep"] = e.repartitioned(s1, s2, n_rounds=3, seed=1)
        out[name + "_swr"] = e.incomplete(s1, s2, n_pairs=300, seed=1)
        out[name + "_swor"] = e.incomplete(s1, s2, n_pairs=300, seed=1,
                                           design="swor")
    for name in ("triplet_indicator", "scatter"):
        e = Estimator(name, backend="mesh", mesh=mesh, device="cpu")
        args = (X, Y) if name != "scatter" else (X,)
        out[name] = e.complete(*args)
        out[name + "_rep"] = e.repartitioned(*args, n_rounds=2, seed=4)
    return out


def test_four_gloo_processes_equal_the_worker_axis(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO,
                                     tests=os.path.join(REPO, "tests")))
    store = f"file://{tmp_path / 'store'}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TUPLEWISE_DIST_", "LOCAL_"))}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), store], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(env, TUPLEWISE_DIST_NUM_PROCESSES="4",
                 TUPLEWISE_DIST_PROCESS_ID=str(r),
                 TUPLEWISE_DIST_LOCAL_SIZE="2", OMP_NUM_THREADS="1"))
        for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    recs = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        recs.append(json.loads(line[0][len("RESULT "):]))
    assert sorted(r["rank"] for r in recs) == [0, 1, 2, 3]
    assert all(r["shape"] == [2, 2] for r in recs)
    # every rank holds the same all-reduced values
    for r in recs[1:]:
        assert r == {**recs[0], "rank": r["rank"]}
    want = estimates(make_mesh_2d(2, 2, device="cpu"))
    got = recs[0]
    for key in ("auc", "auc_full", "auc_rep", "auc_local",
                "triplet_indicator"):
        assert got[key] == want[key], key            # bit for bit
    assert abs(got["hinge"] - want["hinge"]) <= 1e-12 * abs(want["hinge"])
    # the draws are the worker axis's draws: every estimate agrees
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-12 * abs(want[key]), key


def test_one_rank_group_equals_one_worker(tmp_path):
    """A one-rank gloo group in this process: DistComm's complete value
    equals the worker axis of N = 1 (the card's one-rank NCCL check in
    chip_smoke.py, on the CPU)."""
    import torch.distributed as dist

    assert distributed.initialize(
        num_processes=1, process_id=0, device="cpu",
        init_method=f"file://{tmp_path / 'store'}")
    try:
        mesh = make_mesh(distributed=True, device="cpu")
        assert mesh.distributed and mesh.shape == (1,)
        assert distributed.global_mesh(3, device="cpu").shape == (3,)
        rng = np.random.default_rng(1)
        s1, s2 = rng.normal(size=(2, 99)).astype(np.float32)
        for name in ("auc", "hinge"):
            got = Estimator(name, backend="mesh", mesh=mesh,
                            device="cpu").complete(s1, s2)
            want = Estimator(name, backend="mesh", n_workers=1,
                             device="cpu").complete(s1, s2)
            assert got == want
        with pytest.raises(ValueError, match="gloo group runs on cpu"):
            make_mesh(distributed=True, device="cuda")
    finally:
        dist.destroy_process_group()


class TestFlagGating:
    def test_noop_without_flags(self, monkeypatch):
        for k in list(os.environ):
            if k.startswith("TUPLEWISE_DIST_"):
                monkeypatch.delenv(k)
        assert distributed.initialize() is False

    @pytest.mark.parametrize("present", [
        "TUPLEWISE_DIST_COORDINATOR", "TUPLEWISE_DIST_PROCESS_ID",
    ])
    def test_partial_flags_raise(self, monkeypatch, present):
        """ANY lone flag is a launch-config error, never a silent
        single-process fallback."""
        for k in ("TUPLEWISE_DIST_COORDINATOR",
                  "TUPLEWISE_DIST_NUM_PROCESSES",
                  "TUPLEWISE_DIST_PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv(
            present, "localhost:1" if "COORD" in present else "0")
        with pytest.raises(ValueError, match="needs coordinator"):
            distributed.initialize(device="cpu")

    def test_single_process_mesh_is_local(self):
        mesh = distributed.global_mesh(8, device="cpu")
        assert mesh.n_workers == 8 and not mesh.distributed
        assert mesh.axis_names == ("w",)

    def test_dist_env_reads_the_three_flags(self, monkeypatch):
        monkeypatch.setenv("TUPLEWISE_DIST_COORDINATOR", "h:7")
        monkeypatch.setenv("TUPLEWISE_DIST_NUM_PROCESSES", "4")
        monkeypatch.setenv("TUPLEWISE_DIST_PROCESS_ID", "2")
        assert distributed.dist_env() == {
            "coordinator": "h:7", "num_processes": 4, "process_id": 2}


class TestDistInitRetry:
    def test_bring_up_retries_then_succeeds(self, monkeypatch):
        import torch.distributed as dist

        calls = []

        def fake_init(backend, **kw):
            calls.append((backend, kw))
            if len(calls) == 1:
                raise RuntimeError("coordinator not up yet")

        monkeypatch.setattr(dist, "init_process_group", fake_init)
        ok = distributed.initialize(
            coordinator_address="localhost:1", num_processes=1,
            process_id=0, retries=2, retry_backoff_s=0.0, device="cpu")
        assert ok and len(calls) == 2
        assert calls[0] == ("gloo", {"init_method": "tcp://localhost:1",
                                     "world_size": 1, "rank": 0})

    def test_bring_up_surfaces_the_error_past_its_retries(self,
                                                          monkeypatch):
        import torch.distributed as dist

        def fake_init(backend, **kw):
            raise RuntimeError("coordinator not up yet")

        monkeypatch.setattr(dist, "init_process_group", fake_init)
        with pytest.raises(RuntimeError, match="not up yet"):
            distributed.initialize(
                coordinator_address="localhost:1", num_processes=1,
                process_id=0, retries=1, retry_backoff_s=0.0, device="cpu")

    def test_chaos_hook_fires(self, monkeypatch):
        import torch.distributed as dist

        from tuplewise_tpu.testing.chaos import FaultInjector

        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: None)
        inj = FaultInjector.from_spec({"faults": [
            {"point": "dist_init", "on_call": 1, "action": "error"}]})
        ok = distributed.initialize(
            coordinator_address="localhost:1", num_processes=1,
            process_id=0, retries=1, retry_backoff_s=0.0, chaos=inj,
            device="cpu")
        assert ok and inj.snapshot()["fired"] == {"dist_init": 1}

    def test_card_is_the_default_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.initialize(coordinator_address="localhost:1",
                                   num_processes=1, process_id=0)


def test_backoff_is_the_reference_backoff():
    from tuplewise_tpu.parallel.self_heal import Backoff as JaxBackoff
    from tuplewise_tpu_torch.parallel.self_heal import Backoff

    a, b = Backoff(0.1, 2.0, seed=3), JaxBackoff(0.1, 2.0, seed=3)
    assert [a.delay_s(k) for k in range(1, 8)] == [
        b.delay_s(k) for k in range(1, 8)]
    with pytest.raises(ValueError):
        Backoff(jitter=2.0)
