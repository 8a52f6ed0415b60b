"""The mesh trainers (models.pairwise_sgd.train_pairwise and
models.triplet_sgd.train_triplet with ``mesh=``) on the CPU.

* On the worker axis (``LocalComm``) the trajectory equals today's
  mesh-less engine (``run_chunk`` on the full arrays, the blocks indexed
  from them) bit for bit: the regathered rows are the same rows and the
  step is the same step.
* The reference's trajectory: the JAX package's numpy oracle
  (``train_pairwise_numpy``, float64, analytic gradient) fed the port's
  worker blocks at every repartition boundary is followed within rel
  1e-4 (float32 against float64; today's learner tests' bound).
* Two gloo ranks (``DistComm``, one worker a rank) against the worker
  axis of N = 2: the processes sum their gradient shares in rank order
  where the worker axis sums all rows in one batched backward, so a step
  agrees within the derived bound of :func:`step_bound`, not bit for bit.
  Each step is compared from the same parameters (the worker axis's),
  so the bound needs no amplification over steps. The ranks' own runs
  agree with each other bit for bit, and the mesh Monte-Carlo's auc
  values equal the worker axis's bit for bit (exact counts).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tuplewise_tpu.models import pairwise_sgd as J
from tuplewise_tpu.parallel import partition as jpartition
from tuplewise_tpu_torch.data import make_gaussians
from tuplewise_tpu_torch.models import pairwise_sgd as T
from tuplewise_tpu_torch.models import triplet_sgd as TT
from tuplewise_tpu_torch.models.scorers import LinearScorer
from tuplewise_tpu_torch.obs.tracing import Tracer
from tuplewise_tpu_torch.parallel.device_partition import (
    ShardedRows, draw_blocks,
)
from tuplewise_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from tuplewise_tpu_torch.utils.rng import generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U = 2.0 ** -24          # float32 unit roundoff


@pytest.fixture(scope="module")
def data():
    return make_gaussians(203, 157, dim=4, separation=1.0, seed=0)


def _engine(scorer, cfg, p0, Xp, Xn):
    """Today's mesh-less engine: the S = 1 step engine on the full
    arrays."""
    kernel = T.check_config(cfg)
    p, losses = T.run_chunk(scorer, kernel, cfg, T.replicate(p0, 1, "cpu"),
                            T.to_device_rows(Xp, "cpu"),
                            T.to_device_rows(Xn, "cpu"), [cfg.seed], 0,
                            cfg.steps)
    return {k: v[0].numpy() for k, v in p.items()}, losses[0].numpy()


@pytest.mark.parametrize("kw", [
    dict(kernel="hinge"),
    dict(kernel="hinge", loss_every=3),
    dict(kernel="logistic", loss_every=2),
    dict(kernel="hinge", pairs_per_worker=64, pair_design="swr"),
    dict(kernel="logistic", pairs_per_worker=64, pair_design="swor",
         loss_every=2),
    dict(kernel="hinge", pairs_per_worker=64, pair_design="bernoulli",
         scheme="swr"),
])
@pytest.mark.parametrize("mesh", [(2,), (8,), (2, 4)])
def test_worker_axis_equals_the_meshless_run(data, kw, mesh):
    Xp, Xn = data
    s = LinearScorer(dim=4)
    N = int(np.prod(mesh))
    cfg = T.TrainConfig(lr=0.3, steps=9, n_workers=N, repartition_every=4,
                        seed=3, **kw)
    m = (make_mesh(N, device="cpu") if len(mesh) == 1
         else make_mesh_2d(*mesh, device="cpu"))
    p, h = T.train_pairwise(s, s.init(1), Xp, Xn, cfg, mesh=m)
    want_p, want_loss = _engine(s, cfg, s.init(1), Xp, Xn)
    for k in want_p:
        assert p[k].tobytes() == want_p[k].tobytes(), k
    assert h["loss"].tobytes() == want_loss.tobytes()
    assert h["recovery"]["retries_total"] == 0


@pytest.mark.parametrize("design", ["swr", "swor"])
def test_triplet_worker_axis_equals_the_meshless_run(data, design):
    Xc, Xo = data
    cfg = TT.TripletTrainConfig(steps=7, n_workers=4, repartition_every=3,
                                triplets_per_worker=128, embed_dim=2,
                                triplet_design=design)
    p0 = TT.init_embed(4, 2, 0)
    p, h = TT.train_triplet(p0, Xc, Xo, cfg,
                            mesh=make_mesh(4, device="cpu"))
    kernel = TT.check_config(cfg)
    want, losses = TT.run_chunk(
        TT.default_embedder(p0), kernel, cfg,
        TT.params_to_state(p0, "cpu"), torch.as_tensor(Xc, dtype=torch.float32),
        torch.as_tensor(Xo, dtype=torch.float32), 0, cfg.steps)
    assert p["W"].tobytes() == want["W"].numpy().tobytes()
    assert h["loss"].tobytes() == losses.numpy().tobytes()


def test_sharded_rows_regather_the_rows(data):
    Xp, _ = data
    X = torch.as_tensor(Xp, dtype=torch.float32)
    rows = ShardedRows(X, make_mesh(8, device="cpu"))
    assert rows.shards.shape == (8, 26, 4) and rows.shape == X.shape
    idx = draw_blocks(generator(0, "partition", device="cpu"), 203, 8,
                      batch=(3,))
    assert torch.equal(rows[idx], X[idx])
    assert torch.equal(rows[idx[0]], X[idx[0]])


@pytest.mark.parametrize("kernel", ["logistic", "hinge"])
@pytest.mark.parametrize("n_workers", [2, 4])
def test_follows_the_reference_oracle(data, kernel, n_workers, monkeypatch):
    """The reference's float64 oracle on the port's blocks: its
    partitioner is replaced by one that returns the port's draws at each
    repartition boundary, in order."""
    Xp, Xn = data
    cfg = T.TrainConfig(kernel=kernel, lr=0.5, steps=12,
                        n_workers=n_workers, repartition_every=5, seed=2)
    n1, n2 = len(Xp), len(Xn)
    boundaries = iter(range(0, cfg.steps, cfg.repartition_every))

    def port_blocks(n_pos, n_neg, n_workers, rng, scheme):
        gen = generator(cfg.seed, "repartition", next(boundaries),
                        device="cpu")
        i1 = draw_blocks(gen, n1, n_workers, scheme, m=n1 // n_workers)
        i2 = draw_blocks(gen, n2, n_workers, scheme, m=n2 // n_workers)
        return i1.numpy(), i2.numpy()

    monkeypatch.setattr(jpartition, "partition_two_sample", port_blocks)
    s = LinearScorer(dim=4)
    want, hw = J.train_pairwise_numpy(
        None, s.init(0), Xp, Xn, J.TrainConfig(**{
            k: getattr(cfg, k) for k in ("kernel", "lr", "steps",
                                         "n_workers", "repartition_every",
                                         "seed")}))
    got, hg = T.train_pairwise(s, s.init(0), Xp, Xn, cfg,
                               mesh=make_mesh(n_workers, device="cpu"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(hg["loss"], hw["loss"], rtol=1e-4)


def test_mesh_must_match_the_config(data, tmp_path):
    Xp, Xn = data
    s = LinearScorer(dim=4)
    with pytest.raises(ValueError, match="conflicts"):
        T.train_pairwise(s, None, Xp, Xn, T.TrainConfig(n_workers=4),
                         mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="conflicts"):
        TT.train_triplet(TT.init_embed(4, 2), Xp, Xn,
                         TT.TripletTrainConfig(n_workers=2),
                         mesh=make_mesh(2, device="cpu"), device="cuda")
    with pytest.raises(TypeError, match="Tracer"):
        T.train_pairwise(s, None, Xp, Xn, T.TrainConfig(steps=1),
                         tracer=object(), device="cpu")
    # tracing is ported: the run is a span, each chunk and save its child
    tr = Tracer()
    T.train_pairwise(s, None, Xp, Xn, T.TrainConfig(steps=2, n_workers=2),
                     checkpoint_path=str(tmp_path / "ck.npz"),
                     checkpoint_every=1, tracer=tr, device="cpu")
    spans = tr.spans()
    run = [x for x in spans if x["name"] == "train.run"]
    kids = [x["name"] for x in spans
            if x["parent_id"] == run[0]["span_id"]]
    assert len(run) == 1 and kids == ["train.chunk", "train.checkpoint"] * 2


# --------------------------------------------------------------------- #
# two gloo ranks against the worker axis                                #
# --------------------------------------------------------------------- #

CFG = dict(kernel="logistic", lr=0.3, steps=6, n_workers=2,
           repartition_every=3, seed=5)
MC = dict(backend="mesh", n_workers=2, n_reps=5, seed=1)


def _gamma(k):
    return k * U / (1 - k * U)


def step_bound(Xp, Xn, p, p_next, cfg):
    """The largest difference one logistic step may show between the
    worker axis and the ranks, from the same parameters p (per
    parameter, the shape of p_next).

    Both forms take the same per-pair terms; they differ in grouping:
    (i) the gradient of w is a sum over the N (m1 + m2) block rows of
    c_r x_rk, |c_r| <= 1 / (N m), in one float32 sum on the worker axis
    and in m1 + m2 a rank plus a float64 sum of the N partials across
    ranks: each within gamma_K sum|terms| of the exact sum, and
    sum|terms| <= A_k = max|x_k| + max|y_k|; (ii) each form's row and
    column sums of g' (|g'| <= 1) within gamma_max(m1, m2); (iii) a score
    is a float32 dot of d terms plus b in either form, within
    (gamma_d + u) S of exact (S = max over rows of sum_k |x_k w_k| + |b|),
    so a difference d moves by at most 4 (gamma_d + 2u) S between the
    forms and g' by a quarter of that (|g''| <= 1/4); (iv) the scalings
    by 1/(m1 m2) and 1/N round (4u). The update w - lr g then moves by
    lr times that, plus the roundings of lr g and the subtraction in each
    form: 2u (lr A + |w'|). The bias's gradient is a difference of the
    same row and column sums: the same bound with A = 2."""
    N, lr, d = cfg.n_workers, cfg.lr, Xp.shape[1]
    m1, m2 = len(Xp) // N, len(Xn) // N
    w, b = p["w"].astype(np.float64), float(p["b"])
    S = max(np.abs(Xp).dot(np.abs(w)).max(),
            np.abs(Xn).dot(np.abs(w)).max()) + abs(b)
    dd = 4 * (_gamma(d) + 2 * U) * S
    rel = (_gamma(N * (m1 + m2)) + _gamma(m1 + m2) + U
           + 2 * _gamma(max(m1, m2)) + 4 * U + dd / 4)
    out = {}
    for k, A in (("w", np.abs(Xp).max(0) + np.abs(Xn).max(0)),
                 ("b", np.asarray(2.0))):
        out[k] = lr * rel * A + 2 * U * (lr * A + np.abs(p_next[k]))
    return out


def loss_bound(loss, cfg, n1, n2):
    """The per-step loss: each worker's pair mean of m1 m2 terms (each
    form within gamma_{m1 m2} of exact, and a score shift moves a term
    by at most dd, g' <= 1), then the mean of N such: rel
    2 gamma_{m1 m2} + 2 gamma_N + 4u of the loss."""
    N = cfg.n_workers
    m = (n1 // N) * (n2 // N)
    return (2 * _gamma(m) + 2 * _gamma(N) + 4 * U) * abs(loss)


_WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import torch.distributed as dist
from tuplewise_tpu_torch.parallel.distributed import initialize
from tuplewise_tpu_torch.parallel.mesh import make_mesh
from test_torch_mesh_trainers import distributed_run

assert initialize(device="cpu", init_method=sys.argv[1])
out = distributed_run(make_mesh(distributed=True, device="cpu"), sys.argv[2])
out["rank"] = dist.get_rank()
print("RESULT", json.dumps(out), flush=True)
dist.barrier()          # no rank tears down while a peer still talks
dist.destroy_process_group()
"""


def distributed_run(mesh, forced_path):
    """What each rank computes: one step from each of the worker axis's
    parameters (``forced_path``), its own free run (and the same run
    with a fault that declares no dropped worker), a triplet run, the
    mesh Monte-Carlo's values, and the healer's answer to a declared
    drop."""
    from tuplewise_tpu_torch.harness import mesh_mc
    from tuplewise_tpu_torch.harness.variance import VarianceConfig
    from tuplewise_tpu_torch.parallel.self_heal import HealExhaustedError
    from tuplewise_tpu_torch.testing import FaultInjector

    Xp, Xn = make_gaussians(203, 157, dim=4, separation=1.0, seed=0)
    s = LinearScorer(dim=4)
    cfg = T.TrainConfig(**CFG)
    kernel = T.check_config(cfg)
    forced = np.load(forced_path)
    rows = (ShardedRows(T.to_device_rows(Xp, "cpu"), mesh),
            ShardedRows(T.to_device_rows(Xn, "cpu"), mesh))
    steps, losses = [], []
    for t in range(cfg.steps):
        p = T.replicate({k: forced[f"{k}{t}"] for k in ("w", "b")}, 1, "cpu")
        p, loss = T.run_chunk(s, kernel, cfg, p, *rows, [cfg.seed], t, 1,
                              comm=mesh.comm)
        steps.append({k: v[0].tolist() for k, v in p.items()})
        losses.append(float(loss[0, 0]))
    free_p, free_h = T.train_pairwise(s, s.init(0), Xp, Xn, cfg, mesh=mesh)
    chaos = FaultInjector.from_spec({"faults": [
        {"point": "train_step", "on_call": 1, "action": "error"}]})
    heal_p, heal_h = T.train_pairwise(s, s.init(0), Xp, Xn, cfg, mesh=mesh,
                                      chaos=chaos, retry_backoff_s=0.001)
    drop = FaultInjector.from_spec({"faults": [
        {"point": "train_step", "on_call": 1, "action": "error",
         "dropped": [1]}]})
    try:
        T.train_pairwise(s, s.init(0), Xp, Xn, cfg, mesh=mesh, chaos=drop,
                         retry_backoff_s=0.001)
        exhausted = False
    except HealExhaustedError:
        exhausted = True
    tp, th = TT.train_triplet(
        TT.init_embed(4, 2, 0), Xp, Xn, TT.TripletTrainConfig(
            steps=4, n_workers=2, repartition_every=2,
            triplets_per_worker=64, embed_dim=2), mesh=mesh)
    mc = {}
    for scheme, n in (("complete", (200, 156)), ("complete", (203, 157)),
                      ("local", (203, 157))):
        run = mesh_mc.make_mesh_mc_runner(VarianceConfig(
            scheme=scheme, n_pos=n[0], n_neg=n[1], **MC), mesh=mesh)
        mc[f"{scheme}{n}"] = run(range(60, 65)).tolist()
    return {"steps": steps, "losses": losses,
            "free": {k: v.tolist() for k, v in free_p.items()},
            "free_loss": free_h["loss"].tolist(),
            "healed_equal": all(np.array_equal(heal_p[k], free_p[k])
                                for k in free_p),
            "healed_retries": heal_h["recovery"]["retries_total"],
            "exhausted": exhausted, "triplet": tp["W"].tolist(),
            "triplet_loss": th["loss"].tolist(), "mc": mc}


def test_two_gloo_ranks_against_the_worker_axis(data, tmp_path):
    from tuplewise_tpu_torch.harness import mesh_mc
    from tuplewise_tpu_torch.harness.variance import VarianceConfig

    Xp, Xn = data
    s = LinearScorer(dim=4)
    cfg = T.TrainConfig(**CFG)
    kernel = T.check_config(cfg)
    mesh = make_mesh(2, device="cpu")
    rows = (ShardedRows(T.to_device_rows(Xp, "cpu"), mesh),
            ShardedRows(T.to_device_rows(Xn, "cpu"), mesh))
    # the worker axis's trajectory, a step at a time
    traj, losses = [s.init(0)], []
    p = T.replicate(s.init(0), 1, "cpu")
    for t in range(cfg.steps):
        p, loss = T.run_chunk(s, kernel, cfg, p, *rows, [cfg.seed], t, 1,
                              comm=mesh.comm)
        traj.append({k: v[0].numpy() for k, v in p.items()})
        losses.append(float(loss[0, 0]))
    forced = str(tmp_path / "forced.npz")
    np.savez(forced, **{f"{k}{t}": np.asarray(traj[t][k], np.float32)
                        for t in range(cfg.steps) for k in ("w", "b")})

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO,
                                     tests=os.path.join(REPO, "tests")))
    store = f"file://{tmp_path / 'store'}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TUPLEWISE_DIST_", "LOCAL_"))}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), store, forced], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(env, TUPLEWISE_DIST_NUM_PROCESSES="2",
                 TUPLEWISE_DIST_PROCESS_ID=str(r), OMP_NUM_THREADS="1"))
        for r in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"rank failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for proc in procs:
            proc.kill()
    recs = [json.loads([ln for ln in out.splitlines()
                        if ln.startswith("RESULT ")][0][len("RESULT "):])
            for out in outs]
    assert sorted(r["rank"] for r in recs) == [0, 1]
    # the ranks hold the same parameters and values, bit for bit
    for key in ("steps", "free", "free_loss", "triplet", "mc"):
        assert recs[0][key] == recs[1][key], key
    got = recs[0]

    # each step from the worker axis's parameters within the derived bound
    worst = 0.0
    for t in range(cfg.steps):
        bound = step_bound(Xp, Xn, traj[t], traj[t + 1], cfg)
        for k in ("w", "b"):
            diff = np.abs(np.asarray(got["steps"][t][k]) - traj[t + 1][k])
            assert (diff <= bound[k]).all(), (t, k, diff, bound[k])
            worst = max(worst, float((diff / bound[k]).max()))
        assert abs(got["losses"][t] - losses[t]) <= loss_bound(
            losses[t], cfg, len(Xp), len(Xn)), t
    assert worst < 1.0

    # the free runs: finite, learning, healed without a change
    assert np.isfinite(got["free_loss"]).all()
    assert got["free_loss"][-1] < got["free_loss"][0]
    assert got["healed_equal"] and got["healed_retries"] == 1
    assert got["exhausted"]
    assert np.isfinite(got["triplet_loss"]).all()

    # the mesh Monte-Carlo: each rank made its own worker's rows; auc
    # values are exact counts, equal to the worker axis's
    for scheme, n in (("complete", (200, 156)), ("complete", (203, 157)),
                      ("local", (203, 157))):
        want = mesh_mc.make_mesh_mc_runner(VarianceConfig(
            scheme=scheme, n_pos=n[0], n_neg=n[1], **MC),
            mesh=mesh)(range(60, 65))
        assert got["mc"][f"{scheme}{n}"] == want.tolist(), (scheme, n)


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip_on_the_cpu(n_devices):
    """The twin of __graft_entry__.dryrun_multichip: the ten steps over
    the worker axis, the double ring equal to the flat one."""
    from tuplewise_tpu_torch.graft_entry import dryrun_multichip

    out = dryrun_multichip(n_devices, "cpu")
    assert len(out) == 11 and out["ring_2d"] == out["ring"]
    assert all(np.isfinite(v) for v in out.values())
