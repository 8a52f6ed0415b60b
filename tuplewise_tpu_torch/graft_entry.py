"""The flagship forward step and the multi-worker dry run: twins of the
JAX package's ``__graft_entry__.entry`` and ``dryrun_multichip``.

``entry()`` returns ``(forward, example_args)``: the full-pair logistic
surrogate loss, mean over the 2048 x 2048 pair grid, of a
``LinearScorer(dim=16)`` on two [2048, 16] feature blocks, with the
reference's inputs (parameters from ``scorer.init(0)``, blocks from
``numpy.random.default_rng(0)``). On the card the pair sum is one launch
of kernel 1's logistic body (``ops.pair_kernels.pair_sum``,
``csrc/pair_sum.cu``); on the CPU, or with ``impl="plain"``, its plain
version.

``dryrun_multichip(n)`` runs the reference's ten multi-chip steps over
``make_mesh(n)`` (the worker axis of one device): the mesh trainer, the
ring (complete and repartitioned), the (2, n/2) double ring equal to the
flat ring, the mesh Monte-Carlo (full, ragged, designed), the swor and
bernoulli incomplete, the budgeted mesh trainer and the mesh triplet
trainer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tuplewise_tpu_torch.models.scorers import LinearScorer
from tuplewise_tpu_torch.ops import pair_kernels
from tuplewise_tpu_torch.ops.kernels import logistic_kernel
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.state import params_to_state

DIM, ROWS = 16, 2048


def entry(device=None, impl: Optional[str] = None):
    """(forward, (params, xp, xn)): forward(params, xp, xn) is the mean
    logistic pair loss as a float64 0-d tensor. device: None runs on the
    card (and raises where there is none), "cpu" the plain version."""
    dev = resolve_device(device)
    scorer = LinearScorer(dim=DIM)
    rng = np.random.default_rng(0)
    params = params_to_state(scorer.init(0), dev)
    xp = torch.as_tensor(rng.standard_normal((ROWS, DIM)),
                         dtype=torch.float32, device=dev)
    xn = torch.as_tensor(rng.standard_normal((ROWS, DIM)),
                         dtype=torch.float32, device=dev)

    def forward(params, xp, xn):
        s1 = scorer.score(params, xp)
        s2 = scorer.score(params, xn)
        total = pair_kernels.pair_sum(s1, s2, logistic_kernel, impl=impl)
        return total / float(s1.shape[0] * s2.shape[0])

    return forward, (params, xp, xn)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The reference's multi-chip dry run over ``make_mesh(n_devices,
    device)``; asserts each step's output and returns its values. device:
    None runs on the card (and raises where there is none), "cpu" the
    plain versions."""
    from tuplewise_tpu_torch.data import make_gaussians
    from tuplewise_tpu_torch.estimators.estimator import Estimator
    from tuplewise_tpu_torch.harness.mesh_mc import make_mesh_mc_runner
    from tuplewise_tpu_torch.harness.variance import VarianceConfig
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, train_pairwise,
    )
    from tuplewise_tpu_torch.models.triplet_sgd import (
        TripletTrainConfig, init_embed, train_triplet,
    )
    from tuplewise_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    mesh = make_mesh(n_devices, device)
    n = 16 * n_devices
    Xp, Xn = make_gaussians(n, n, dim=4, separation=1.0, seed=0)
    scorer = LinearScorer(dim=4)
    out = {}

    # 1) a full training step over the mesh: sharded data, worker
    #    blocks regathered every step, the summed pair-loss gradient
    cfg = TrainConfig(kernel="logistic", lr=0.1, steps=2,
                      n_workers=n_devices, repartition_every=1, tile=16)
    _, hist = train_pairwise(scorer, scorer.init(0), Xp, Xn, cfg,
                             mesh=mesh)
    # no retry may hide a failing kernel
    assert np.isfinite(hist["loss"]).all(), hist
    assert hist["recovery"]["retries_total"] == 0, hist
    out["loss"] = float(hist["loss"][-1])

    # 2) the ring's complete estimator; 3) a repartitioned one
    est = Estimator("auc", backend="mesh", mesh=mesh)
    u = out["ring"] = est.complete(Xp[:, 0], Xn[:, 0])
    assert 0.0 <= u <= 1.0, u
    r = out["repartitioned"] = est.repartitioned(Xp[:, 0], Xn[:, 0],
                                                 n_rounds=2, seed=0)
    assert 0.0 <= r <= 1.0, r

    # 4) the (2, n/2) double ring agrees with the flat ring exactly
    if n_devices >= 4 and n_devices % 2 == 0:
        u2 = out["ring_2d"] = Estimator(
            "auc", backend="mesh",
            mesh=make_mesh_2d(2, n_devices // 2, device)).complete(
                Xp[:, 0], Xn[:, 0])
        assert u2 == u, (u, u2)

    # 5) the mesh Monte-Carlo; 6) ragged (N does not divide n)
    base = dict(n_pos=n, n_neg=n, n_workers=n_devices, backend="mesh")
    mc = make_mesh_mc_runner(VarianceConfig(**base, n_reps=3), mesh=mesh)
    ests = mc(range(3))
    assert (np.isfinite(ests) & (ests >= 0) & (ests <= 1)).all(), ests
    out["mesh_mc"] = float(ests.mean())
    rag = make_mesh_mc_runner(VarianceConfig(
        **dict(base, n_pos=n + 3, n_neg=n - 1), scheme="local", n_reps=2),
        mesh=mesh)(range(2))
    assert np.isfinite(rag).all(), rag
    out["mesh_mc_ragged"] = float(rag.mean())

    # 7) the distinct designs: swor pairs, bernoulli triplets
    inc = out["swor"] = est.incomplete(Xp[:, 0], Xn[:, 0], n_pairs=64,
                                       seed=0, design="swor")
    assert 0.0 <= inc <= 1.0, inc
    inc3 = out["triplet_bernoulli"] = Estimator(
        "triplet_indicator", backend="mesh", mesh=mesh).incomplete(
            Xp, Xn, n_pairs=64, seed=0, design="bernoulli")
    assert 0.0 <= inc3 <= 1.0, inc3

    # 8) swor pair budgets in the mesh trainer
    cfg_d = TrainConfig(kernel="hinge", lr=0.1, steps=2,
                        n_workers=n_devices, repartition_every=1,
                        pairs_per_worker=8, pair_design="swor", tile=16)
    _, hist_d = train_pairwise(scorer, scorer.init(0), Xp, Xn, cfg_d,
                               mesh=mesh)
    assert np.isfinite(hist_d["loss"]).all(), hist_d
    assert hist_d["recovery"]["retries_total"] == 0, hist_d
    out["swor_budget_loss"] = float(hist_d["loss"][-1])

    # 9) the designed incomplete through the mesh Monte-Carlo
    des = make_mesh_mc_runner(VarianceConfig(
        **base, scheme="incomplete", n_pairs=32, design="swor", n_reps=2),
        mesh=mesh)(range(2))
    assert np.isfinite(des).all(), des
    out["designed_mc"] = float(des.mean())

    # 10) the triplet learner over the mesh
    tcfg = TripletTrainConfig(lr=0.05, steps=2, n_workers=n_devices,
                              repartition_every=1, triplets_per_worker=16,
                              embed_dim=2)
    _, hist_t = train_triplet(init_embed(4, 2), Xp, Xn, tcfg, mesh=mesh)
    assert np.isfinite(hist_t["loss"]).all(), hist_t
    assert hist_t["recovery"]["retries_total"] == 0, hist_t
    out["triplet_sgd_loss"] = float(hist_t["loss"][-1])
    return out
