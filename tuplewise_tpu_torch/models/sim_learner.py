"""Simulated-N distributed pairwise SGD on one card: learning curves.

The counterpart of ``tuplewise_tpu.models.sim_learner``. It runs the
same distributed semantics as ``models.pairwise_sgd.train_pairwise``
(the same generators per repartition boundary and step, the same
schedule, the same step engine) for S Monte-Carlo seeds at once: seeds
x workers form one batch axis, so a step of all S * N workers is ONE
launch of the pair kernels (``W = S * N``). Replica s is
``train_pairwise`` at ``seed = cfg.seed + s``; the two agree to float
rounding (a batched scorer product may round differently from an
unbatched one).

Where the JAX module takes dense autodiff over each [m1, m2] grid, the
port routes every step through the same kernels as the trainer, so
that there is one engine.
"""

from __future__ import annotations

import numpy as np
import torch

from tuplewise_tpu_torch.models.pairwise_sgd import (
    check_config, replicate, run_chunk, to_device_rows,
)
from tuplewise_tpu_torch.ops.rank_auc import rank_auc
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.state import state_to_params

# TrainConfig.repartition_every sentinel for "never repartition";
# curve_record maps it to n_r = null in emitted rows
NEVER = 1 << 30


def last_recorded_loss(loss, loss_every: int) -> float | None:
    """Mean loss at the last step cfg.loss_every RECORDED. Looks at the
    recording PATTERN (t % loss_every == 0), not at finiteness: a masked
    step is skipped, but a recorded step that diverged to NaN/inf
    returns None instead of silently falling back to an earlier finite
    value (None in place of a number is the divergence flag; a NaN
    literal would be invalid JSON)."""
    loss = np.atleast_2d(np.asarray(loss))
    steps = loss.shape[-1]
    if steps == 0:
        return None
    k = max(int(loss_every), 1)
    last = ((steps - 1) // k) * k
    v = float(loss[..., last].mean())
    return v if np.isfinite(v) else None


def curve_record(cfg, out, n_seeds: int) -> dict:
    """Summary row for one :func:`train_curves` cell (the JAX package's
    row schema: n_r null-mapping, comm_events accounting, rounding and
    the seed-spread statistics).

    With n_seeds < 2 the spread fields are null (a sample SD over one
    replica is undefined — emitting NaN would produce invalid JSON).
    """
    auc = out["test_auc"]                        # [S, K]
    fin = auc[:, -1]
    if n_seeds >= 2:
        auc_se = np.round(
            auc.std(axis=0, ddof=1) / np.sqrt(n_seeds), 7
        ).tolist()
        final_se = float(fin.std(ddof=1) / np.sqrt(n_seeds))
        final_sd = float(fin.std(ddof=1))
    else:
        auc_se = [None] * auc.shape[1]
        final_se = final_sd = None
    return {
        "kernel": cfg.kernel, "lr": cfg.lr, "steps": cfg.steps,
        "n_workers": cfg.n_workers,
        "n_r": (None if cfg.repartition_every >= NEVER
                else cfg.repartition_every),
        "repartition_every": cfg.repartition_every,
        "pairs_per_worker": cfg.pairs_per_worker,
        "pair_design": cfg.pair_design,
        "n_seeds": n_seeds,
        # 1 initial partition + one event per later boundary
        "comm_events": 1 + (cfg.steps - 1) // cfg.repartition_every,
        "eval_steps": out["steps"].tolist(),
        "auc_mean": np.round(auc.mean(axis=0), 6).tolist(),
        "auc_se": auc_se,
        "final_auc_mean": float(fin.mean()),
        "final_auc_se": final_se,
        "final_auc_sd": final_sd,
        # last RECORDED loss (None = never recorded or diverged)
        "loss_final_mean": last_recorded_loss(
            out["loss"], cfg.loss_every
        ),
    }


def _test_aucs(scorer, params, Xp_te, Xn_te) -> torch.Tensor:
    """[S] exact test AUC of every replica."""
    S = next(iter(params.values())).shape[0]
    with torch.no_grad():
        s1 = scorer.score(params, Xp_te.expand(S, *Xp_te.shape))
        s2 = scorer.score(params, Xn_te.expand(S, *Xn_te.shape))
    return torch.stack([rank_auc(s1[s], s2[s]) for s in range(S)])


def train_curves(
    scorer,
    params0,
    X_pos: np.ndarray,
    X_neg: np.ndarray,
    X_pos_test: np.ndarray,
    X_neg_test: np.ndarray,
    cfg,
    *,
    n_seeds: int = 8,
    eval_every: int = 25,
    device=None,
    impl=None,
):
    """Monte-Carlo learning curves of simulated-N distributed SGD.

    Trains ``n_seeds`` independent replicas (seeds cfg.seed ..
    cfg.seed + n_seeds - 1 govern partition/sampling randomness; the
    init ``params0`` is SHARED so the spread isolates the partition
    effect), evaluating held-out rank AUC every ``eval_every`` steps.
    device and impl as in ``train_pairwise``.

    Returns a dict: ``steps`` [K], ``test_auc`` [S, K] (K includes the
    step-0 init point), ``loss`` [S, steps], ``final_params`` (dict of
    numpy arrays with a leading seed axis).
    """
    kernel = check_config(cfg)
    device = resolve_device(device)
    N = cfg.n_workers
    n1, n2 = len(X_pos), len(X_neg)
    if n1 // N < 1 or n2 // N < 1:
        raise ValueError(f"n=({n1},{n2}) too small for {N} workers")
    seeds = [cfg.seed + s for s in range(n_seeds)]
    params = replicate(params0, n_seeds, device)
    Xp, Xn = to_device_rows(X_pos, device), to_device_rows(X_neg, device)
    Xp_te = to_device_rows(X_pos_test, device)
    Xn_te = to_device_rows(X_neg_test, device)

    steps_axis = [0]
    aucs = [_test_aucs(scorer, params, Xp_te, Xn_te)]
    loss_parts = []
    t = 0
    while t < cfg.steps:
        chunk = min(eval_every, cfg.steps - t)
        params, losses = run_chunk(scorer, kernel, cfg, params, Xp, Xn,
                                   seeds, t, chunk, impl)
        loss_parts.append(losses)
        t += chunk
        steps_axis.append(t)
        aucs.append(_test_aucs(scorer, params, Xp_te, Xn_te))
    loss = (torch.cat(loss_parts, dim=1).cpu().numpy() if loss_parts
            else np.zeros((n_seeds, 0), np.float32))
    return {
        "steps": np.asarray(steps_axis),
        "test_auc": torch.stack(aucs, dim=1).cpu().numpy(),   # [S, K]
        "loss": loss,                                          # [S, steps]
        "final_params": state_to_params(params),
    }
