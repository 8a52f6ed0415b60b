"""L5 — pairwise SGD (AUC maximization / bipartite ranking) on one card.

The counterpart of ``tuplewise_tpu.models.pairwise_sgd``: minimize the
pairwise surrogate risk

    L(theta) = mean_{i,j} l( s_theta(x_i) - s_theta(y_j) )

with synchronous distributed SGD over ``n_workers`` workers: each worker
differentiates the loss over ITS OWN pairs (all local pairs, or B
sampled ones), the gradients are averaged, and the data is
re-partitioned every ``repartition_every`` steps. BASELINE config 2.

On one card the workers are a batch axis. Worker blocks are gathered by
index into [N, m, d] on each repartition boundary, and a step scores
them and takes the pair loss of all N workers in ONE batched kernel
launch (``W = N``); the mean over the worker axis takes the place of
the JAX ``lax.pmean``. The full-pair loss differentiates through
``ops.pair_tiles.diff_pair_mean``: on a step whose loss is recorded
(``loss_every``) its forward is the fused loss+gradient CUDA kernel, on
the other steps the gradient-only one; both give the same gradient, so
``loss_every`` changes what is recorded, never the trajectory.

The same step engine trains S independent replicas at once (params
[S, ...], blocks [S, N, m, d], one launch with ``W = S * N``):
``train_pairwise`` runs it with S = 1, ``models.sim_learner.train_curves``
with S seeds. Every draw is keyed by the absolute step index
(``utils.rng``), so a run cut into chunks at any step, with a checkpoint
between them, reproduces the uncut run bit for bit on the same device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tuplewise_tpu_torch.ops import pair_tiles
from tuplewise_tpu_torch.ops.kernels import Kernel, get_kernel
from tuplewise_tpu_torch.ops.rank_auc import rank_auc
from tuplewise_tpu_torch.parallel.device_partition import draw_blocks
from tuplewise_tpu_torch.utils.checkpoint import (
    iter_chunks, resume_progress, save_checkpoint,
)
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.rng import derive_seed, generator
from tuplewise_tpu_torch.utils.state import params_to_state, state_to_params

_DESIGNS = ("swr", "swor", "bernoulli")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Pairwise-SGD hyperparameters: the JAX package's fields and
    defaults, so the config dicts stored in checkpoints compare equal."""

    kernel: str = "logistic"          # surrogate: "logistic" | "hinge"
    lr: float = 0.1
    steps: int = 100
    n_workers: int = 1
    repartition_every: int = 10       # n_r: communication budget knob
    pairs_per_worker: Optional[int] = None  # None = all local pairs
    # per-worker pair-budget design; the port runs "swr" ("swor" and
    # "bernoulli" raise NotImplementedError)
    pair_design: str = "swr"
    scheme: str = "swor"
    seed: int = 0
    # the JAX tile size; the CUDA kernels pick their own tiles
    tile: int = 512
    # record the surrogate loss every k steps; the other steps take the
    # gradient-only kernel and record NaN
    loss_every: int = 1


def check_config(cfg: TrainConfig) -> Kernel:
    """The surrogate kernel of ``cfg``, or ValueError /
    NotImplementedError for a configuration the learner cannot run."""
    kernel = get_kernel(cfg.kernel)
    if kernel.kind != "diff":
        raise ValueError(
            f"learner needs a score-difference surrogate kernel, got "
            f"{kernel.name!r} (kind={kernel.kind})"
        )
    if kernel.name == "auc":
        raise ValueError(
            "the AUC indicator has zero gradient almost everywhere; train "
            "with a surrogate ('logistic' or 'hinge') and evaluate with "
            "evaluate_auc"
        )
    if (cfg.loss_every != 1 and cfg.pairs_per_worker is None
            and kernel.diff_grad_fn is None):
        # the loss-free steps take the gradient-only pass, which needs
        # the analytic g'
        raise ValueError(
            f"loss_every={cfg.loss_every} needs an analytic gradient "
            f"(kernel {kernel.name!r} has no diff_grad_fn); use "
            "loss_every=1 or a kernel with diff_grad_fn"
        )
    if cfg.pairs_per_worker is not None:
        if cfg.pair_design not in _DESIGNS:
            raise ValueError(
                f"unknown pair design {cfg.pair_design!r}; known: {_DESIGNS}")
        if cfg.pair_design != "swr":
            raise NotImplementedError(
                f"pair_design={cfg.pair_design!r} is not ported yet; only "
                "'swr' runs"
            )
    return kernel


# --------------------------------------------------------------------- #
# the step engine, over S replicas                                      #
# --------------------------------------------------------------------- #

def _blocks(cfg, seeds, Xp, Xn, t):
    """[S, N, m1, d] and [S, N, m2, d] worker blocks of every replica as
    of repartition boundary t (generator (seed, "repartition", t))."""
    N = cfg.n_workers
    n1, n2 = Xp.shape[0], Xn.shape[0]
    i1, i2 = [], []
    for seed in seeds:
        gen = generator(seed, "repartition", t, device=Xp.device)
        i1.append(draw_blocks(gen, n1, N, cfg.scheme, m=n1 // N))
        i2.append(draw_blocks(gen, n2, N, cfg.scheme, m=n2 // N))
    return Xp[torch.stack(i1)], Xn[torch.stack(i2)]


def _sampled_pairs(cfg, seeds, t, m1, m2, device):
    """[S * N, B] pair indices of step t: replica s draws all N workers'
    pairs from generator (derive_seed(seed, "step", t), "pair_sample"),
    worker w taking row w."""
    i, j = [], []
    for seed in seeds:
        gen = generator(derive_seed(seed, "step", t), "pair_sample",
                        device=device)
        ii, jj = pair_tiles.sample_pair_indices(
            gen, m1, m2, cfg.pairs_per_worker, False,
            batch=(cfg.n_workers,))
        i.append(ii)
        j.append(jj)
    return torch.cat(i), torch.cat(j)


def sgd_step(scorer, kernel, cfg, params, Ab, Bb, seeds, t, impl=None):
    """Step t of every replica on given blocks. params: dict of [S, ...]
    tensors; Ab [S, N, m1, d], Bb [S, N, m2, d]; seeds: the S replica
    seeds (they key the sampled pairs of the budgeted path). Returns
    (new params, loss [S], NaN where step t's loss is not recorded)."""
    S, N, m1, d = Ab.shape
    m2 = Bb.shape[2]
    record = t % cfg.loss_every == 0
    params = {k: v.detach().requires_grad_() for k, v in params.items()}
    s1 = scorer.score(params, Ab.reshape(S, N * m1, d)).reshape(S * N, m1)
    s2 = scorer.score(params, Bb.reshape(S, N * m2, d)).reshape(S * N, m2)
    if cfg.pairs_per_worker is None:
        if record:
            vals = pair_tiles.pair_mean_for_grad(kernel, s1, s2, impl)
        else:
            vals = pair_tiles.diff_pair_mean_loss_free(kernel, s1, s2, impl)
    else:
        i, j = _sampled_pairs(cfg, seeds, t, m1, m2, s1.device)
        vals = kernel.diff(s1.gather(1, i) - s2.gather(1, j)).mean(dim=1)
    loss = vals.reshape(S, N).mean(dim=1)
    grads = torch.autograd.grad(loss.sum(), list(params.values()))
    with torch.no_grad():
        new = {k: p - cfg.lr * g for (k, p), g in zip(params.items(), grads)}
    loss = loss.detach()
    if not record:
        # the budgeted path's loss is a free byproduct: mask the record
        loss = torch.full_like(loss, float("nan"))
    return new, loss


def run_chunk(scorer, kernel, cfg, params, Xp, Xn, seeds: Sequence[int],
              t0: int, chunk: int, impl=None):
    """Steps [t0, t0 + chunk) of every replica. params: dict of [S, ...]
    tensors; Xp, Xn: [n, d] float32 on the device. Blocks are drawn as
    of the latest repartition boundary r0 = t0 - t0 % n_r, so any
    chunking reproduces the unchunked run. Returns (params, losses
    [S, chunk] on the device); nothing here reads a value back."""
    Ab, Bb = _blocks(cfg, seeds, Xp, Xn, t0 - t0 % cfg.repartition_every)
    losses = torch.empty(len(seeds), chunk, device=Xp.device)
    for c in range(chunk):
        t = t0 + c
        if t % cfg.repartition_every == 0 and t > t0:
            Ab, Bb = _blocks(cfg, seeds, Xp, Xn, t)
        params, losses[:, c] = sgd_step(scorer, kernel, cfg, params, Ab, Bb,
                                     seeds, t, impl)
    return params, losses


def replicate(params, n: int, device) -> dict:
    """A params dict (numpy or tensors) as float32 tensors with a
    leading replica axis of n copies."""
    return {k: v.expand(n, *v.shape).clone()
            for k, v in params_to_state(params, device).items()}


def to_device_rows(X, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(X), dtype=torch.float32,
                           device=device).contiguous()


# --------------------------------------------------------------------- #
# entry points                                                          #
# --------------------------------------------------------------------- #

def train_pairwise(
    scorer,
    params,
    X_pos: np.ndarray,
    X_neg: np.ndarray,
    cfg: TrainConfig,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    *,
    device=None,
    impl: Optional[str] = None,
):
    """Distributed pairwise SGD, its workers a batch axis on one device.

    scorer: a port scorer (``models.scorers``); params: its parameters
    as a dict of numpy arrays (the JAX package's form) or tensors, or
    None for the module's own. Returns (params as a dict of numpy
    arrays, history) where history["loss"] is the per-step worker-mean
    surrogate loss (NaN on steps cfg.loss_every skips).

    device: None runs on the card and raises where there is none;
    "cpu" runs the plain versions. impl="plain" takes the plain pair
    sums on the card too (the kernels' yardstick).

    Checkpoint/resume: with ``checkpoint_path``, training runs in
    chunks of ``checkpoint_every`` steps (default: one chunk) and saves
    params + loss history after each; an existing checkpoint resumes
    from its saved step. The checkpoint layout and config are the JAX
    trainer's, so a checkpoint of either resumes in the other. Resume
    is exact: a chunked run reproduces the unchunked run bit for bit on
    the same device (cfg.steps may differ across resumes; every other
    config field must match).
    """
    kernel = check_config(cfg)
    device = resolve_device(device)
    N = cfg.n_workers
    n1, n2 = len(X_pos), len(X_neg)
    if min(n1 // N, n2 // N) < 1:
        raise ValueError(f"n=({n1},{n2}) too small for {N} workers")
    Xp, Xn = to_device_rows(X_pos, device), to_device_rows(X_neg, device)
    if params is None:
        params = scorer.state_dict()
    params = replicate(params, 1, device)

    start, ck = resume_progress(
        checkpoint_path, dataclasses.asdict(cfg),
        progress_key="steps", requested=cfg.steps,
    )
    loss_parts = []
    if ck is not None:
        loss_parts = [ck["extra"]["loss"]]
        params = replicate(ck["params"], 1, device)
    for t, chunk in iter_chunks(start, cfg.steps, checkpoint_every):
        params, losses = run_chunk(scorer, kernel, cfg, params, Xp, Xn,
                                   [cfg.seed], t, chunk, impl)
        loss_parts.append(losses[0].cpu().numpy())
        if checkpoint_path:
            save_checkpoint(
                checkpoint_path,
                step=t + chunk,
                params=state_to_params({k: v[0] for k, v in params.items()}),
                extra={"loss": np.concatenate(loss_parts)},
                config=dataclasses.asdict(cfg),
            )
    loss = (np.concatenate(loss_parts) if loss_parts
            else np.zeros(0, np.float32))
    return (state_to_params({k: v[0] for k, v in params.items()}),
            {"loss": loss})


def split_by_label(X: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(positives, negatives) feature blocks from a labeled set."""
    y = np.asarray(y)
    return np.asarray(X)[y == 1], np.asarray(X)[y == 0]


def evaluate_auc(scorer, params, X_pos, X_neg, *, device=None) -> float:
    """Exact rank AUC of the scorer on the GIVEN sample, scored on the
    device (float32) and ranked by ``ops.rank_auc``. It is a test AUC
    only when called with held-out data (``data.splits``). params: a
    dict of numpy arrays or tensors, or None for the module's own."""
    device = resolve_device(device)
    p = params_to_state(scorer.state_dict() if params is None else params,
                        device)
    with torch.no_grad():
        s1 = scorer.score(p, to_device_rows(X_pos, device))
        s2 = scorer.score(p, to_device_rows(X_neg, device))
    return float(rank_auc(s1, s2))
