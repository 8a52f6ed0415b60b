"""L5 — degree-3 metric-learning SGD (the triplet-loss learner) on one card.

The counterpart of ``tuplewise_tpu.models.triplet_sgd``: learn an
embedding e_theta (``models.scorers.LinearEmbed`` / ``MLPEmbed``) with
the triplet-hinge surrogate

    l(a, p, n) = max(0, margin + |e(a) - e(p)|^2 - |e(a) - e(n)|^2)

by the distributed schedule of the pairwise learner: each worker holds a
block of anchors/positives (the target class) and a block of negatives,
and differentiates the mean surrogate over B triplets it samples each
step under ``triplet_design`` (with replacement, "swr", by default; or
distinct, "swor" and "bernoulli"; i != j, k over its negatives); the
gradients are averaged over the workers, and the blocks are redrawn
every ``repartition_every`` steps.

On one card the workers are a batch axis: blocks are [N, m, d], a step
embeds all N blocks, gathers the N x B sampled triplets and takes the
mean over workers of the per-worker means (the JAX ``lax.pmean``); the
gradient comes from autograd (the sampled path has no pair kernel).
Held-out quality is the triplet ACCURACY: config 4's indicator
statistic on the embedded test data, computed by the port's complete
estimator, so the CUDA triplet kernel runs on the learner's path.

Every draw is keyed by the absolute step (``utils.rng``: blocks from
(seed, "repartition", t), triplets from (derive_seed(seed, "step", t),
"triplet_sample")), so a run cut into chunks, with a checkpoint between
them, equals the uncut run bit for bit on the same device. Checkpoints
have the JAX layout and config, so either package resumes the other's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tuplewise_tpu_torch.estimators.estimator import Estimator
from tuplewise_tpu_torch.models.pairwise_sgd import to_device_rows
from tuplewise_tpu_torch.models.scorers import LinearEmbed
from tuplewise_tpu_torch.ops import device_design
from tuplewise_tpu_torch.ops.kernels import Kernel, get_kernel
from tuplewise_tpu_torch.parallel.device_partition import draw_blocks
from tuplewise_tpu_torch.utils.checkpoint import resume_progress, save_checkpoint
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.rng import derive_seed, generator
from tuplewise_tpu_torch.utils.state import params_to_state, state_to_params


@dataclasses.dataclass(frozen=True)
class TripletTrainConfig:
    """Triplet-SGD hyperparameters: the JAX package's fields and
    defaults, so the config dicts stored in checkpoints compare equal."""

    kernel: str = "triplet_hinge"     # differentiable surrogate
    embed_dim: int = 8                # k: embedding width
    lr: float = 0.05
    steps: int = 100
    n_workers: int = 1
    repartition_every: int = 10
    triplets_per_worker: int = 4096   # B per worker per step
    # per-worker triplet design: "swr" | "swor" | "bernoulli", drawn on
    # the device each step (ops.device_design)
    triplet_design: str = "swr"
    scheme: str = "swor"
    seed: int = 0


def init_embed(dim: int, embed_dim: int, seed: int = 0) -> dict:
    """Linear embedding parameters W [d, k], scaled ~ orthonormal (the
    JAX draws: numpy ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    return {"W": rng.standard_normal((dim, embed_dim)) / np.sqrt(dim)}


def default_embedder(params) -> LinearEmbed:
    """A bare {"W": [d, k]} params dict means the linear embedding."""
    if "W" not in params:
        raise ValueError(
            "params carry no linear 'W' — pass the matching embedder= "
            "(models.scorers.MLPEmbed etc.) explicitly"
        )
    d, k = np.shape(params["W"])
    return LinearEmbed(dim=int(d), embed_dim=int(k))


def check_config(cfg: TripletTrainConfig) -> Kernel:
    """The surrogate kernel of ``cfg``, or ValueError /
    NotImplementedError for a configuration the learner cannot run."""
    kernel = get_kernel(cfg.kernel)
    if kernel.kind != "triplet":
        raise ValueError(
            f"triplet learner needs a degree-3 kernel, got "
            f"{kernel.name!r} (kind={kernel.kind})"
        )
    if kernel.name == "triplet_indicator":
        raise ValueError(
            "the indicator has zero gradient almost everywhere; train "
            "with 'triplet_hinge' and evaluate with "
            "evaluate_triplet_accuracy"
        )
    if cfg.triplet_design not in device_design.DESIGNS:
        raise ValueError(f"unknown triplet design {cfg.triplet_design!r}; "
                         f"known: {device_design.DESIGNS}")
    return kernel


# --------------------------------------------------------------------- #
# the step engine                                                       #
# --------------------------------------------------------------------- #

def _blocks(cfg, Xc, Xo, t):
    """[N, m1, d] and [N, m2, d] worker blocks as of repartition boundary
    t (generator (seed, "repartition", t))."""
    N = cfg.n_workers
    n1, n2 = Xc.shape[0], Xo.shape[0]
    gen = generator(cfg.seed, "repartition", t, device=Xc.device)
    i1 = draw_blocks(gen, n1, N, cfg.scheme, m=n1 // N)
    i2 = draw_blocks(gen, n2, N, cfg.scheme, m=n2 // N)
    return Xc[i1], Xo[i2]


def sample_triplets(cfg, t, m1, m2, device):
    """(i, j, k, w) [N, L] triplet indices and {0, 1} weights of step t
    under cfg.triplet_design, all N workers in one draw of
    ``ops.device_design``: i != j within the worker's m1 anchors, k over
    its m2 negatives; worker w takes row w. swr draws i, the shifted j,
    then k (the historical sequence)."""
    gen = generator(derive_seed(cfg.seed, "step", t), "triplet_sample",
                    device=device)
    return device_design.draw_triplet_design_device(
        gen, m1, m2, cfg.triplets_per_worker, cfg.triplet_design,
        batch=(cfg.n_workers,))


def sgd_step(embedder, kernel, cfg, params, Ab, Bb, triplets):
    """One step on given blocks Ab [N, m1, d], Bb [N, m2, d] and triplet
    indices and weights (i, j, k, w) [N, L]: the loss is the mean over
    workers of each worker's sum(vals * w) / max(sum(w), 1) (an empty
    bernoulli draw is a zero-weight step). Returns (new params, loss as
    a 0-d tensor)."""
    def rows(X, idx):
        return X.gather(1, idx[..., None].expand(-1, -1, X.shape[-1]))

    # the sampled rows are gathered BEFORE the embedding (the JAX step
    # embeds the blocks, then indexes): the backward of an index on the
    # card accumulates with atomics, whose order changes from run to
    # run, and a resumed run must repeat the straight one bit for bit
    i, j, k, wt = triplets
    xa, xp, xn = rows(Ab, i), rows(Ab, j), rows(Bb, k)   # [N, B, d]
    params = {name: v.detach().requires_grad_() for name, v in params.items()}
    vals = kernel.triplet_values(embedder.embed(params, xa),
                                 embedder.embed(params, xp),
                                 embedder.embed(params, xn))
    loss = ((vals * wt).sum(dim=1) / wt.sum(dim=1).clamp_min(1.0)).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        new = {name: w - cfg.lr * g
               for (name, w), g in zip(params.items(), grads)}
    return new, loss.detach()


def run_chunk(embedder, kernel, cfg, params, Xc, Xo, t0: int, chunk: int):
    """Steps [t0, t0 + chunk). Blocks are drawn as of the latest
    repartition boundary r0 = t0 - t0 % n_r, so any chunking reproduces
    the unchunked run. Returns (params, losses [chunk] on the device)."""
    n_r = cfg.repartition_every
    Ab, Bb = _blocks(cfg, Xc, Xo, t0 - t0 % n_r)
    m1, m2 = Ab.shape[1], Bb.shape[1]
    losses = torch.empty(chunk, device=Xc.device)
    for c in range(chunk):
        t = t0 + c
        if t % n_r == 0 and t > t0:
            Ab, Bb = _blocks(cfg, Xc, Xo, t)
        params, losses[c] = sgd_step(
            embedder, kernel, cfg, params, Ab, Bb,
            sample_triplets(cfg, t, m1, m2, Xc.device))
    return params, losses


# --------------------------------------------------------------------- #
# entry points                                                          #
# --------------------------------------------------------------------- #

def train_triplet(
    params,
    X_class: np.ndarray,
    X_other: np.ndarray,
    cfg: TripletTrainConfig,
    eval_every: Optional[int] = None,
    eval_data=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    embedder=None,
    *,
    device=None,
):
    """Distributed triplet SGD, its workers a batch axis on one device:
    anchors/positives from X_class (the target class), negatives from
    X_other. params: a dict of numpy arrays (the JAX form) or tensors.
    Returns (params as float32 numpy arrays, history) with
    history["loss"] the per-step worker-mean surrogate; with
    ``eval_every`` and ``eval_data=(Xc_test, Xo_test)`` the history also
    carries the held-out triplet accuracy at every eval boundary
    ("eval_steps", "test_acc").

    embedder: ``models.scorers.LinearEmbed`` / ``MLPEmbed`` (any module
    with a static ``embed(params, X)``); None infers the linear one from
    a bare {"W"} dict.

    device: None runs on the card and raises where there is none; "cpu"
    runs the plain versions.

    Checkpoint/resume, the JAX contract: with ``checkpoint_path``,
    params, the loss history and the accuracy curve persist every
    ``checkpoint_every`` steps (default: at eval boundaries, else once
    at the end); an existing checkpoint resumes from its step (cfg.steps
    may grow; every other field, and the embedder, must match). Chunks
    realign to ABSOLUTE eval/checkpoint boundaries, so a resumed run
    evaluates at the steps of the straight run and equals it bit for
    bit on the same device.
    """
    kernel = check_config(cfg)
    device = resolve_device(device)
    N = cfg.n_workers
    n1, n2 = len(X_class), len(X_other)
    if min(n1 // N, n2 // N) < 2:
        raise ValueError(f"n=({n1},{n2}) too small for {N} workers")
    if embedder is None:
        embedder = default_embedder(params)
    Xc, Xo = to_device_rows(X_class, device), to_device_rows(X_other, device)
    params = params_to_state(params, device)

    # the inferred linear default stores no 'embedder' key (the JAX
    # schema); any other embedder stores the JAX dataclass repr, so a
    # resume with another embedder is a config mismatch
    ck_config = dataclasses.asdict(cfg)
    if not isinstance(embedder, LinearEmbed):
        ck_config["embedder"] = repr(embedder)
    start, ck = resume_progress(checkpoint_path, ck_config,
                                progress_key="steps", requested=cfg.steps)
    loss_parts, curve_steps, curve_acc = [], [], []
    if ck is not None:
        loss_parts = [ck["extra"]["loss"]]
        curve_steps = list(ck["extra"].get("curve_steps", []))
        curve_acc = list(ck["extra"].get("curve_acc", []))
        params = params_to_state(ck["params"], device)
    ckpt_every = checkpoint_every or eval_every

    def next_boundary(t):
        nxt = cfg.steps
        for e in (eval_every, ckpt_every):
            if e:
                nxt = min(nxt, t - t % e + e)
        return nxt

    t0 = start
    while t0 < cfg.steps:
        t1 = next_boundary(t0)
        params, losses = run_chunk(embedder, kernel, cfg, params, Xc, Xo,
                                   t0, t1 - t0)
        loss_parts.append(losses.cpu().numpy())
        if eval_every is not None and (t1 % eval_every == 0
                                       or t1 == cfg.steps):
            curve_steps.append(t1)
            curve_acc.append(evaluate_triplet_accuracy(
                params, *eval_data, embedder=embedder, device=device))
        if checkpoint_path and (ckpt_every is None or t1 % ckpt_every == 0
                                or t1 == cfg.steps):
            save_checkpoint(
                checkpoint_path, step=t1, params=state_to_params(params),
                extra={"loss": np.concatenate(loss_parts),
                       "curve_steps": np.asarray(curve_steps),
                       "curve_acc": np.asarray(curve_acc)},
                config=ck_config)
        t0 = t1
    hist = {"loss": (np.concatenate(loss_parts) if loss_parts
                     else np.empty(0, np.float32))}
    if eval_every is not None:
        hist["eval_steps"] = np.asarray(curve_steps)
        hist["test_acc"] = np.asarray(curve_acc)
    return state_to_params(params), hist


def evaluate_triplet_accuracy(
    params, X_class, X_other, *, n_triplets: Optional[int] = None,
    seed: int = 0, embedder=None, device=None,
) -> float:
    """Config 4's indicator statistic on the EMBEDDED data: the fraction
    of (i != j in class, k outside) relative-similarity constraints the
    learned metric satisfies. The data are embedded in float32 on the
    device and the complete statistic runs the CUDA triplet kernel
    there; pass ``n_triplets`` for the incomplete estimate.
    ``embedder`` defaults to the linear map of a bare {"W"} dict."""
    device = resolve_device(device)
    if embedder is None:
        embedder = default_embedder(params)
    p = params_to_state(params, device)
    with torch.no_grad():
        Ec = embedder.embed(p, to_device_rows(X_class, device))
        Eo = embedder.embed(p, to_device_rows(X_other, device))
    est = Estimator("triplet_indicator", backend="torch", device=device)
    if n_triplets is None:
        return est.complete(Ec, Eo)
    return est.incomplete(Ec, Eo, n_pairs=n_triplets, seed=seed)
