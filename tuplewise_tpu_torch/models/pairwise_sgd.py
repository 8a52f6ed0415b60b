"""L5 — pairwise SGD (AUC maximization / bipartite ranking) on one card.

The counterpart of ``tuplewise_tpu.models.pairwise_sgd``: minimize the
pairwise surrogate risk

    L(theta) = mean_{i,j} l( s_theta(x_i) - s_theta(y_j) )

with synchronous distributed SGD over ``n_workers`` workers: each worker
differentiates the loss over ITS OWN pairs (all local pairs, or B
sampled ones), the gradients are averaged, and the data is
re-partitioned every ``repartition_every`` steps. BASELINE config 2.

The workers live on a mesh (``parallel.mesh``): by default
``make_mesh(n_workers)``, the worker axis of one device. The data are
held as the workers' shards (``pad_blocks``) and each repartition
boundary regathers the [N, m, d] worker blocks from them through the
mesh's communicator (``ShardedRows``: one collective a side prices the
communication). A step scores every local worker's block and takes
their pair loss in ONE batched kernel launch (``W`` = the local workers);
one backward gives the gradient of their share of the worker mean, and
``comm.sum_partials`` adds the processes' shares in rank order (on the
worker axis one process holds every worker: nothing to add), the JAX
``lax.pmean``. Across ranks (``DistComm``) the sums group otherwise
than the worker axis's one batched backward, so the two agree within
float32 rounding, not bit for bit. The full-pair loss differentiates
through ``ops.pair_tiles.diff_pair_mean``: on a step whose loss is recorded
(``loss_every``) its forward is the fused loss+gradient CUDA kernel, on
the other steps the gradient-only one; both give the same gradient, so
``loss_every`` changes what is recorded, never the trajectory.

The same step engine trains S independent replicas at once (params
[S, ...], blocks [S, N, m, d], one launch with ``W = S * N``):
``train_pairwise`` runs it with S = 1, ``models.sim_learner.train_curves``
with S seeds (mesh-less: blocks indexed from the full arrays). Every draw
is keyed by the absolute step index and the logical worker
(``utils.rng``), so a run cut into chunks at any step, with a checkpoint
between them, reproduces the uncut run bit for bit on the same device,
and so does a run healed onto other worker slots
(``parallel.self_heal.MeshHealer``: a failed chunk probes the mesh,
rebuilds it at the same width over the pool's spare slots, re-places the
shards and retries; ``chaos`` fires at ``"train_step"`` before each chunk
and ``"checkpoint"`` after each save).

The budgeted path (``pairs_per_worker``) draws each step's pairs of all N
workers in one call of ``ops.device_design`` under ``pair_design``
("swr", "swor" or "bernoulli") and takes sum(vals * w) / max(sum(w), 1)
a worker. ``train_pairwise_numpy`` is the JAX package's numpy oracle.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tuplewise_tpu_torch.obs.tracing import check_tracer, maybe_span
from tuplewise_tpu_torch.ops import device_design, pair_tiles
from tuplewise_tpu_torch.ops.kernels import Kernel, get_kernel
from tuplewise_tpu_torch.ops.rank_auc import rank_auc
from tuplewise_tpu_torch.parallel.device_partition import (
    ShardedRows, draw_blocks,
)
from tuplewise_tpu_torch.parallel.mesh import make_mesh
from tuplewise_tpu_torch.parallel.partition import partition_two_sample
from tuplewise_tpu_torch.parallel.self_heal import Backoff, MeshHealer
from tuplewise_tpu_torch.utils.checkpoint import (
    iter_chunks, resume_progress, save_checkpoint,
)
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.profiling import annotate
from tuplewise_tpu_torch.utils.rng import derive_seed, generator
from tuplewise_tpu_torch.utils.state import params_to_state, state_to_params


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
    # per-worker pair-budget design: "swr" | "swor" | "bernoulli", drawn
    # on the device each step (ops.device_design)
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
    if (cfg.pairs_per_worker is not None
            and cfg.pair_design not in device_design.DESIGNS):
        raise ValueError(f"unknown pair design {cfg.pair_design!r}; "
                         f"known: {device_design.DESIGNS}")
    return kernel


# --------------------------------------------------------------------- #
# the step engine, over S replicas                                      #
# --------------------------------------------------------------------- #

def _blocks(cfg, seeds, Xp, Xn, t):
    """[S, N, m1, d] and [S, N, m2, d] worker blocks of every replica as
    of repartition boundary t (generator (seed, "repartition", t)). Xp,
    Xn: [n, d] tensors, or ``ShardedRows`` (S = 1; N is then this
    process's workers). A ``train.regather`` span."""
    N = cfg.n_workers
    n1, n2 = Xp.shape[0], Xn.shape[0]
    i1, i2 = [], []
    with annotate("train.regather"):
        for seed in seeds:
            gen = generator(seed, "repartition", t, device=Xp.device)
            i1.append(draw_blocks(gen, n1, N, cfg.scheme, m=n1 // N))
            i2.append(draw_blocks(gen, n2, N, cfg.scheme, m=n2 // N))
        return Xp[torch.stack(i1)], Xn[torch.stack(i2)]


def _sampled_pairs(cfg, seeds, t, m1, m2, device):
    """[S * N, L] pair indices and {0, 1} weights of step t under
    cfg.pair_design: replica s draws all N workers' designs in one call
    from generator (derive_seed(seed, "step", t), "pair_sample"), worker
    w taking row w. swr repeats ``sample_pair_indices``' draws."""
    draws = [
        device_design.draw_pair_design_device(
            generator(derive_seed(seed, "step", t), "pair_sample",
                      device=device),
            m1, m2, cfg.pairs_per_worker, cfg.pair_design,
            batch=(cfg.n_workers,))
        for seed in seeds
    ]
    return tuple(torch.cat(x) for x in zip(*draws))


def sgd_step(scorer, kernel, cfg, params, Ab, Bb, seeds, t, impl=None,
             comm=None):
    """Step t of every replica on given blocks. params: dict of [S, ...]
    tensors; Ab [S, N, m1, d], Bb [S, N, m2, d]; seeds: the S replica
    seeds (they key the sampled pairs of the budgeted path). comm: the
    mesh's communicator when the N workers are this process's share of
    a mesh (S = 1). Returns (new params, loss [S], NaN where step t's
    loss is not recorded)."""
    S, N, m1, d = Ab.shape
    m2 = Bb.shape[2]
    n_all = N if comm is None else comm.n_workers
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
        i, j, w = _sampled_pairs(cfg, seeds, t, m1, m2, s1.device)
        if n_all != N:
            i, j, w = (comm.local_rows(x) for x in (i, j, w))
        vals = kernel.diff(s1.gather(1, i) - s2.gather(1, j))
        # max(., 1): an exact small-grid bernoulli draw can realize an
        # EMPTY design, a zero-weight step, not NaN
        vals = (vals * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
    loss = vals.reshape(S, N).mean(dim=1)
    if n_all != N:
        # this process's share of the mean over every worker
        loss = loss * (N / n_all)
    grads = torch.autograd.grad(loss.sum(), list(params.values()))
    if n_all != N:
        grads, loss = _sum_over_processes(comm, grads, loss.detach())
    with torch.no_grad():
        new = {k: p - cfg.lr * g for (k, p), g in zip(params.items(), grads)}
    loss = loss.detach()
    if not record:
        # the budgeted path's loss is a free byproduct: mask the record
        loss = torch.full_like(loss, float("nan"))
    return new, loss


def _sum_over_processes(comm, grads, loss):
    """Every process's gradient share and loss share summed in rank order
    in ONE collective (``comm.sum_partials`` of the flattened parts)."""
    parts = list(grads) + [loss]
    flat = comm.sum_partials(torch.cat([g.reshape(-1) for g in parts]))
    out = list(flat.split([g.numel() for g in parts]))
    out = [o.reshape(g.shape) for o, g in zip(out, parts)]
    return out[:-1], out[-1]


def run_chunk(scorer, kernel, cfg, params, Xp, Xn, seeds: Sequence[int],
              t0: int, chunk: int, impl=None, comm=None):
    """Steps [t0, t0 + chunk) of every replica. params: dict of [S, ...]
    tensors; Xp, Xn: [n, d] float32 on the device, or the mesh's
    ``ShardedRows`` with its ``comm`` (S = 1). Blocks are drawn as of the
    latest repartition boundary r0 = t0 - t0 % n_r, so any chunking
    reproduces the unchunked run. Returns (params, losses [S, chunk] on
    the device); nothing here reads a value back."""
    Ab, Bb = _blocks(cfg, seeds, Xp, Xn, t0 - t0 % cfg.repartition_every)
    losses = torch.empty(len(seeds), chunk, device=Xp.device)
    for c in range(chunk):
        t = t0 + c
        if t % cfg.repartition_every == 0 and t > t0:
            Ab, Bb = _blocks(cfg, seeds, Xp, Xn, t)
        with annotate("train.step"):
            params, losses[:, c] = sgd_step(scorer, kernel, cfg, params, Ab,
                                            Bb, seeds, t, impl, comm)
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

def trainer_mesh(n_workers: int, mesh, device):
    """The mesh a trainer runs on: ``mesh``, whose size must be
    ``n_workers`` and whose device ``device`` (when given), or
    ``make_mesh(n_workers, device)``."""
    if mesh is None:
        return make_mesh(n_workers, device)
    if mesh.n_workers != n_workers:
        raise ValueError(f"n_workers={n_workers} conflicts with the mesh's "
                         f"{mesh.n_workers} workers")
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} conflicts with the mesh's "
                         f"{mesh.device}")
    return mesh


def recovery_record(start: int, healer) -> dict:
    """The history's ``recovery`` block: the step a resumed run started
    from and the healer's counters."""
    return {"resumed_from": int(start),
            "reshard_events": healer.reshard_events,
            "retries_total": healer.retries_total,
            "mesh_workers": healer.n_workers}


def train_pairwise(
    scorer,
    params,
    X_pos: np.ndarray,
    X_neg: np.ndarray,
    cfg: TrainConfig,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    *,
    mesh=None,
    chaos=None,
    heal_retries: int = 2,
    retry_backoff_s: float = 0.05,
    tracer=None,
    metrics=None,
    device=None,
    impl: Optional[str] = None,
):
    """Distributed pairwise SGD over a mesh of workers.

    scorer: a port scorer (``models.scorers``); params: its parameters
    as a dict of numpy arrays (the JAX package's form) or tensors, or
    None for the module's own. Returns (params as a dict of numpy
    arrays, history) where history["loss"] is the per-step worker-mean
    surrogate loss (NaN on steps cfg.loss_every skips) and, with
    ``heal_retries`` > 0, history["recovery"] holds ``resumed_from``,
    ``reshard_events``, ``retries_total`` and ``mesh_workers``.

    mesh: a ``parallel.mesh.Mesh`` of cfg.n_workers workers (the worker
    axis of one device, or one worker a ``torch.distributed`` rank);
    None builds ``make_mesh(cfg.n_workers, device)``. device: None runs
    on the card (the mesh's device when a mesh is given) and raises
    where there is none; "cpu" runs the plain versions. impl="plain"
    takes the plain pair sums on the card too (the kernels' yardstick).

    Checkpoint/resume: with ``checkpoint_path``, training runs in
    chunks of ``checkpoint_every`` steps (default: one chunk) and saves
    params + loss history after each; an existing checkpoint resumes
    from its saved step. The checkpoint layout and config are the JAX
    trainer's, so a checkpoint of either resumes in the other. Resume
    is exact: a chunked run reproduces the unchunked run bit for bit on
    the same device (cfg.steps may differ across resumes; every other
    config field must match).

    Elastic re-sharding: a chunk that fails runs the heal-and-retry
    protocol (``parallel.self_heal.MeshHealer``, at most
    ``heal_retries`` times, backoff from ``retry_backoff_s``): probe,
    rebuild the mesh AT THE SAME width over the spare slots of
    ``mesh.pool``, re-place the shards, retry; the healed trajectory is
    the fault-free one bit for bit. When the pool runs dry
    (``HealExhaustedError``) the job is left to checkpoint/resume.
    ``chaos`` (a ``testing.chaos.FaultInjector``) fires at
    ``"train_step"`` before each chunk and ``"checkpoint"`` after each
    save. ``tracer`` (an ``obs.tracing.Tracer``): the run is a
    ``train.run`` span with a ``train.chunk`` child a chunk and a
    ``train.checkpoint`` child a save; the healer's rounds are spans too.
    While a profiler records, ``train.place`` spans the rows' and the
    parameters' placing, ``train.regather`` each repartition boundary's
    blocks, ``train.step`` each step and ``train.read`` each chunk's read
    of its losses.
    ``metrics``: a ``utils.profiling.MetricsRegistry`` that receives the
    gauges ``train_step``, ``train_loss_last`` and ``mesh_width``, the
    ``train_chunk_s`` histogram and the healer's counters.
    """
    kernel = check_config(cfg)
    check_tracer(tracer)
    mesh = trainer_mesh(cfg.n_workers, mesh, device)
    device, N = mesh.device, mesh.n_workers
    n1, n2 = len(X_pos), len(X_neg)
    if min(n1 // N, n2 // N) < 1:
        raise ValueError(f"n=({n1},{n2}) too small for {N} workers")
    with annotate("train.place"):
        Xp = to_device_rows(X_pos, device)
        Xn = to_device_rows(X_neg, device)
        rows = (ShardedRows(Xp, mesh), ShardedRows(Xn, mesh))
        params = replicate(scorer.state_dict() if params is None else params,
                           1, device)

    start, ck = resume_progress(
        checkpoint_path, dataclasses.asdict(cfg),
        progress_key="steps", requested=cfg.steps,
    )
    loss_parts = []
    if ck is not None:
        loss_parts = [ck["extra"]["loss"]]
        params = replicate(ck["params"], 1, device)

    healer = None
    if heal_retries:
        healer = MeshHealer(
            mesh, fixed_width=N, pool=mesh.pool, chaos=chaos,
            backoff=Backoff(base_s=retry_backoff_s, seed=cfg.seed),
            metrics=metrics, tracer=tracer)
    if metrics is not None:
        g_step = metrics.gauge("train_step")
        g_loss = metrics.gauge("train_loss_last")
        h_chunk = metrics.histogram("train_chunk_s")
        metrics.gauge("mesh_width").set(N)

    def on_heal(h):
        # adopt the healed mesh and re-place the shards on it
        nonlocal rows
        rows = (ShardedRows(Xp, h.mesh), ShardedRows(Xn, h.mesh))

    run_span = None
    if tracer is not None:
        run_span = tracer.start("train.run", parent=None,
                                steps=cfg.steps, n_workers=N)
    for t, chunk in iter_chunks(start, cfg.steps, checkpoint_every):
        def attempt(t=t, chunk=chunk):
            if chaos is not None:
                chaos.fire("train_step")
            return run_chunk(scorer, kernel, cfg, params, *rows, [cfg.seed],
                             t, chunk, impl, rows[0].comm)

        t_chunk0 = time.perf_counter()
        with maybe_span(tracer, "train.chunk", parent=run_span,
                        step=t, steps=chunk):
            if healer is not None:
                params, losses = healer.run(attempt, retries=heal_retries,
                                            on_heal=on_heal)
            else:
                params, losses = attempt()
        with annotate("train.read"):
            loss_parts.append(losses[0].cpu().numpy())
        if metrics is not None:
            h_chunk.observe(time.perf_counter() - t_chunk0)
            g_step.set(t + chunk)
            last = loss_parts[-1][-1] if chunk else np.nan
            if np.isfinite(last):
                g_loss.set(float(last))
        if checkpoint_path:
            with maybe_span(tracer, "train.checkpoint", parent=run_span,
                            step=t + chunk):
                save_checkpoint(
                    checkpoint_path,
                    step=t + chunk,
                    params=state_to_params(
                        {k: v[0] for k, v in params.items()}),
                    extra={"loss": np.concatenate(loss_parts)},
                    config=dataclasses.asdict(cfg),
                )
            if chaos is not None:
                # the checkpoint above is durable: a 'sigkill' scheduled
                # here dies with exactly t + chunk steps recoverable
                chaos.fire("checkpoint")
    if tracer is not None:
        tracer.finish(run_span)
    loss = (np.concatenate(loss_parts) if loss_parts
            else np.zeros(0, np.float32))
    history = {"loss": loss}
    if healer is not None:
        history["recovery"] = recovery_record(start, healer)
    return state_to_params({k: v[0] for k, v in params.items()}), history


# --------------------------------------------------------------------- #
# numpy oracle trainer (parity reference)                               #
# --------------------------------------------------------------------- #

# the surrogate l(d) and its derivative dl/dd, in numpy: the JAX
# package's expressions, so the oracle repeats its values bit for bit
_SURROGATE = {
    "logistic": lambda d: np.logaddexp(0.0, -d),
    "hinge": lambda d: np.maximum(0.0, 1.0 - d),
}
_SURROGATE_DERIV = {
    "logistic": lambda d: -1.0 / (1.0 + np.exp(d)),   # -sigmoid(-d)
    "hinge": lambda d: np.where(d < 1.0, -1.0, 0.0),
}


def train_pairwise_numpy(scorer, params, X_pos: np.ndarray,
                         X_neg: np.ndarray, cfg: TrainConfig):
    """Serial float64 oracle (a copy of the JAX package's): the same
    schedule with analytic full-pair gradients for a LINEAR scorer
    (params {"w", "b"}), the worker blocks drawn by the host partitioner
    (``parallel.partition.partition_two_sample``) from
    ``np.random.default_rng(cfg.seed)`` at every repartition boundary.
    Returns (params as float64 numpy arrays, {"loss": [steps]})."""
    assert cfg.kernel in _SURROGATE_DERIV, cfg.kernel
    assert cfg.pairs_per_worker is None, "oracle trainer uses all pairs"
    loss_fn, deriv = _SURROGATE[cfg.kernel], _SURROGATE_DERIV[cfg.kernel]
    params = {k: np.asarray(v, np.float64) for k, v in params.items()}
    rng = np.random.default_rng(cfg.seed)
    N = cfg.n_workers
    losses = []
    parts = None  # drawn by the t=0 refresh below
    for t in range(cfg.steps):
        if t % cfg.repartition_every == 0:
            parts = partition_two_sample(len(X_pos), len(X_neg), N, rng,
                                         cfg.scheme)
        g_w = np.zeros_like(params["w"])
        g_b = 0.0  # a pairwise loss of s(x) - s(y) has zero bias gradient
        loss_acc = 0.0
        for w_idx in range(N):
            A = X_pos[parts[0][w_idx]]
            Bm = X_neg[parts[1][w_idx]]
            s1 = A @ params["w"] + params["b"]
            s2 = Bm @ params["w"] + params["b"]
            d = s1[:, None] - s2[None, :]
            lp = deriv(d)
            cnt = d.size
            loss_acc += float(np.mean(loss_fn(d)))
            # dL/dw = mean_ij l'(d_ij) (x_i - y_j)
            g_w += (lp.sum(axis=1) @ A + (-lp.sum(axis=0)) @ Bm) / cnt
        params["w"] = params["w"] - cfg.lr * (g_w / N)
        params["b"] = params["b"] - cfg.lr * g_b
        losses.append(loss_acc / N)
    return params, {"loss": np.asarray(losses)}


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
