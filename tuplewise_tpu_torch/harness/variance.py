"""L4 — Monte-Carlo variance harness and trade-off curves (the
counterpart of ``tuplewise_tpu.harness.variance``).

Repeat an estimator M times over fresh Gaussian draws and fresh
partitions or tuple designs, and report the empirical mean and variance
beside the closed form — the measurement behind the paper's
variance-vs-communication curves (``tradeoff_vs_rounds``,
``tradeoff_vs_pairs``, ``tradeoff_vs_workers``).

Reps are drawn in blocks of ``REP_BLOCK`` (64): every draw of block k
(its reps' data, then their tuples or the partitions of rounds 0, 1,
...) is one batched call on the generator of (seed, "mc_rep", k), and
rep r is row r % 64 of its block. A chunk of reps draws the blocks it
touches whole and keeps its rows, so estimates depend only on the
absolute rep index, and a run cut into chunks, with a checkpoint between
them, repeats the straight run (bit for bit wherever the batched sums are
exact, as the AUC's are). A run of a multiple of 64 reps draws exactly
what it uses; any other draws up to 63 rows of randomness it discards.
``fix_data=True`` freezes ONE dataset, drawn from (seed, "data_fixed"),
and Monte-Carlos over the sampling randomness only: the CONDITIONAL
variance Var(U~ | data), where the swor/bernoulli finite-population
reduction lives (at B = G/2 swor halves the swr variance; G is the size
of the tuple grid).

The M reps are a batch axis, not a loop, for the score-difference
kernels (all four schemes) and the degree-3 incomplete estimator: each
local round of all reps and all workers is ONE batched pair-kernel launch
over [M * N, m] blocks (a complete statistic is one launch over [M, n]),
and each draw (data, blocks, designs) is one batched call a block of 64
reps. The other degree-3 schemes and the pair-feature kernels
(``scatter``, every scheme) loop the public Estimator over numpy
Gaussian clouds, rep by rep in rep order, as the JAX harness does; so
do the host oracles (``backend="numpy"`` or ``"cpp"``) for every kernel
and scheme, whose rows then equal the JAX harness's on the same backend.

``backend="mesh"`` runs every kernel kind and scheme on a mesh of
``n_workers`` workers through ``harness.mesh_mc.make_mesh_mc_runner``
(data made on each worker, the ring for complete statistics): BASELINE
config 5's Monte-Carlo.

Elastic re-sharding: with ``heal_retries`` > 0 (the default 2) a chunk
that fails heals through ``parallel.self_heal.MeshHealer``: a mesh config
probes, rebuilds the mesh at the SAME width over the spare slots of its
pool, rebuilds the runner and retries; the other backends retry with
backoff only. Estimates are keyed by (rep, logical worker), so a healed
sweep equals a fault-free one bit for bit. ``chaos`` fires at
``"mc_chunk"`` (a chunk), ``"mesh_mc"`` (a block of reps of the mesh
runner) and ``"checkpoint"`` (after each save).

``trace_dir`` brackets the sweep in a ``torch.profiler`` trace
(``utils.profiling.trace``), each chunk a named range
``mc_reps[m:m+chunk]``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Optional

import numpy as np
import torch

from tuplewise_tpu_torch.data.synthetic import make_gaussians, true_gaussian_auc
from tuplewise_tpu_torch.estimators import variance as closed
from tuplewise_tpu_torch.estimators.estimator import Estimator
from tuplewise_tpu_torch.harness import mesh_mc
from tuplewise_tpu_torch.ops import device_design, pair_kernels, rank_count
from tuplewise_tpu_torch.ops.kernels import get_kernel
from tuplewise_tpu_torch.parallel.device_partition import draw_blocks
from tuplewise_tpu_torch.parallel.mesh import make_mesh
from tuplewise_tpu_torch.parallel.self_heal import Backoff, MeshHealer
from tuplewise_tpu_torch.utils.checkpoint import (
    iter_chunks, resume_progress, save_checkpoint,
)
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.profiling import annotate, trace
from tuplewise_tpu_torch.utils.rng import generator

SCHEMES = ("complete", "local", "repartitioned", "incomplete")
BACKENDS = ("torch", "mesh", "numpy", "cpp")
# the host oracles: the looped Estimator on the JAX harness's numpy clouds
HOST_BACKENDS = ("numpy", "cpp")
# reps a generator draws for at once (see the module docstring): a
# constant, so that the reps' values do not depend on the run's size
REP_BLOCK = 64
# the closed form's plug-in zetas come from one Gaussian sample of at most
# this many rows a class (the float64 moments cost n1 * n2 on the CPU)
_ZETA_N = 10_000


@dataclasses.dataclass(frozen=True)
class VarianceConfig:
    """One variance experiment."""

    kernel: str = "auc"
    scheme: str = "complete"          # complete | local | repartitioned | incomplete
    backend: str = "torch"            # torch | mesh | numpy | cpp
    n_pos: int = 10_000
    n_neg: int = 10_000
    dim: int = 1                      # feature width of the triplet clouds
    separation: float = 1.0
    n_workers: int = 8
    n_rounds: int = 1                 # T (repartitioned)
    n_pairs: int = 10_000             # B (incomplete)
    design: str = "swr"               # incomplete tuple design
    # one frozen dataset, Monte-Carlo over the sampling randomness only
    fix_data: bool = False
    partition_scheme: str = "swor"
    n_reps: int = 100                 # M Monte-Carlo repetitions
    seed: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _validate(cfg: VarianceConfig) -> None:
    if cfg.scheme not in SCHEMES:
        raise ValueError(
            f"unknown scheme {cfg.scheme!r}; choose one of {SCHEMES}"
        )
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; choose one of "
                         f"{BACKENDS}")
    if (cfg.scheme in ("local", "repartitioned")
            and cfg.n_workers > min(cfg.n_pos, cfg.n_neg)):
        raise ValueError(
            f"n_workers={cfg.n_workers} exceeds the per-class sample "
            f"size ({cfg.n_pos}, {cfg.n_neg}); every worker needs at "
            f"least one row per class"
        )
    if cfg.design not in device_design.DESIGNS:
        raise ValueError(f"unknown sampling design {cfg.design!r}; "
                         f"choose one of {device_design.DESIGNS}")


def _looped(cfg: VarianceConfig) -> bool:
    """The host oracles (every kernel and scheme), and on the single
    device the pair-feature kernels (every scheme) and the degree-3
    schemes other than incomplete, loop the Estimator."""
    kind = get_kernel(cfg.kernel).kind
    return cfg.backend in HOST_BACKENDS or (
        cfg.backend == "torch"
        and (kind == "pair"
             or (kind == "triplet" and cfg.scheme != "incomplete")))


def _draw_data(cfg: VarianceConfig, g: torch.Generator, batch=()):
    """Datasets from ``g`` ([*batch] of them, one normal draw): scores
    [n] for diff kernels, Gaussian clouds [n, dim] for triplet kernels;
    the first class shifted by ``separation``."""
    feat = () if get_kernel(cfg.kernel).kind == "diff" else (cfg.dim,)
    Z = torch.randn((*batch, cfg.n_pos + cfg.n_neg, *feat), generator=g,
                    device=g.device)
    X, Y = Z.split([cfg.n_pos, cfg.n_neg], dim=len(batch))
    return X + cfg.separation, Y


def fixed_dataset(cfg: VarianceConfig, device=None):
    """The frozen arrays a fix_data=True run on ``device`` draws, as
    numpy: the same generator and the same calls as the runner (the mesh
    runner's workers' rows for a mesh config), so a results audit
    computes exact conditional closed forms on the very dataset. torch's
    generators differ between the CPU and the card, so the device is part
    of the dataset's identity. The host oracles' dataset is the looped
    Estimator's numpy clouds of rep 0 (``_estimate_once``)."""
    dev = resolve_device(device)
    if cfg.backend in HOST_BACKENDS:
        X, Y = make_gaussians(cfg.n_pos, cfg.n_neg, cfg.dim, cfg.separation,
                              seed=cfg.seed * 1_000_003)
        if get_kernel(cfg.kernel).kind == "diff":
            return X[:, 0], Y[:, 0]
        return X, Y
    if cfg.backend == "mesh":
        # the workers' shards laid end to end are the global rows
        rows = mesh_mc.worker_draws(cfg, make_mesh(cfg.n_workers, dev),
                                    ("data_fixed",), 1)
        X, Y = (r[0].reshape((-1,) + r.shape[3:])[:n] for r, n in zip(
            rows + rows[:1], (cfg.n_pos, cfg.n_neg)))
        return X.cpu().numpy(), Y.cpu().numpy()
    X, Y = _draw_data(cfg, generator(cfg.seed, "data_fixed", device=dev))
    return X.cpu().numpy(), Y.cpu().numpy()


def _rows(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rep rows: X [M, n, d], idx [M, B] -> [M, B, d]."""
    return X.gather(1, idx[..., None].expand(-1, -1, X.shape[-1]))


def batched_estimates(cfg: VarianceConfig, device=None,
                      reps=None) -> torch.Tensor:
    """[len(reps)] float64 estimates of cfg's scheme for the reps of the
    range ``reps`` (default range(cfg.n_reps)), every rep batched."""
    _validate(cfg)
    if _looped(cfg):
        raise ValueError(f"the {cfg.scheme} scheme of {cfg.kernel!r} is "
                         "looped; use run_variance_experiment")
    dev = resolve_device(device)
    kernel = get_kernel(cfg.kernel)
    reps = range(cfg.n_reps) if reps is None else reps
    M, n1, n2, N = len(reps), cfg.n_pos, cfg.n_neg, cfg.n_workers
    B, first = REP_BLOCK, reps.start // REP_BLOCK
    # every chunk that touches block k draws it whole: the chain is
    # shared by design, so the key audit does not record it
    gens = [generator(cfg.seed, "mc_rep", k, device=dev, record=False)
            for k in range(first, -(-reps.stop // B))]
    rows = slice(reps.start - first * B, reps.stop - first * B)

    def draw(fn):
        """fn(g) -> a tensor or tuple of tensors [B, ...] for each block's
        generator; the chunk's rows of the blocks' draws."""
        outs = [fn(g) for g in gens]
        if not isinstance(outs[0], tuple):
            outs = [(o,) for o in outs]
        cat = [x[0] if len(gens) == 1 else torch.cat(x) for x in zip(*outs)]
        return tuple(x[rows] for x in cat)

    if cfg.fix_data:
        X, Y = _draw_data(cfg, generator(cfg.seed, "data_fixed", device=dev))
        s1, s2 = X.expand(M, *X.shape), Y.expand(M, *Y.shape)
    else:
        s1, s2 = draw(lambda g: _draw_data(cfg, g, (B,)))

    if cfg.scheme == "incomplete":
        # floor_one: estimation semantics (bernoulli's size is >= 1)
        if kernel.kind == "triplet":
            i, j, k, w = draw(
                lambda g: device_design.draw_triplet_design_device(
                    g, n1, n2, cfg.n_pairs, cfg.design, floor_one=True,
                    batch=(B,)))
            vals = kernel.triplet_values(_rows(s1, i), _rows(s1, j),
                                         _rows(s2, k))
        else:
            i, j, w = draw(lambda g: device_design.draw_pair_design_device(
                g, n1, n2, cfg.n_pairs, cfg.design, floor_one=True,
                batch=(B,)))
            vals = kernel.diff(s1.gather(1, i) - s2.gather(1, j))
        return device_design.weighted_mean(vals, w)

    def local_round():
        i1, i2 = draw(lambda g: (
            draw_blocks(g, n1, N, cfg.partition_scheme, batch=(B,)),
            draw_blocks(g, n2, N, cfg.partition_scheme, batch=(B,))))
        m1, m2 = i1.shape[-1], i2.shape[-1]
        b1 = torch.gather(s1, 1, i1.reshape(M, N * m1)).reshape(M * N, m1)
        b2 = torch.gather(s2, 1, i2.reshape(M, N * m2)).reshape(M * N, m2)
        sums = pair_kernels.pair_sum(b1, b2, kernel)
        return (sums / float(m1 * m2)).reshape(M, N).mean(dim=1)

    if cfg.scheme == "complete":
        return pair_kernels.pair_sum(s1.contiguous(), s2.contiguous(),
                                     kernel) / float(n1 * n2)
    if cfg.scheme == "local":
        return local_round()
    return sum(local_round() for _ in range(cfg.n_rounds)) / cfg.n_rounds


def _estimate_once(est: Estimator, cfg: VarianceConfig, rep: int) -> float:
    """One looped estimate: numpy Gaussian clouds of rep (the JAX
    harness's data, seed ``cfg.seed * 1_000_003 + rep``, or + 0 with
    fix_data) through the public Estimator. Feature kernels take [n, d]
    rows; a one-sample kernel (``scatter``) takes the first class only."""
    X, Y = make_gaussians(
        cfg.n_pos, cfg.n_neg, cfg.dim, cfg.separation,
        seed=cfg.seed * 1_000_003 + (0 if cfg.fix_data else rep),
    )
    kern = get_kernel(cfg.kernel)
    s1, s2 = (X[:, 0], Y[:, 0]) if kern.kind == "diff" else (X, Y)
    if not kern.two_sample:
        s2 = None
    if cfg.scheme == "complete":
        return est.complete(s1, s2)
    if cfg.scheme == "local":
        return est.local_average(s1, s2, seed=rep,
                                 scheme=cfg.partition_scheme)
    if cfg.scheme == "repartitioned":
        return est.repartitioned(s1, s2, n_rounds=cfg.n_rounds, seed=rep,
                                 scheme=cfg.partition_scheme)
    return est.incomplete(s1, s2, n_pairs=cfg.n_pairs, seed=rep,
                          design=cfg.design)


@functools.lru_cache(maxsize=16)
def _zetas(kernel: str, n_pos: int, n_neg: int, separation: float, seed: int):
    X, Y = make_gaussians(n_pos, n_neg, 1, separation, seed=seed)
    return closed.two_sample_zetas(kernel, X[:, 0], Y[:, 0])


def closed_form_variance(cfg: VarianceConfig, device=None) -> Optional[float]:
    """The closed form of cfg's scheme, or None where the port has none
    (triplet kernels; fix_data schemes other than incomplete).

    Unconditional runs: the Hoeffding form from plug-in zetas of one
    Gaussian sample of min(n, 10^4) rows a class (zetas are population
    quantities; the sample's own error is a few percent). fix_data
    incomplete runs: the EXACT conditional form of the design from the
    grid variance of the kernel on the frozen dataset (drawn on
    ``device``), with G = n_pos * n_neg: float64 moments over the whole
    grid on the CPU, which fix_data's small datasets afford.
    """
    if get_kernel(cfg.kernel).kind != "diff":
        return None
    n1, n2 = cfg.n_pos, cfg.n_neg
    if cfg.fix_data:
        if cfg.scheme != "incomplete":
            return None
        s1, s2 = fixed_dataset(cfg, device)
        grid_var = closed.two_sample_zetas(cfg.kernel, s1, s2)[2]
        return closed.conditional_incomplete_variance(
            grid_var, n1 * n2, n_pairs=cfg.n_pairs, design=cfg.design)
    z = _zetas(cfg.kernel, min(n1, _ZETA_N), min(n2, _ZETA_N),
               cfg.separation, cfg.seed)
    if cfg.scheme == "complete":
        return closed.two_sample_variance_from_zetas(z, n1, n2)
    if cfg.scheme == "local":
        return closed.local_variance_from_zetas(z, n1, n2,
                                                n_workers=cfg.n_workers)
    if cfg.scheme == "repartitioned":
        return closed.repartitioned_variance_from_zetas(
            z, n1, n2, n_workers=cfg.n_workers, n_rounds=cfg.n_rounds)
    return closed.incomplete_variance_from_zetas(
        z, n1, n2, n_pairs=cfg.n_pairs, design=cfg.design)


def run_variance_experiment(
    cfg: VarianceConfig,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    trace_dir: Optional[str] = None,
    chaos=None,
    heal_retries: int = 2,
    *,
    device=None,
) -> dict:
    """M-rep Monte-Carlo: mean, empirical variance and wall-clock, beside
    the closed-form variance (None where there is none), the config and
    a ``recovery`` block (the rep a resumed run started from, the
    healer's ``reshard_events`` and ``retries_total``, ``mesh_workers``
    of a mesh config, and ``chaos.snapshot()`` when chaos is given).

    Checkpoint/resume: with ``checkpoint_path``, reps run in chunks of
    ``checkpoint_every`` and the estimates so far persist after each
    chunk; an existing checkpoint resumes from its saved rep count
    (cfg.n_reps may grow across resumes; every other field must match).
    Accumulated wall-clock carries across resumes. The kernels are built
    before the clock starts, and each chunk's clock stops after its
    estimates reach the host.

    ``chaos`` and ``heal_retries``: see the module docstring; a chunk is
    retried at most ``heal_retries`` times. ``trace_dir``: a
    ``torch.profiler`` trace of the sweep written there (the result
    carries ``trace_dir``).
    """
    _validate(cfg)
    dev = resolve_device(device)
    looped = _looped(cfg)
    start, ck = resume_progress(checkpoint_path, cfg.to_json(),
                                progress_key="n_reps", requested=cfg.n_reps)
    parts, wallclock = [], 0.0
    if ck is not None:
        parts = [ck["extra"]["estimates"]]
        wallclock = float(ck["extra"]["wallclock_s"])
    if dev.type == "cuda":
        pair_kernels.load_library()
        rank_count.load_library()
    mesh = (make_mesh(cfg.n_workers, dev) if cfg.backend == "mesh"
            else None)
    # the runner lives in a rebuildable cell: a heal rebuilds it on the
    # healed mesh mid-sweep
    state = {}

    def build(m):
        if m is not None:
            state["run"] = mesh_mc.make_mesh_mc_runner(cfg, mesh=m,
                                                       chaos=chaos)
        elif looped:
            est = Estimator(cfg.kernel, backend=cfg.backend, device=dev,
                            n_workers=cfg.n_workers)
            state["run"] = lambda reps: np.asarray(
                [_estimate_once(est, cfg, r) for r in reps])
        else:
            state["run"] = lambda reps: batched_estimates(
                cfg, dev, reps).cpu().numpy()

    build(mesh)
    healer = None
    if heal_retries:
        healer = MeshHealer(
            mesh, fixed_width=None if mesh is None else cfg.n_workers,
            pool=None if mesh is None else mesh.pool, chaos=chaos,
            backoff=Backoff(seed=cfg.seed))

    def on_heal(h):
        if h.mesh is not None:
            build(h.mesh)

    with trace(trace_dir):
        for m, chunk in iter_chunks(start, cfg.n_reps, checkpoint_every):
            def attempt(m=m, chunk=chunk):
                if chaos is not None:
                    chaos.fire("mc_chunk")
                t0 = time.perf_counter()
                # a named range a chunk, so a trace attributes time to
                # rep ranges
                with annotate(f"mc_reps[{m}:{m + chunk}]"):
                    out = state["run"](range(m, m + chunk))
                return out, time.perf_counter() - t0

            if healer is not None:
                out, secs = healer.run(attempt, retries=heal_retries,
                                       on_heal=on_heal)
            else:
                out, secs = attempt()
            wallclock += secs
            parts.append(out)
            if checkpoint_path:
                save_checkpoint(
                    checkpoint_path, step=m + chunk,
                    extra={"estimates": np.concatenate(parts),
                           "wallclock_s": np.asarray(wallclock)},
                    config=cfg.to_json(),
                )
                if chaos is not None:
                    # durable-state preemption point: a 'sigkill' here
                    # dies with exactly m + chunk reps recoverable
                    chaos.fire("checkpoint")
    est = np.concatenate(parts) if parts else np.empty(0)
    recovery = {"resumed_from": int(start),
                "reshard_events": healer.reshard_events if healer else 0,
                "retries_total": healer.retries_total if healer else 0,
                "mesh_workers": (None if mesh is None else
                                 healer.n_workers if healer else
                                 mesh.n_workers)}
    if chaos is not None:
        recovery["chaos"] = chaos.snapshot()
    result = {
        "config": cfg.to_json(),
        "device": str(dev),
        "mean": float(np.mean(est)),
        "variance": float(np.var(est, ddof=1)),
        "std_error": float(np.std(est, ddof=1) / np.sqrt(cfg.n_reps)),
        "closed_form_variance": closed_form_variance(cfg, dev),
        "wallclock_s": wallclock,
        "n_reps": cfg.n_reps,
        "batched": not looped,
        "recovery": recovery,
    }
    if trace_dir:
        result["trace_dir"] = trace_dir
    if cfg.kernel == "auc" and cfg.dim == 1:
        result["population_value"] = true_gaussian_auc(cfg.separation)
    return result


# --------------------------------------------------------------------- #
# trade-off curves: the trade-off in the paper's title                  #
# --------------------------------------------------------------------- #

def tradeoff_vs_rounds(cfg: VarianceConfig, rounds=(1, 2, 4, 8, 16), *,
                       device=None):
    """Variance (and wall-clock) vs the number of repartitions T: the
    communication-buys-variance curve."""
    return [run_variance_experiment(
        dataclasses.replace(cfg, scheme="repartitioned", n_rounds=T),
        device=device) for T in rounds]


def tradeoff_vs_pairs(cfg: VarianceConfig,
                      pairs=(100, 1000, 10_000, 100_000), *, device=None):
    """Variance vs the sampled-tuple budget B."""
    return [run_variance_experiment(
        dataclasses.replace(cfg, scheme="incomplete", n_pairs=B),
        device=device) for B in pairs]


def tradeoff_vs_workers(cfg: VarianceConfig, workers=(2, 8, 32), *,
                        device=None):
    """Local-average variance vs the worker count N: what local averaging
    costs. The deficit over the complete floor scales ~1/m with m = n/N
    rows a worker, so sweeps should push N high enough that blocks get
    small."""
    bad = [N for N in workers if N > min(cfg.n_pos, cfg.n_neg)]
    if bad:
        # validate the whole sweep BEFORE spending compute on any of it
        raise ValueError(
            f"worker counts {bad} exceed the per-class sample size "
            f"({cfg.n_pos}, {cfg.n_neg}); every worker needs at least "
            f"one row per class"
        )
    return [run_variance_experiment(
        dataclasses.replace(cfg, scheme="local", n_workers=N),
        device=device) for N in workers]


def write_jsonl(results, path: str) -> None:
    """Append results (a list of dicts) as JSON lines."""
    with open(path, "a") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
