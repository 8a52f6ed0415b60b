"""L4 — Monte-Carlo variance harness (the counterpart of
``tuplewise_tpu.harness.variance``).

Repeat an estimator M times over fresh Gaussian score draws and fresh
partitions, and report the empirical mean and variance beside the
Hoeffding closed form — the measurement behind the paper's
variance-vs-communication curves.

The M reps are a batch axis, not a loop: the data of all reps is drawn
at once on the device, and each local round of all reps and all workers
is ONE batched pair-kernel launch over [M * N, m] blocks (a complete
statistic is one launch over [M, n]). This replaces the JAX harness's
vmap, and with it the dense shortcut for small worker grids: the batched
kernel takes any block size.

The port runs the score-difference kernels and the four schemes
(incomplete with the "swr" design). Checkpoint/resume, chaos injection,
fixed-data conditional runs and the mesh runner are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from tuplewise_tpu_torch.data.synthetic import make_gaussians, true_gaussian_auc
from tuplewise_tpu_torch.estimators import variance as closed
from tuplewise_tpu_torch.ops import pair_kernels, pair_tiles
from tuplewise_tpu_torch.ops.kernels import get_kernel
from tuplewise_tpu_torch.parallel.device_partition import draw_blocks
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.rng import generator

SCHEMES = ("complete", "local", "repartitioned", "incomplete")


@dataclasses.dataclass(frozen=True)
class VarianceConfig:
    """One variance experiment."""

    kernel: str = "auc"
    scheme: str = "complete"          # complete | local | repartitioned | incomplete
    n_pos: int = 10_000
    n_neg: int = 10_000
    separation: float = 1.0
    n_workers: int = 8
    n_rounds: int = 1                 # T (repartitioned)
    n_pairs: int = 10_000             # B (incomplete)
    design: str = "swr"               # incomplete tuple design
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
    if get_kernel(cfg.kernel).kind != "diff":
        raise NotImplementedError(
            "the port's harness runs score-difference kernels only"
        )
    if (cfg.scheme in ("local", "repartitioned")
            and cfg.n_workers > min(cfg.n_pos, cfg.n_neg)):
        raise ValueError(
            f"n_workers={cfg.n_workers} exceeds the per-class sample "
            f"size ({cfg.n_pos}, {cfg.n_neg}); every worker needs at "
            f"least one row per class"
        )
    if cfg.scheme == "incomplete" and cfg.design != "swr":
        raise NotImplementedError(
            f"design={cfg.design!r} is not ported yet; only 'swr' runs"
        )


def batched_estimates(cfg: VarianceConfig, device=None) -> torch.Tensor:
    """[n_reps] float64 estimates of cfg's scheme, every rep batched."""
    _validate(cfg)
    dev = resolve_device(device)
    kernel = get_kernel(cfg.kernel)
    M, n1, n2, N = cfg.n_reps, cfg.n_pos, cfg.n_neg, cfg.n_workers
    g = generator(cfg.seed, "data", device=dev)
    s1 = torch.randn(M, n1, generator=g, device=dev) + cfg.separation
    s2 = torch.randn(M, n2, generator=g, device=dev)

    def local_round(t):
        gen = generator(cfg.seed, "partition", t, device=dev)
        i1 = draw_blocks(gen, n1, N, cfg.partition_scheme, batch=(M,))
        i2 = draw_blocks(gen, n2, N, cfg.partition_scheme, batch=(M,))
        m1, m2 = i1.shape[-1], i2.shape[-1]
        b1 = torch.gather(s1, 1, i1.reshape(M, N * m1)).reshape(M * N, m1)
        b2 = torch.gather(s2, 1, i2.reshape(M, N * m2)).reshape(M * N, m2)
        sums = pair_kernels.pair_sum(b1, b2, kernel)
        return (sums / float(m1 * m2)).reshape(M, N).mean(dim=1)

    if cfg.scheme == "complete":
        return pair_kernels.pair_sum(s1, s2, kernel) / float(n1 * n2)
    if cfg.scheme == "local":
        return local_round(0)
    if cfg.scheme == "repartitioned":
        return sum(local_round(t) for t in range(cfg.n_rounds)) / cfg.n_rounds
    gen = generator(cfg.seed, "pairs", device=dev)
    i, j = pair_tiles.sample_pair_indices(gen, n1, n2, cfg.n_pairs, False,
                                          batch=(M,))
    vals = kernel.diff(torch.gather(s1, 1, i) - torch.gather(s2, 1, j))
    return vals.mean(dim=1, dtype=torch.float64)


@functools.lru_cache(maxsize=16)
def _zetas(kernel: str, n_pos: int, n_neg: int, separation: float, seed: int):
    X, Y = make_gaussians(n_pos, n_neg, 1, separation, seed=seed)
    return closed.two_sample_zetas(kernel, X[:, 0], Y[:, 0])


def closed_form_variance(cfg: VarianceConfig) -> float:
    """The Hoeffding closed form of cfg's scheme, from plug-in zetas of
    one Gaussian sample of cfg's sizes."""
    z = _zetas(cfg.kernel, cfg.n_pos, cfg.n_neg, cfg.separation, cfg.seed)
    n1, n2 = cfg.n_pos, cfg.n_neg
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


def run_variance_experiment(cfg: VarianceConfig, device=None) -> dict:
    """M-rep Monte-Carlo: mean, empirical variance and wall-clock of the
    batched run, beside the closed-form variance. The kernels are built
    before the clock starts, and the clock stops after a synchronize."""
    _validate(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        pair_kernels.load_library()
    t0 = time.perf_counter()
    est = batched_estimates(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    est = est.cpu().numpy()
    result = {
        "config": cfg.to_json(),
        "device": str(dev),
        "mean": float(np.mean(est)),
        "variance": float(np.var(est, ddof=1)),
        "std_error": float(np.std(est, ddof=1) / np.sqrt(cfg.n_reps)),
        "closed_form_variance": closed_form_variance(cfg),
        "wallclock_s": seconds,
        "n_reps": cfg.n_reps,
    }
    if cfg.kernel == "auc":
        result["population_value"] = true_gaussian_auc(cfg.separation)
    return result
