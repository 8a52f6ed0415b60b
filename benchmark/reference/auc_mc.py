"""Plain reference of the mesh Monte-Carlo's AUC estimates.

What it works out again from the seed, as the port's runner
(``harness/mesh_mc.py``) derives it: a rep's rows. Worker w draws
``cap = ceil(n / N)`` standard normals of each class, positives first,
from the generator of the chain (seed, "mc_rep", rep, "shard", w); the
positives are shifted by the separation; worker w holds global rows
[w cap, (w + 1) cap) and the rows at n and past it are padding, left
out. What a scheme makes of them is in ``auc_<scheme>.py``, found by the
traffic's ``runner["scheme"]``: each has ``estimate(a, b, *, seed, rep,
n_workers, runner)``.

The AUC of a set of pairs is counted exactly: 2 #{a > b} + #{a == b}
by a sort of one side and two binary searches of the other, summed in
int64, halved and divided on the host in float64.

``dtype`` rounds the rows to a lower precision before counting: the
control that the comparison must fail.
"""

from __future__ import annotations

import importlib
import math

import torch

from benchmark.reference.rng import generator


def rep_rows(seed: int, rep: int, n1: int, n2: int, n_workers: int,
             separation: float, device):
    """(a [n1], b [n2]) float32: rep ``rep``'s rows in global order."""
    caps = [-(-n // n_workers) for n in (n1, n2)]
    a = torch.empty(n_workers, caps[0], device=device)
    b = torch.empty(n_workers, caps[1], device=device)
    for w in range(n_workers):
        g = generator(seed, "mc_rep", rep, "shard", w, device=device)
        a[w] = torch.randn((caps[0],), generator=g, device=device)
        b[w] = torch.randn((caps[1],), generator=g, device=device)
    a += separation
    return a.reshape(-1)[:n1], b.reshape(-1)[:n2]


def twice_wins(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int64 [...]: 2 #{a_i > b_j} + #{a_i == b_j} of each problem, for
    a [..., n1] and b [..., n2]."""
    bs = torch.sort(b, dim=-1).values.contiguous()
    below = torch.searchsorted(bs, a.contiguous(), side="left")
    at_or_below = torch.searchsorted(bs, a.contiguous(), side="right")
    return (below + at_or_below).sum(-1)


def partition_round(a, b, seed: int, chain, n_workers: int) -> float:
    """One partitioned round: a permutation of each class from the chain
    (seed, "partition", *chain), positives first, cut into N blocks of
    n // N rows (the remainder dropped); the mean over the workers of
    each worker's block AUC."""
    n1, n2 = a.numel(), b.numel()
    m1, m2 = n1 // n_workers, n2 // n_workers
    g = generator(seed, "partition", *chain, device=a.device)
    i1 = torch.randperm(n1, generator=g, device=a.device)
    i2 = torch.randperm(n2, generator=g, device=a.device)
    i1 = i1[: n_workers * m1].reshape(n_workers, m1)
    i2 = i2[: n_workers * m2].reshape(n_workers, m2)
    counts = twice_wins(a[i1], b[i2]).tolist()
    return math.fsum(c / 2 / (m1 * m2) for c in counts) / n_workers


def estimate(runner: dict, seed: int, rep: int, n1: int, n2: int,
             n_workers: int, separation: float, device,
             dtype=None) -> float:
    """Rep ``rep``'s estimate under the traffic's ``runner`` settings;
    ``dtype``: round the rows to it first."""
    if runner.get("partition_scheme", "swor") != "swor":
        raise ValueError("the reference partitions without replacement")
    a, b = rep_rows(seed, rep, n1, n2, n_workers, separation, device)
    if dtype is not None:
        a, b = a.to(dtype).float(), b.to(dtype).float()
    scheme = importlib.import_module(
        f"benchmark.reference.auc_{runner['scheme']}")
    return scheme.estimate(a, b, seed=seed, rep=rep, n_workers=n_workers,
                           runner=runner)
