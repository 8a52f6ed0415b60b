"""Exact O(n d) scatter statistics (the counterpart of
``tuplewise_tpu.ops.scatter_exact``).

The scatter kernel h(x, x') = ||x - x'||^2 / 2 is a polynomial, so its
masked pair sum factorizes into first and second moments:

    sum_{ij} ma_i mb_j h(a_i, b_j)
      = [ (sum ma |a|^2)(sum mb) + (sum mb |b|^2)(sum ma) ] / 2
        - (sum ma a) . (sum mb b)

Id exclusion changes only the count: id-equal cells are the same
original row, so their h is 0, and count = (sum ma)(sum mb) - sum_v c(v)^2
over the per-id multiplicities of the valid entries.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tuplewise_tpu_torch.ops.kernels import Kernel, scatter_kernel


def is_builtin_scatter(kernel: Kernel) -> bool:
    """True when ``kernel`` evaluates the built-in scatter h (pair_fn
    identity, so a shadowing custom kernel never matches)."""
    return kernel.kind == "pair" and kernel.pair_fn is scatter_kernel.pair_fn


def scatter_pair_stats(
    A: torch.Tensor,
    B: torch.Tensor,
    mask_a: Optional[torch.Tensor] = None,
    mask_b: Optional[torch.Tensor] = None,
    ids_a: Optional[torch.Tensor] = None,
    ids_b: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, count) of the masked scatter grid as float64 0-d tensors.

    When ids are passed, both sides must carry the same (ids, mask)
    arrays, as every one-sample call site does; ``ids_b`` is accepted
    for signature parity and not read.
    """
    A = A.to(torch.float64)
    B = B.to(torch.float64)
    ma = (torch.ones(A.shape[0], dtype=torch.float64, device=A.device)
          if mask_a is None else mask_a.to(torch.float64))
    mb = (torch.ones(B.shape[0], dtype=torch.float64, device=B.device)
          if mask_b is None else mask_b.to(torch.float64))
    ca, cb = ma.sum(), mb.sum()
    sq_a = (torch.sum(A * A, dim=-1) * ma).sum()
    sq_b = (torch.sum(B * B, dim=-1) * mb).sum()
    mom_a = (A * ma[:, None]).sum(dim=0)
    mom_b = (B * mb[:, None]).sum(dim=0)
    total = 0.5 * (sq_a * cb + sq_b * ca) - torch.dot(mom_a, mom_b)
    count = ca * cb
    if ids_a is not None:
        _, mult = torch.unique(ids_a[ma > 0], return_counts=True)
        count = count - (mult.to(torch.float64) ** 2).sum()
    return total, count


def _moments(x, m):
    """[W, 2 + d] float64 per-worker (sum m, sum m |x|^2, sum m x)."""
    x, m = x.to(torch.float64), m.to(torch.float64)
    return torch.cat([m.sum(1, keepdim=True),
                      (torch.sum(x * x, dim=-1) * m).sum(1, keepdim=True),
                      (x * m[..., None]).sum(1)], dim=1)


def scatter_mesh_stats(a, ma, b, mb, *, comm, one_sample: bool):
    """(sum, count) of the scatter grid over all workers' blocks a
    [n_local, cap, d] (masks ma [n_local, cap]) and b, mb: per-worker
    moments, ONE float64 all-reduce (``comm.all_reduce_sum``) and the
    closed-form combine; no ring (the moments are linear, so sharding
    commutes with them). ``one_sample`` relies on the complete
    packing's distinct ids: only the diagonal is excluded, so the count
    drops sum(ma). Float64 0-d tensors, the same on every worker."""
    mom = _moments(a, ma) if one_sample else torch.cat(
        [_moments(a, ma), _moments(b, mb)], dim=1)
    tot = comm.all_reduce_sum(mom)
    d = a.shape[-1]
    ca, sq_a, mom_a = tot[0], tot[1], tot[2:2 + d]
    cb, sq_b, mom_b = ((ca, sq_a, mom_a) if one_sample
                       else (tot[2 + d], tot[3 + d], tot[4 + d:]))
    total = 0.5 * (sq_a * cb + sq_b * ca) - torch.dot(mom_a, mom_b)
    count = ca * cb - (ca if one_sample else 0.0)
    return total, count
