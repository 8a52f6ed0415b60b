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
