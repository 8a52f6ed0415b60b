"""Worker index blocks drawn on the device.

The counterpart of ``tuplewise_tpu.parallel.device_partition.draw_blocks``.
Leading ``batch`` dimensions draw independent partitions at once (one
per Monte-Carlo rep), which is how the harness batches reps instead of
vmapping them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_blocks(gen: torch.Generator, n: int, n_workers: int,
                scheme: str = "swor", m: Optional[int] = None,
                batch: Tuple[int, ...] = ()) -> torch.Tensor:
    """[*batch, N, m] int64 worker index blocks over range(n).

    swor: one permutation cut into N blocks (random remainder dropped
    when n > N*m); swr: i.i.d. uniform draws.
    """
    m = n // n_workers if m is None else m
    dev = gen.device
    if scheme == "swor":
        if batch:
            # independent permutations per batch row: argsort of float64
            # uniforms (ties have probability ~n^2 2^-53)
            u = torch.rand(*batch, n, generator=gen, device=dev,
                           dtype=torch.float64)
            idx = torch.argsort(u, dim=-1)
        else:
            idx = torch.randperm(n, generator=gen, device=dev)
        return idx[..., : n_workers * m].reshape(*batch, n_workers, m)
    if scheme == "swr":
        return torch.randint(0, n, (*batch, n_workers, m), generator=gen,
                             device=dev)
    raise ValueError(f"unknown partition scheme {scheme!r}")
