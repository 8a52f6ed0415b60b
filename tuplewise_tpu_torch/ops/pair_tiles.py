"""Tiled tuplewise reductions in plain PyTorch (the estimation half of
``tuplewise_tpu.ops.pair_tiles``).

The pair grid is never materialised: ``pair_stats`` walks it in
(tile_a x tile_b) blocks. Reductions are mask- and id-aware: masks make
padded packings exact, and ids exclude cells whose original indices
coincide (the one-sample diagonal and with-replacement duplicates).

Numerics: each tile's kernel values are summed in float64, and the pair
count is an exact int64. This replaces the JAX package's Kahan float32
sum and split int32 counter, which exist because the TPU has neither
type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pair_stats(
    kernel,
    A: torch.Tensor,
    B: torch.Tensor,
    mask_a: Optional[torch.Tensor] = None,
    mask_b: Optional[torch.Tensor] = None,
    ids_a: Optional[torch.Tensor] = None,
    ids_b: Optional[torch.Tensor] = None,
    *,
    tile_a: int = 1024,
    tile_b: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, count) of h over the masked A x B grid, streamed in tiles.

    A, B: [n1(, d)], [n2(, d)] score vectors or feature matrices.
    mask_a/mask_b: optional float weights (usually {0,1}).
    ids_a/ids_b: optional int original-index arrays; cells with
      ids_a[i] == ids_b[j] are excluded.

    Returns (weighted sum as a float64 0-d tensor, count as an int64
    0-d tensor); the caller divides.
    """
    dev = A.device
    total = torch.zeros((), dtype=torch.float64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    n1, n2 = A.shape[0], B.shape[0]
    weighted = mask_a is not None or mask_b is not None or ids_a is not None
    for i0 in range(0, n1, tile_a):
        a = A[i0:i0 + tile_a]
        for j0 in range(0, n2, tile_b):
            b = B[j0:j0 + tile_b]
            vals = kernel.pair_matrix(a, b)
            if not weighted:
                total += vals.sum(dtype=torch.float64)
                count += vals.numel()
                continue
            w = torch.ones_like(vals)
            if mask_a is not None:
                w = w * mask_a[i0:i0 + tile_a, None].to(vals.dtype)
            if mask_b is not None:
                w = w * mask_b[None, j0:j0 + tile_b].to(vals.dtype)
            if ids_a is not None:
                w = w * (ids_a[i0:i0 + tile_a, None]
                         != ids_b[None, j0:j0 + tile_b]).to(vals.dtype)
            total += (vals * w).sum(dtype=torch.float64)
            count += (w > 0).sum()
    return total, count


def pair_mean(kernel, A, B, **kw) -> torch.Tensor:
    s, c = pair_stats(kernel, A, B, **kw)
    return s / c.to(torch.float64)


def sample_pair_indices(gen: torch.Generator, n1: int, n2: int,
                        n_pairs: int, one_sample: bool,
                        batch: Tuple[int, ...] = ()):
    """B tuple indices drawn uniformly with replacement from the grid;
    one-sample draws j from the off-diagonal (j != i) by the shift
    trick. Leading ``batch`` dims draw independent sets."""
    dev = gen.device
    i = torch.randint(0, n1, (*batch, n_pairs), generator=gen, device=dev)
    if one_sample:
        j = torch.randint(0, n2 - 1, (*batch, n_pairs), generator=gen,
                          device=dev)
        j = torch.where(j >= i, j + 1, j)
    else:
        j = torch.randint(0, n2, (*batch, n_pairs), generator=gen, device=dev)
    return i, j


def incomplete_pair_mean(kernel, gen, A, B, n_pairs: int,
                         one_sample: bool) -> torch.Tensor:
    """Mean of h over B tuples drawn with replacement (float64 0-d)."""
    i, j = sample_pair_indices(gen, A.shape[0], B.shape[0], n_pairs,
                               one_sample)
    return kernel.pair_elementwise(A[i], B[j]).mean(dtype=torch.float64)
