"""Tiled tuplewise reductions (the counterpart of
``tuplewise_tpu.ops.pair_tiles``).

Estimation half, plain PyTorch: the pair grid is never materialised:
``pair_stats`` walks it in (tile_a x tile_b) blocks, ``triplet_stats``
the triplet grid in [anchor, positive, negative] blocks (the path of
custom triplet kernels; the built-in ones factorise through
``ops.triplet_kernels``). Reductions are
mask- and id-aware: masks make padded packings exact, and ids exclude
cells whose original indices coincide (the one-sample diagonal and
with-replacement duplicates).

Numerics: each tile's kernel values are summed in float64, and the pair
count is an exact int64. This replaces the JAX package's Kahan float32
sum and split int32 counter, which exist because the TPU has neither
type.

Gradient half: the differentiable pair mean of the learner.
``diff_pair_mean`` is a ``torch.autograd.Function`` whose forward is ONE
``pair_loss_grad`` pass (CUDA kernel on the card) and whose backward
only scales the saved row and col sums, so a training step sweeps the
pair grid once. ``diff_pair_mean_loss_free`` is its gradient-only twin
for steps whose loss is not recorded. Both take [n] or [W, n] scores.
The TPU-only gates of the JAX dispatch (the VMEM col bound and the SMEM
loss-cell budget) have no counterpart: the CUDA kernels take any size up
to their grid limits and raise beyond them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tuplewise_tpu_torch.ops import pair_grad_kernels, pair_kernels


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


def triplet_stats(
    kernel,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask_x: Optional[torch.Tensor] = None,
    mask_y: Optional[torch.Tensor] = None,
    ids_x: Optional[torch.Tensor] = None,
    *,
    positives: Optional[torch.Tensor] = None,
    mask_p: Optional[torch.Tensor] = None,
    ids_p: Optional[torch.Tensor] = None,
    tile: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, count) of h(x_i, p_j, y_k) over ids_x[i] != ids_p[j], all k,
    for any triplet kernel: the plain scan over [anchor, positive,
    negative] blocks of ``tile`` rows each.

    By default positives = X (the within-sample degree-(2,1) statistic);
    a visiting positives block (``positives``, ``mask_p``, ``ids_p``)
    serves the cross-shard form. Masks are float weights; ids default
    to the row index. Returns (float64 0-d sum, int64 0-d count of the
    cells of nonzero weight).
    """
    dev = X.device

    def weights(mask, n):
        return (torch.ones(n, dtype=X.dtype, device=dev) if mask is None
                else mask.to(X.dtype))

    def ids(given, n):
        return torch.arange(n, device=dev) if given is None else given

    mx, my = weights(mask_x, X.shape[0]), weights(mask_y, Y.shape[0])
    ix = ids(ids_x, X.shape[0])
    if positives is None:
        positives, mp, ip = X, mx, ix
    else:
        mp = weights(mask_p, positives.shape[0])
        ip = ids(ids_p, positives.shape[0])
    total = torch.zeros((), dtype=torch.float64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    for a0 in range(0, X.shape[0], tile):
        a = X[a0:a0 + tile, None, None, :]
        wa = mx[a0:a0 + tile, None]
        ia = ix[a0:a0 + tile, None]
        for p0 in range(0, positives.shape[0], tile):
            p = positives[None, p0:p0 + tile, None, :]
            # [ta, tp] anchor-positive weights with the id exclusion
            wap = wa * mp[None, p0:p0 + tile] * (ia != ip[None, p0:p0 + tile])
            for k0 in range(0, Y.shape[0], tile):
                vals = kernel.triplet_values(a, p, Y[None, None, k0:k0 + tile])
                w = wap[:, :, None] * my[None, None, k0:k0 + tile]
                total += (vals * w).sum(dtype=torch.float64)
                count += (w > 0).sum()
    return total, count


def incomplete_triplet_mean(kernel, gen, X, Y, n_pairs: int) -> torch.Tensor:
    """Mean of h over B triplets drawn with replacement: (i, j) from the
    off-diagonal of X by the shift trick, k uniform over Y (float64 0-d)."""
    i, j = sample_pair_indices(gen, X.shape[0], X.shape[0], n_pairs, True)
    k = torch.randint(0, Y.shape[0], (n_pairs,), generator=gen,
                      device=gen.device)
    return kernel.triplet_values(X[i], X[j], Y[k]).mean(dtype=torch.float64)


# --------------------------------------------------------------------- #
# Analytic pairwise-loss gradient                                        #
# --------------------------------------------------------------------- #

def pair_grad_sums(kernel, s1, s2):
    """(row, col) sums of g'(s1_i - s2_j) over the full grid, streamed
    in plain PyTorch: row[i] = sum_j g'(d_ij), col[j] = sum_i g'(d_ij)."""
    return pair_grad_kernels.pair_grad_sums_plain(s1, s2, kernel)


def grad_sums_best(kernel, s1, s2, impl: Optional[str] = None):
    """(row, col) g' sums through the gradient-only CUDA kernel on the
    card (the plain version on the CPU or with ``impl="plain"``), in the
    inputs' dtypes."""
    row, col = pair_grad_kernels.pair_grad_sums(s1, s2, kernel, impl=impl)
    return row.to(s1.dtype), col.to(s2.dtype)


def _grad_inputs(ctx, ct):
    """d/ds1 = +ct/count * row, d/ds2 = -ct/count * col (the -1 of
    d = s1 - s2); ct has the value's shape, [] or [W]."""
    row, col = ctx.saved_tensors
    inv = (ct / float(row.shape[-1] * col.shape[-1]))[..., None]
    return inv * row, -inv * col, None, None


class DiffPairMean(torch.autograd.Function):
    """Forward: one ``pair_loss_grad`` pass; its row and col sums are the
    backward's residuals, so the backward costs O(n)."""

    @staticmethod
    def forward(ctx, s1, s2, kernel, impl):
        s, row, col = pair_grad_kernels.pair_loss_grad(s1, s2, kernel,
                                                       impl=impl)
        ctx.save_for_backward(row.to(s1.dtype), col.to(s2.dtype))
        return (s / float(s1.shape[-1] * s2.shape[-1])).to(s1.dtype)

    @staticmethod
    def backward(ctx, ct):
        return _grad_inputs(ctx, ct)


class DiffPairMeanLossFree(torch.autograd.Function):
    """Forward: one g'-only pass (``grad_sums_best``); NaN value."""

    @staticmethod
    def forward(ctx, s1, s2, kernel, impl):
        ctx.save_for_backward(*grad_sums_best(kernel, s1, s2, impl))
        return torch.full(s1.shape[:-1], float("nan"), dtype=s1.dtype,
                          device=s1.device)

    @staticmethod
    def backward(ctx, ct):
        return _grad_inputs(ctx, ct)


def diff_pair_mean(kernel, s1, s2, impl: Optional[str] = None):
    """Mean of g(s1_i - s2_j) over the full grid ([n] inputs give a 0-d
    value, [W, n] inputs a [W] one), differentiable through the analytic
    g'. Its value and gradient match autograd through the dense mean
    (hinge: up to the measure-zero kink at d == 1)."""
    return DiffPairMean.apply(s1, s2, kernel, impl)


def diff_pair_mean_loss_free(kernel, s1, s2, impl: Optional[str] = None):
    """Gradient-only sibling of :func:`diff_pair_mean`: the VALUE is NaN
    (never computed; for steps whose loss is not recorded), the gradient
    is identical to diff_pair_mean's."""
    return DiffPairMeanLossFree.apply(s1, s2, kernel, impl)


def pair_mean_for_grad(kernel, s1, s2, impl: Optional[str] = None):
    """Pair mean with the best gradient path: the analytic g' function
    when the kernel declares one (CUDA kernels on the card when it also
    has a CUDA body, the plain sweep otherwise), else autograd through
    the plain tiled mean (which keeps every tile for the backward)."""
    if kernel.kind == "diff" and kernel.diff_grad_fn is not None:
        return diff_pair_mean(kernel, s1, s2, impl)
    if kernel.kind == "diff":
        count = float(s1.shape[-1] * s2.shape[-1])
        return (pair_kernels.pair_sum_plain(s1, s2, kernel) / count).to(s1.dtype)
    return pair_mean(kernel, s1, s2).to(s1.dtype)
