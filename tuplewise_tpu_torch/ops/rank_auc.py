"""O(n log n) exact complete AUC — the rank (Mann-Whitney) form.

One sort of the negatives and two binary searches per positive give, for
each positive, the count of negatives below it and the count tied with
it. The port sums ``2 * less + ties`` in int64, so the statistic is
exact: the CUDA pair kernel's AUC (also exact, see ops.pair_kernels)
equals this value bit for bit at any size, which makes this the
independent oracle for the kernel at full size.
"""

from __future__ import annotations

import torch


def rank_auc_counts(pos_scores: torch.Tensor,
                    neg_scores: torch.Tensor) -> torch.Tensor:
    """2 * wins + ties over all (pos, neg) pairs, an exact int64 0-d
    tensor on the inputs' device."""
    pos = pos_scores.reshape(-1)
    neg = torch.sort(neg_scores.reshape(-1)).values
    less = torch.searchsorted(neg, pos, right=False)
    leq = torch.searchsorted(neg, pos, right=True)
    return (less + leq).sum()


def rank_auc(pos_scores: torch.Tensor,
             neg_scores: torch.Tensor) -> torch.Tensor:
    """AUC = P(s_pos > s_neg) + 0.5 P(s_pos = s_neg), as a float64 0-d
    tensor on the inputs' device. On the card the division by the
    Python count multiplies by its reciprocal (PyTorch's scalar
    divisor), which may leave the last bit off the correctly rounded
    quotient of ``rank_auc_counts`` and 2 n1 n2."""
    twice = rank_auc_counts(pos_scores, neg_scores)
    return twice.to(torch.float64) / float(2 * pos_scores.numel()
                                           * neg_scores.numel())
