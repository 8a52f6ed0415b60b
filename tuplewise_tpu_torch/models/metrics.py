"""Evaluation metrics (numpy only).

Rank-based AUC (Mann-Whitney with midrank tie handling), a copy of
``tuplewise_tpu.models.metrics``: an O(n log n) oracle for the O(n1*n2)
AUC U-statistic.
"""

from __future__ import annotations

import numpy as np


def auc_score(pos_scores: np.ndarray, neg_scores: np.ndarray) -> float:
    """AUC = P(s_pos > s_neg) + 0.5 P(s_pos = s_neg), via midranks."""
    pos = np.asarray(pos_scores).ravel()
    neg = np.asarray(neg_scores).ravel()
    n1, n2 = len(pos), len(neg)
    allv = np.concatenate([pos, neg])
    order = np.argsort(allv, kind="mergesort")
    ranks = np.empty(len(allv))
    ranks[order] = np.arange(1, len(allv) + 1)
    # midranks for ties
    sorted_v = allv[order]
    i = 0
    while i < len(sorted_v):
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    rank_sum_pos = ranks[:n1].sum()
    return float((rank_sum_pos - n1 * (n1 + 1) / 2.0) / (n1 * n2))
