"""Drop-and-renormalize worker masks (the declaration half of
``tuplewise_tpu.parallel.faults``).

A dropped worker's local U-statistic is excluded and the average
renormalizes over the survivors; each survivor's value is unbiased, so
dropping raises variance only.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


def normalize_dropped(
    dropped: Iterable[int], n_workers: int
) -> Tuple[int, ...]:
    """Validate + canonicalize a dropped-worker set (sorted, unique)."""
    d = sorted(set(int(w) for w in dropped))
    if any(w < 0 or w >= n_workers for w in d):
        raise ValueError(
            f"dropped workers {d} out of range for n_workers={n_workers}"
        )
    if len(d) >= n_workers:
        raise ValueError(
            f"cannot drop all {n_workers} workers: no survivors to "
            "renormalize over"
        )
    return tuple(d)


def alive_mask(n_workers: int, dropped: Iterable[int] = ()) -> np.ndarray:
    """Float {0,1} mask over workers; mask[w] == 0 iff w is dropped."""
    d = normalize_dropped(dropped, n_workers)
    mask = np.ones(n_workers, dtype=np.float64)
    mask[list(d)] = 0.0
    return mask
