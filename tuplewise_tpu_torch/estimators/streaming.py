"""The streaming twin of ``Estimator``: one facade over the serving
layer's state machines.

The counterpart of ``tuplewise_tpu.estimators.streaming``.
``StreamingEstimator`` absorbs a stream of (score, label) events and
answers at any time:

* ``auc()``       — the exact AUC of everything observed (or of the
                    sliding window), from the incremental rank index;
* ``estimate()``  — the budgeted incomplete-U estimate of the kernel
                    mean (B pairs per arrival against reservoir history).

It is synchronous and single-threaded; the async request path around the
same state machines is ``serving.MicroBatchEngine``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tuplewise_tpu_torch.serving.index import ExactAucIndex
from tuplewise_tpu_torch.serving.streaming import StreamingIncompleteU


class StreamingEstimator:
    """Online tuplewise estimator over a scored event stream.

    Args:
      kernel: two-sample score-difference kernel ("auc", "hinge",
        "logistic"). The exact index exists only for "auc"; the other
        kernels get the incomplete estimate.
      budget: incomplete-U pairs spent per arrival.
      reservoir: per-class reservoir capacity.
      design: partner sampling design, "swr" or "swor".
      window: sliding window in arrivals for the exact index; None =
        unbounded.
      compact_every: the exact index's compaction trigger.
      engine: exact-index engine, "torch" or "numpy".
      device: where ``engine="torch"`` counts (the card unless "cpu").
      count_kernel: count through the fused kernel (see ExactAucIndex).
      seed: RNG seed of the incomplete path's partner draws.
      health: optional ``obs.health.EstimateHealth`` fed every batch of
        kernel terms.
    """

    def __init__(self, kernel: str = "auc", *, budget: int = 64,
                 reservoir: int = 4096, design: str = "swr",
                 window: Optional[int] = None, compact_every: int = 512,
                 engine: str = "torch", device=None,
                 count_kernel: bool = False, seed: int = 0, health=None):
        self.kernel_name = kernel if isinstance(kernel, str) else kernel.name
        self.index = ExactAucIndex(
            window=window, compact_every=compact_every, engine=engine,
            device=device, count_kernel=count_kernel,
        ) if self.kernel_name == "auc" else None
        self.streaming = StreamingIncompleteU(
            kernel=kernel, budget=budget, reservoir=reservoir,
            design=design, seed=seed, health=health,
        )

    def observe(self, score: float, label) -> None:
        """One event: a score and its binary label (truthy = positive)."""
        self.extend([score], [label])

    def extend(self, scores, labels) -> None:
        """A micro-batch of events, in arrival order."""
        scores = np.asarray(scores, dtype=np.float64).ravel()
        labels = np.asarray(labels).ravel().astype(bool)
        if self.index is not None:
            self.index.insert_batch(scores, labels)
        self.streaming.extend(scores, labels)

    def auc(self) -> Optional[float]:
        """Exact AUC of the observed prefix/window; None before both
        classes appear (or for non-AUC kernels)."""
        return None if self.index is None else self.index.auc()

    def estimate(self) -> Optional[float]:
        """Budgeted incomplete-U estimate of the kernel mean."""
        return self.streaming.estimate()

    def score(self, scores) -> np.ndarray:
        """Fractional rank of candidate scores against current negatives
        (AUC kernel only)."""
        if self.index is None:
            raise ValueError("score() needs the exact index (kernel='auc')")
        return self.index.score_batch(scores)

    @property
    def n_pos(self) -> int:
        return self.index.n_pos if self.index is not None else \
            self.streaming._pos.seen

    @property
    def n_neg(self) -> int:
        return self.index.n_neg if self.index is not None else \
            self.streaming._neg.seen

    def health_report(self) -> Optional[dict]:
        """The CI-width monitor's state (None without ``health``)."""
        h = self.streaming.health
        return None if h is None else h.state()

    def state(self) -> dict:
        out = {"kernel": self.kernel_name,
               "streaming": self.streaming.state()}
        if self.index is not None:
            out["index"] = self.index.state()
            out["auc"] = self.index.auc()
        out["estimate"] = self.streaming.estimate()
        return out
