"""Streaming incomplete U-statistic: the paper's budget knob, online.

The counterpart of ``tuplewise_tpu.serving.streaming``, host code on
``np.random.default_rng(seed)`` exactly as there, so that on the same
batches the two packages draw the same partners. Each arrival spends B
kernel evaluations against the opposite class's history held in a
uniform reservoir (Vitter's Algorithm R), bounding per-request work at
O(B) whatever the stream's length, while

    U~ = (sum of h over all spent pairs) / (number of pairs spent)

stays an unbiased estimate of E[h(X, Y)]. The kernel body is the port's
torch body (``ops.kernels``) applied to a float64 CPU tensor: auc and
hinge terms equal the JAX package's, logistic ones agree to the last
bits (another ``log1p``/``exp``).

Micro-batch semantics: a batch scores against the reservoirs as of batch
start and is folded into them afterwards, so arrivals of one batch do
not pair with each other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tuplewise_tpu_torch.ops.kernels import Kernel, get_kernel


class _Reservoir:
    """Uniform fixed-capacity sample of a stream (Algorithm R)."""

    def __init__(self, capacity: int, rng: np.random.Generator):
        if capacity < 1:
            raise ValueError(f"reservoir capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self._rng = rng
        self.items = np.empty(capacity, dtype=np.float64)
        self.size = 0
        self.seen = 0

    def add_batch(self, values: np.ndarray) -> None:
        """Fold a batch in, vectorised but sequentially exact: the
        per-item slot draws j_t ~ U[0, seen_t) are independent, so one
        broadcast ``integers`` call replaces the loop, and duplicate
        accepted slots resolve last-write-wins, the sequential order."""
        values = np.asarray(values, dtype=np.float64).ravel()
        if len(values) == 0:
            return
        take = 0
        if self.size < self.capacity:           # fill phase
            take = min(self.capacity - self.size, len(values))
            self.items[self.size: self.size + take] = values[:take]
            self.size += take
            self.seen += take
        rest = values[take:]
        if len(rest) == 0:
            return
        bounds = self.seen + 1 + np.arange(len(rest))
        js = self._rng.integers(0, bounds)      # one draw per arrival
        self.seen += len(rest)
        hit = js < self.capacity
        if hit.any():
            self.items[js[hit]] = rest[hit]

    def sample(self, k: int, replace: bool = True) -> np.ndarray:
        if self.size == 0:
            return np.empty(0, dtype=np.float64)
        idx = self._rng.integers(0, self.size, size=k) if replace else \
            self._rng.choice(self.size, size=min(k, self.size),
                             replace=False)
        return self.items[idx]


class StreamingIncompleteU:
    """Per-arrival budgeted incomplete U-statistic over a score stream.

    Args:
      kernel: a two-sample score-difference kernel name or instance
        ("auc", "hinge", "logistic").
      budget: pairs spent per arrival (B).
      reservoir: per-class reservoir capacity.
      design: "swr" (partners with replacement) or "swor" (distinct
        partners per arrival, capped at reservoir occupancy).
      seed: host RNG seed; the stream is reproducible given arrival
        order and batching.
      health: optional ``obs.health.EstimateHealth`` fed every batch of
        kernel terms.
    """

    def __init__(self, kernel="auc", budget: int = 64,
                 reservoir: int = 4096, design: str = "swr",
                 seed: int = 0, health=None):
        self.kernel: Kernel = get_kernel(kernel)
        if self.kernel.kind != "diff" or not self.kernel.two_sample:
            raise ValueError(
                "StreamingIncompleteU needs a two-sample score-difference "
                f"kernel; got {self.kernel.name!r} ({self.kernel.kind})")
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        if design not in ("swr", "swor"):
            raise ValueError(f"design must be 'swr' or 'swor': {design!r}")
        self.budget = budget
        self.design = design
        self.health = health
        self._rng = np.random.default_rng(seed)
        self._pos = _Reservoir(reservoir, self._rng)
        self._neg = _Reservoir(reservoir, self._rng)
        self._sum_h = 0.0
        self._sum_h2 = 0.0
        self._n_terms = 0
        self.n_arrivals = 0

    def extend(self, scores, labels) -> int:
        """Process a micro-batch of arrivals; returns pairs spent."""
        scores = np.asarray(scores, dtype=np.float64).ravel()
        labels = np.asarray(labels).ravel().astype(bool)
        if scores.shape != labels.shape:
            raise ValueError(
                f"scores/labels length mismatch: {scores.shape} vs "
                f"{labels.shape}")
        spent = 0
        for vals, opp, flip in ((scores[labels], self._neg, False),
                                (scores[~labels], self._pos, True)):
            if len(vals) == 0 or opp.size == 0:
                continue
            if self.design == "swr":
                partners = opp.sample(len(vals) * self.budget)
                arr = np.repeat(vals, self.budget)
            else:
                chunks = [opp.sample(self.budget, replace=False)
                          for _ in range(len(vals))]
                partners = np.concatenate(chunks)
                arr = np.repeat(vals, [len(c) for c in chunks])
            # h(pos, neg) = g(s_pos - s_neg): a negative arrival pairs
            # with positive partners, so the difference flips
            d = (partners - arr) if flip else (arr - partners)
            h = self.kernel.diff(torch.from_numpy(d)).numpy()
            s1 = float(h.sum())
            s2 = float((h * h).sum())
            self._sum_h += s1
            self._sum_h2 += s2
            self._n_terms += h.size
            spent += h.size
            if self.health is not None:
                self.health.update(h, s1=s1, s2=s2)
        self._pos.add_batch(scores[labels])
        self._neg.add_batch(scores[~labels])
        self.n_arrivals += len(scores)
        return spent

    def observe(self, score: float, label) -> int:
        return self.extend([score], [label])

    @property
    def n_terms(self) -> int:
        return self._n_terms

    def estimate(self) -> Optional[float]:
        """Running U~; None until at least one pair has been spent."""
        if self._n_terms == 0:
            return None
        return self._sum_h / self._n_terms

    def std_error(self) -> Optional[float]:
        """Naive i.i.d. standard error of the running mean (terms that
        share an arrival or a reservoir slot are correlated, so this
        understates the true error)."""
        if self._n_terms < 2:
            return None
        m = self._sum_h / self._n_terms
        var = max(self._sum_h2 / self._n_terms - m * m, 0.0)
        return float(np.sqrt(var / self._n_terms))

    def state(self) -> dict:
        out = {
            "estimate": self.estimate(),
            "std_error": self.std_error(),
            "n_terms": self._n_terms,
            "n_arrivals": self.n_arrivals,
            "budget": self.budget,
            "design": self.design,
            "reservoir_pos": self._pos.size,
            "reservoir_neg": self._neg.size,
        }
        if self.health is not None:
            out["health"] = self.health.state()
        return out
