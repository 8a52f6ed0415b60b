"""Statistical health of the streaming estimate.

A copy of ``EstimateHealth`` and ``DriftDetector`` from
``tuplewise_tpu.obs.health`` (host code on numpy):

* :class:`EstimateHealth` — online variance and CI width of the
  streaming incomplete-U estimator's kernel terms: Welford's centred
  update (Chan et al.'s pairwise merge per batch), so the variance stays
  accurate when the terms hover near a constant. The i.i.d. width is the
  optimistic bound; the width from per-batch means honours within-batch
  correlation.
* :class:`DriftDetector` — a rolling mean of |live - oracle| between the
  budgeted estimate and the exact index, alerting above a threshold.
* :func:`shard_balance` — skew statistics over the per-shard occupancy
  of the mesh form of serving.
"""

from __future__ import annotations

import collections
import math
from typing import List, Optional

import numpy as np

# two-sided normal critical values; anything else falls back to 95%
_Z = {0.90: 1.6448536269514722, 0.95: 1.959963984540054,
      0.99: 2.5758293035489004}


class EstimateHealth:
    """Online variance / CI width of the streaming estimate's kernel
    terms, fed one batch of ``h`` values at a time by
    ``StreamingIncompleteU.extend``.

    Args:
      confidence: two-sided CI level (0.90 / 0.95 / 0.99).
      metrics: optional ``MetricsRegistry`` receiving the live gauges
        ``estimate_ci_width`` / ``estimate_std_error`` /
        ``estimate_variance`` / ``estimate_terms``.
      retain_terms: keep every term so :meth:`offline_check` can
        recompute the moments with numpy (validation only: memory grows
        without bound).
    """

    def __init__(self, confidence: float = 0.95, metrics=None,
                 retain_terms: bool = False):
        if not 0.0 < confidence < 1.0:
            raise ValueError(
                f"confidence must be in (0, 1): {confidence}")
        self.confidence = confidence
        self.z = _Z.get(round(confidence, 2), _Z[0.95])
        # Welford state over individual kernel terms
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        # Welford state over per-batch means
        self.n_batches = 0
        self.batch_mean = 0.0
        self.batch_m2 = 0.0
        self._terms: Optional[List[np.ndarray]] = \
            [] if retain_terms else None
        self._g = None
        if metrics is not None:
            self.bind(metrics)

    def bind(self, metrics) -> None:
        """Attach the registry the live gauges land in."""
        self._g = {
            "ci": metrics.gauge("estimate_ci_width"),
            "se": metrics.gauge("estimate_std_error"),
            "var": metrics.gauge("estimate_variance"),
            "n": metrics.gauge("estimate_terms"),
        }

    def update(self, h: np.ndarray, s1: Optional[float] = None,
               s2: Optional[float] = None) -> None:
        """Fold one batch of kernel terms in: batch moments from the sum
        and sum of squares, then an O(1) centred merge into the global
        state. ``s1``/``s2``: precomputed ``sum(h)`` / ``sum(h*h)``."""
        h = np.asarray(h, dtype=np.float64).ravel()
        k = h.size
        if k == 0:
            return
        if s1 is None:
            s1 = float(h.sum())
        if s2 is None:
            s2 = float((h * h).sum())
        bm = s1 / k
        bm2 = max(s2 - k * bm * bm, 0.0)
        d = bm - self.mean
        n = self.n + k
        self.m2 += bm2 + d * d * self.n * k / n
        self.mean += d * k / n
        self.n = n
        self.n_batches += 1
        d = bm - self.batch_mean
        self.batch_mean += d / self.n_batches
        self.batch_m2 += d * (bm - self.batch_mean)
        if self._terms is not None:
            self._terms.append(h.copy())
        if self._g is not None:
            self._g["ci"].set(self.ci_width() or 0.0)
            self._g["se"].set(self.std_error() or 0.0)
            self._g["var"].set(self.variance() or 0.0)
            self._g["n"].set(self.n)

    def variance(self) -> Optional[float]:
        """Sample variance of the kernel terms (ddof=1)."""
        if self.n < 2:
            return None
        return self.m2 / (self.n - 1)

    def std_error(self) -> Optional[float]:
        """i.i.d. standard error of the running mean (optimistic)."""
        v = self.variance()
        if v is None:
            return None
        return math.sqrt(v / self.n)

    def ci_width(self) -> Optional[float]:
        """Full width (2 * half-width) of the two-sided i.i.d. CI."""
        se = self.std_error()
        if se is None:
            return None
        return 2.0 * self.z * se

    def batch_std_error(self) -> Optional[float]:
        """Standard error from per-batch means (batches are the
        independent units under the micro-batch semantics)."""
        if self.n_batches < 2:
            return None
        var = self.batch_m2 / (self.n_batches - 1)
        return math.sqrt(var / self.n_batches)

    def batch_ci_width(self) -> Optional[float]:
        se = self.batch_std_error()
        if se is None:
            return None
        return 2.0 * self.z * se

    def state(self) -> dict:
        return {
            "n_terms": self.n,
            "n_batches": self.n_batches,
            "mean": self.mean if self.n else None,
            "variance": self.variance(),
            "std_error": self.std_error(),
            "ci_width": self.ci_width(),
            "batch_std_error": self.batch_std_error(),
            "batch_ci_width": self.batch_ci_width(),
            "confidence": self.confidence,
        }

    def offline_check(self) -> dict:
        """Recompute mean, variance and CI width from the retained terms
        with numpy, beside the online values and their absolute gaps.
        Requires ``retain_terms=True``."""
        if self._terms is None:
            raise RuntimeError(
                "offline_check() needs retain_terms=True")
        h = (np.concatenate(self._terms) if self._terms
             else np.empty(0))
        out = {"n_terms": int(h.size), "online": self.state()}
        if h.size < 2:
            out["offline"] = None
            return out
        var = float(np.var(h, ddof=1))
        se = math.sqrt(var / h.size)
        out["offline"] = {
            "mean": float(h.mean()),
            "variance": var,
            "std_error": se,
            "ci_width": 2.0 * self.z * se,
        }
        out["abs_err"] = {
            "mean": abs(out["offline"]["mean"] - self.mean),
            "variance": abs(out["offline"]["variance"]
                            - (self.variance() or 0.0)),
            "ci_width": abs(out["offline"]["ci_width"]
                            - (self.ci_width() or 0.0)),
        }
        return out


class DriftDetector:
    """Rolling |live - oracle| monitor of the budgeted estimate.

    Args:
      window: observations in the rolling window.
      threshold: rolling mean absolute gap that counts as drift.
      min_fill: observations required before the detector may fire
        (default: a full window).
      metrics: optional registry receiving ``estimate_drift`` and
        ``drift_alerts_total``.
      flight: optional ``FlightRecorder`` receiving one ``health_drift``
        event per transition into drift.
    """

    def __init__(self, window: int = 256, threshold: float = 0.05,
                 min_fill: Optional[int] = None, metrics=None,
                 flight=None):
        if window < 1:
            raise ValueError(f"window must be >= 1: {window}")
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0: {threshold}")
        self.window = window
        self.threshold = threshold
        self.min_fill = window if min_fill is None else min_fill
        self._gaps = collections.deque(maxlen=window)
        self._sum = 0.0
        self.drifting = False
        self.alerts = 0
        self.flight = flight
        self._g_drift = None
        self._c_alerts = None
        if metrics is not None:
            self._g_drift = metrics.gauge("estimate_drift")
            self._c_alerts = metrics.counter("drift_alerts_total")

    def observe(self, live: float, oracle: float) -> bool:
        """One (live estimate, oracle value) pair; True on the
        transition into drift."""
        gap = abs(float(live) - float(oracle))
        if len(self._gaps) == self.window:
            self._sum -= self._gaps[0]
        self._gaps.append(gap)
        self._sum += gap
        rolling = self._sum / len(self._gaps)
        if self._g_drift is not None:
            self._g_drift.set(rolling)
        was = self.drifting
        self.drifting = (len(self._gaps) >= self.min_fill
                         and rolling > self.threshold)
        fired = self.drifting and not was
        if fired:
            self.alerts += 1
            if self._c_alerts is not None:
                self._c_alerts.inc()
            if self.flight is not None:
                self.flight.record(
                    "health_drift", rolling_gap=rolling,
                    threshold=self.threshold, window=len(self._gaps))
        return fired

    @property
    def rolling_gap(self) -> Optional[float]:
        if not self._gaps:
            return None
        return self._sum / len(self._gaps)

    def state(self) -> dict:
        return {
            "rolling_gap": self.rolling_gap,
            "threshold": self.threshold,
            "window": self.window,
            "filled": len(self._gaps),
            "drifting": self.drifting,
            "alerts": self.alerts,
        }


def shard_balance(counts) -> dict:
    """Skew statistics over per-shard occupancy counts (a copy of the JAX
    function): ``skew`` = max / mean (1.0 is perfect balance; the
    contiguous-slice placement keeps it within 1 + 1/per), ``cv`` the
    population coefficient of variation."""
    c = np.asarray(list(counts), dtype=np.float64)
    if c.size == 0 or c.sum() == 0:
        return {"shards": int(c.size), "max": 0, "min": 0,
                "mean": 0.0, "skew": 1.0, "cv": 0.0}
    mean = float(c.mean())
    return {
        "shards": int(c.size),
        "max": int(c.max()),
        "min": int(c.min()),
        "mean": mean,
        "skew": float(c.max() / mean) if mean else 1.0,
        "cv": float(c.std() / mean) if mean else 0.0,
    }
