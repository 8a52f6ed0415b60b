"""Bounded backoff (the ``Backoff`` half of
``tuplewise_tpu.parallel.self_heal``; the mesh healer is not ported
yet).

``parallel.distributed.initialize`` retries a failed bring-up with it: a
restarted worker may come back before its coordinator listens.
"""

from __future__ import annotations

import time

import numpy as np


class Backoff:
    """Bounded exponential backoff with deterministic seeded jitter.

    ``delay_s(attempt)`` (1-based) is ``base_s * 2**(attempt-1)``
    capped at ``cap_s``, stretched by up to ``jitter`` fraction drawn
    from a seeded generator: deterministic per instance, decorrelated
    across instances with different seeds (retry storms from many
    workers must not re-synchronize on the failed resource).
    """

    def __init__(self, base_s: float = 0.02, cap_s: float = 1.0,
                 jitter: float = 0.25, seed: int = 0):
        if base_s < 0 or cap_s < 0:
            raise ValueError(f"backoff times must be >= 0: "
                             f"base_s={base_s}, cap_s={cap_s}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.base_s = base_s
        self.cap_s = cap_s
        self.jitter = jitter
        self._rng = np.random.default_rng(seed)

    def delay_s(self, attempt: int) -> float:
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        d = min(self.base_s * (2.0 ** (attempt - 1)), self.cap_s)
        if self.jitter:
            d *= 1.0 + self.jitter * float(self._rng.random())
        return d

    def sleep(self, attempt: int) -> None:
        time.sleep(self.delay_s(attempt))
