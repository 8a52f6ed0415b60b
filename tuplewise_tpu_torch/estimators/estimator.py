"""L3 — the user-facing Estimator with the backend plugin boundary.

``Estimator(kernel=..., backend="torch")``: the four estimator schemes of
``tuplewise_tpu.estimators.estimator`` with the same semantics and input
convention. Score-difference kernels ("auc", "hinge", "logistic") take
1-D score arrays; feature kernels ("scatter") take [n, d] arrays, and so
do the triplet kernels ("triplet_indicator", "triplet_hinge"): A holds
the anchors and positives (one class), B the negatives. Inputs may be
numpy arrays, lists or tensors; they are moved to the backend's device
as float32.

It runs on the card unless ``device="cpu"`` is passed; with no card and
no device it raises.
"""

from __future__ import annotations

from typing import Optional

from tuplewise_tpu_torch.backends.base import get_backend
from tuplewise_tpu_torch.ops.kernels import get_kernel


class Estimator:
    """Distributed tuplewise (U-statistic) estimator.

    Args:
      kernel: kernel name or Kernel instance.
      backend: "torch" (single device).
      device: None (the card) or an explicit torch device such as "cpu".
      n_workers: default number of simulated workers N.
      **backend_opts: forwarded to the backend (impl, auc_fast).
    """

    def __init__(self, kernel="auc", backend: str = "torch", device=None,
                 n_workers: Optional[int] = None, **backend_opts):
        self.kernel = get_kernel(kernel)
        self.backend_name = backend
        self.backend = get_backend(backend, self.kernel, device=device,
                                   **backend_opts)
        self.n_workers = 1 if n_workers is None else int(n_workers)

    def _resolve_workers(self, n_workers: Optional[int]) -> int:
        n = self.n_workers if n_workers is None else n_workers
        if n < 1:
            raise ValueError(f"n_workers must be >= 1, got {n}")
        return n

    def _prep(self, A, B):
        """Validate shapes and move the inputs to the backend's device."""
        k = self.kernel
        if k.two_sample and B is None:
            raise ValueError(f"kernel {k.name!r} is two-sample: pass (A, B)")
        if not k.two_sample and B is not None:
            raise ValueError(f"kernel {k.name!r} is one-sample: pass A only")
        A = self.backend.to_device(A)
        B = None if B is None else self.backend.to_device(B)
        if k.kind == "diff":
            if A.dim() == 2 and A.shape[1] == 1:
                A = A[:, 0].contiguous()
            if B is not None and B.dim() == 2 and B.shape[1] == 1:
                B = B[:, 0].contiguous()
            if A.dim() != 1 or (B is not None and B.dim() != 1):
                shapes = [tuple(A.shape)] + ([] if B is None else [tuple(B.shape)])
                raise ValueError(
                    f"kernel {k.name!r} operates on scalar scores; got "
                    f"shapes {shapes}. Apply a scorer first."
                )
        elif A.dim() != 2 or (B is not None and B.dim() != 2):
            what = (" (A: anchors and positives, B: negatives)"
                    if k.kind == "triplet" else "")
            raise ValueError(f"kernel {k.name!r} expects [n, d] features"
                             f"{what}")
        return A, B

    # the four estimator schemes
    def complete(self, A, B=None) -> float:
        """Complete U_n — every tuple."""
        A, B = self._prep(A, B)
        return float(self.backend.complete(A, B))

    def local_average(self, A, B=None, *, seed: int = 0, scheme: str = "swor",
                      n_workers: Optional[int] = None,
                      dropped_workers: tuple = ()) -> float:
        """U^loc_N — per-worker complete U, averaged over the survivors."""
        A, B = self._prep(A, B)
        return float(self.backend.local_average(
            A, B, n_workers=self._resolve_workers(n_workers), seed=seed,
            scheme=scheme, dropped_workers=dropped_workers))

    def repartitioned(self, A, B=None, *, n_rounds: int, seed: int = 0,
                      scheme: str = "swor", n_workers: Optional[int] = None,
                      dropped_workers: tuple = ()) -> float:
        """U_{N,T} — T reshuffle rounds of local averaging."""
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        A, B = self._prep(A, B)
        return float(self.backend.repartitioned(
            A, B, n_workers=self._resolve_workers(n_workers),
            n_rounds=n_rounds, seed=seed, scheme=scheme,
            dropped_workers=dropped_workers))

    def incomplete(self, A, B=None, *, n_pairs: int, seed: int = 0,
                   design: str = "swr") -> float:
        """U~_B — B sampled tuples under ``design``: "swr" (with
        replacement), "swor" (B distinct tuples) or "bernoulli" (each
        tuple kept with probability B/G, G the grid size; the realized
        size is at least 1). Two-sample, one-sample (the off-diagonal)
        and triplet grids alike; the distinct designs are drawn on the
        device and bound B at 0.8 G (ValueError above)."""
        if n_pairs < 1:
            raise ValueError(f"n_pairs must be >= 1, got {n_pairs}")
        A, B = self._prep(A, B)
        return float(self.backend.incomplete(
            A, B, n_pairs=n_pairs, seed=seed, design=design))

