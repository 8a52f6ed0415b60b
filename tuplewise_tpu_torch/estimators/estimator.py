"""L3 — the user-facing Estimator with the backend plugin boundary.

``Estimator(kernel=..., backend="torch")``: the four estimator schemes of
``tuplewise_tpu.estimators.estimator`` with the same semantics and input
convention. Score-difference kernels ("auc", "hinge", "logistic") take
1-D score arrays; feature kernels ("scatter") take [n, d] arrays, and so
do the triplet kernels ("triplet_indicator", "triplet_hinge"): A holds
the anchors and positives (one class), B the negatives. Inputs may be
numpy arrays, lists or tensors; they are moved to the backend's device
as float32 (the host oracles take float64 numpy copies).

It runs on the card unless ``device="cpu"`` is passed; with no card and
no device it raises. ``backend="mesh"`` runs the schemes over a mesh of
workers (``backends.mesh_backend``): ``n_workers`` sizes the worker
axis when no ``mesh`` is given, and ``est.n_workers`` is the mesh size.
``backend="numpy"`` and ``backend="cpp"`` are the host oracles (the
serial blockwise numpy backend and its C++ pair loop); they ignore
``device``. The default backend is ``"torch"``, where the JAX package's
is ``"numpy"``.

``heal_retries`` > 0 runs every scheme call under the elastic
heal-and-retry protocol (``parallel.self_heal.MeshHealer``): on the mesh
a failed call probes the mesh, rebuilds it at the SAME worker count over
the spare slots of ``mesh.pool``, rebuilds the backend on it with the
same options and retries with backoff; the value is unchanged, since the
backend packs its inputs per call and every draw folds the logical
worker, never a slot. The single-device backend retries with backoff
only. ``chaos`` (a ``testing.chaos.FaultInjector``) fires at the
``"estimator"`` hook before each scheme call.
"""

from __future__ import annotations

from typing import Optional

from tuplewise_tpu_torch.backends.base import get_backend
from tuplewise_tpu_torch.ops.kernels import get_kernel
from tuplewise_tpu_torch.parallel.self_heal import MeshHealer


class Estimator:
    """Distributed tuplewise (U-statistic) estimator.

    Args:
      kernel: kernel name or Kernel instance.
      backend: "torch" (single device), "mesh" (a mesh of workers),
        "numpy" or "cpp" (the host oracles).
      device: None (the card) or an explicit torch device such as "cpu".
      n_workers: default number of simulated workers N; with "mesh", the
        mesh size (a conflicting mesh raises ValueError).
      heal_retries: > 0 retries a failed scheme call up to this many
        times, healing the mesh first (module docstring); 0 (default)
        runs the call bare.
      chaos: a ``testing.chaos.FaultInjector`` fired at the
        ``"estimator"`` hook before each scheme call (and consulted for
        the declared dead-worker topology during a heal).
      **backend_opts: forwarded to the backend (impl, auc_fast; mesh;
        block_size for the host oracles).
    """

    def __init__(self, kernel="auc", backend: str = "torch", device=None,
                 n_workers: Optional[int] = None, heal_retries: int = 0,
                 chaos=None, **backend_opts):
        self.kernel = get_kernel(kernel)
        self.backend_name = backend
        if (backend == "mesh" and "mesh" not in backend_opts
                and n_workers is not None):
            backend_opts["n_workers"] = n_workers
        self._backend_opts = dict(backend_opts, device=device)
        self.backend = get_backend(backend, self.kernel, device=device,
                                   **backend_opts)
        if hasattr(self.backend, "n_shards"):
            # a mesh pins N (one worker a shard): a different explicit N
            # is a configuration error, never silently overridden
            if n_workers is not None and n_workers != self.backend.n_shards:
                raise ValueError(
                    f"n_workers={n_workers} conflicts with the mesh's "
                    f"{self.backend.n_shards} shards (one worker a shard)")
            self.n_workers = self.backend.n_shards
        else:
            self.n_workers = 1 if n_workers is None else int(n_workers)
        self.chaos = chaos
        self.heal_retries = int(heal_retries)
        self._healer = None
        if self.heal_retries:
            mesh = getattr(self.backend, "mesh", None)
            self._healer = (
                MeshHealer(None, chaos=chaos) if mesh is None else
                MeshHealer(mesh, fixed_width=mesh.n_workers, pool=mesh.pool,
                           chaos=chaos))

    def _call(self, fn):
        """Run one scheme call ``fn(backend)``, under the heal-and-retry
        protocol when ``heal_retries`` > 0."""
        def attempt():
            if self.chaos is not None:
                self.chaos.fire("estimator")
            return fn(self.backend)

        if self._healer is None:
            return attempt()
        return self._healer.run(attempt, retries=self.heal_retries,
                                on_heal=self._on_heal)

    def _on_heal(self, healer):
        """Rebuild the mesh backend on the healed mesh (the same worker
        count, lost slots backfilled from spares) with the same options:
        the same impl and device. Inputs are packed per call, so no other
        state needs re-placing."""
        if healer.mesh is None:
            return
        opts = dict(self._backend_opts)
        opts.pop("mesh", None)
        opts.pop("n_workers", None)
        self.backend = get_backend("mesh", self.kernel, mesh=healer.mesh,
                                   **opts)

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
            if A.ndim == 2 and A.shape[1] == 1:
                A = self.backend.to_device(A[:, 0])
            if B is not None and B.ndim == 2 and B.shape[1] == 1:
                B = self.backend.to_device(B[:, 0])
            if A.ndim != 1 or (B is not None and B.ndim != 1):
                shapes = [tuple(A.shape)] + ([] if B is None else [tuple(B.shape)])
                raise ValueError(
                    f"kernel {k.name!r} operates on scalar scores; got "
                    f"shapes {shapes}. Apply a scorer first."
                )
        elif A.ndim != 2 or (B is not None and B.ndim != 2):
            what = (" (A: anchors and positives, B: negatives)"
                    if k.kind == "triplet" else "")
            raise ValueError(f"kernel {k.name!r} expects [n, d] features"
                             f"{what}")
        return A, B

    # the four estimator schemes
    def complete(self, A, B=None) -> float:
        """Complete U_n — every tuple."""
        A, B = self._prep(A, B)
        return float(self._call(lambda be: be.complete(A, B)))

    def local_average(self, A, B=None, *, seed: int = 0, scheme: str = "swor",
                      n_workers: Optional[int] = None,
                      dropped_workers: tuple = ()) -> float:
        """U^loc_N — per-worker complete U, averaged over the survivors."""
        A, B = self._prep(A, B)
        return float(self._call(lambda be: be.local_average(
            A, B, n_workers=self._resolve_workers(n_workers), seed=seed,
            scheme=scheme, dropped_workers=dropped_workers)))

    def repartitioned(self, A, B=None, *, n_rounds: int, seed: int = 0,
                      scheme: str = "swor", n_workers: Optional[int] = None,
                      dropped_workers: tuple = ()) -> float:
        """U_{N,T} — T reshuffle rounds of local averaging."""
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        A, B = self._prep(A, B)
        return float(self._call(lambda be: be.repartitioned(
            A, B, n_workers=self._resolve_workers(n_workers),
            n_rounds=n_rounds, seed=seed, scheme=scheme,
            dropped_workers=dropped_workers)))

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
        return float(self._call(lambda be: be.incomplete(
            A, B, n_pairs=n_pairs, seed=seed, design=design)))

