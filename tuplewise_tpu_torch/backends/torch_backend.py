"""Single-device PyTorch backend (the counterpart of
``tuplewise_tpu.backends.jax_backend``).

* Complete statistics of diff kernels run the CUDA pair kernel
  (ops.pair_kernels), except the built-in AUC, which by default takes the
  exact rank form (ops.rank_auc; ``auc_fast=False`` sends it through the
  kernel too). The built-in scatter takes its O(n d) closed form.
* Complete statistics of the two built-in triplet kernels factorise
  through the anchor distances and run the CUDA triplet kernel
  (ops.triplet_kernels); a custom triplet kernel runs the plain tiled
  scan (ops.pair_tiles.triplet_stats).
* The N simulated workers of a local round are a batch axis: one round
  is ONE batched kernel launch over the [N, m1] x [N, m2] blocks (for
  triplets, over the N x m1 anchors of all workers, each excluding the
  positives that share its global row id).
* Randomness comes from ``torch.Generator``s derived per purpose
  (utils.rng); values agree with the JAX backend statistically, not bit
  for bit.
* The incomplete estimator's tuples are drawn on the device under any
  of the three designs (ops.device_design) and evaluated there: fixed
  shapes, no host synchronisation in the draw.
* ``dropped_workers`` drop and renormalize: excluded workers get weight
  0 and the mean runs over the survivors.

Parity with the JAX backend: exact (to float32 inputs) for complete
statistics, statistical for everything that draws randomness.
"""

from __future__ import annotations

import numpy as np
import torch

from tuplewise_tpu_torch.backends.base import register_backend
from tuplewise_tpu_torch.ops import (
    device_design, pair_kernels, pair_tiles, triplet_kernels,
)
from tuplewise_tpu_torch.ops.kernels import Kernel, auc_kernel, get_kernel
from tuplewise_tpu_torch.ops.rank_auc import rank_auc
from tuplewise_tpu_torch.ops.scatter_exact import (
    is_builtin_scatter, scatter_pair_stats,
)
from tuplewise_tpu_torch.parallel.device_partition import draw_blocks
from tuplewise_tpu_torch.parallel.faults import alive_mask
from tuplewise_tpu_torch.utils.device import resolve_device
from tuplewise_tpu_torch.utils.rng import generator


@register_backend("torch")
class TorchBackend:
    """Single-device execution of the four estimator schemes."""

    name = "torch"

    def __init__(self, kernel: Kernel, device=None, impl: str = "kernel",
                 auc_fast: bool = True):
        """device: None runs on "cuda" and raises where there is none.
        impl: "kernel" (CUDA pair kernels on the card) or "plain" (the
        plain PyTorch versions, the counterpart of the JAX impl="xla").
        auc_fast: complete() of the built-in AUC uses the exact rank
        form instead of the pair grid (identical value)."""
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.kernel = get_kernel(kernel)
        self.device = resolve_device(device)
        self.impl = impl
        self.auc_fast = auc_fast

    # ------------------------------------------------------------------ #
    def to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32).contiguous()
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device).contiguous()

    def _pair_sum(self, a, b, ma=None, mb=None) -> torch.Tensor:
        if ma is None:
            return pair_kernels.pair_sum(a, b, self.kernel, impl=self.impl)
        return pair_kernels.masked_pair_sum(a, b, ma, mb, self.kernel,
                                            impl=self.impl)

    # ------------------------------------------------------------------ #
    def complete(self, A, B=None) -> float:
        k = self.kernel
        A = self.to_device(A)
        if k.kind == "triplet":
            s, c = triplet_kernels.triplet_stats_best(k, A, self.to_device(B),
                                                      impl=self.impl)
            return float(s / c)
        if k.two_sample:
            B = self.to_device(B)
            if self.auc_fast and k is auc_kernel:
                return float(rank_auc(A, B))
            s = self._pair_sum(A, B)
            return float(s / float(A.shape[0] * B.shape[0]))
        ids = torch.arange(A.shape[0], device=self.device)
        s, c = self._one_sample_stats(A, ids)
        return float(s / c)

    def _one_sample_stats(self, a, ids):
        if is_builtin_scatter(self.kernel):
            return scatter_pair_stats(a, a, ids_a=ids, ids_b=ids)
        s, c = pair_tiles.pair_stats(self.kernel, a, a, ids_a=ids, ids_b=ids)
        return s, c.to(torch.float64)

    def local_round_from_blocks(self, A, B, i1, i2, alive=None) -> torch.Tensor:
        """One local-average round over given worker index blocks.

        i1 [N, m1], i2 [N, m2]: row indices of A and B held by each
        worker (B and i2 are None for one-sample kernels). Triplet
        kernels take anchors and positives from the rows i1 of A and
        negatives from the rows i2 of B, and exclude by the GLOBAL row
        ids i1: a row drawn twice into one block never pairs with
        itself. An entry < 0 is an empty slot: workers of unequal size
        are padded with -1, and such rounds run the masked kernel with
        count sum(ma) * sum(mb) per worker. alive: optional {0,1}
        weights [N] (dropped workers 0). Returns the survivors' mean of
        the per-worker U-statistics as a float64 0-d tensor.
        """
        i1 = torch.as_tensor(i1, device=self.device, dtype=torch.int64)
        padded = bool((i1 < 0).any())
        if self.kernel.two_sample:
            i2 = torch.as_tensor(i2, device=self.device, dtype=torch.int64)
            padded = padded or bool((i2 < 0).any())
        alive = alive_mask(i1.shape[0], ()) if alive is None else alive
        return self._round_from_blocks(A, B, i1, i2, alive, padded)

    def _round_from_blocks(self, A, B, i1, i2, alive, padded):
        A = self.to_device(A)
        B = None if i2 is None else self.to_device(B)
        alive = torch.as_tensor(alive, dtype=torch.float64, device=self.device)
        vals = self.block_means(
            A[i1.clamp_min(0)], None if B is None else B[i2.clamp_min(0)],
            i1, i2, padded)
        return (vals * alive).sum() / alive.sum()

    def block_means(self, a, b, i1, i2, padded) -> torch.Tensor:
        """[W] float64 per-worker U-statistics of gathered worker blocks
        a [W, m1(, d)] and b [W, m2(, d)] (None for one-sample kernels)
        whose global row ids are i1 and i2 (an entry < 0 is an empty
        slot; ``padded`` says whether there is one): ONE batched kernel
        launch for the diff and triplet kernels."""
        if self.kernel.kind == "triplet":
            sums, counts = triplet_kernels.grouped_triplet_stats(
                self.kernel, a, b, i1, (i1 >= 0).to(torch.float32),
                (i2 >= 0).to(torch.float32), impl=self.impl)
            return sums / counts
        if self.kernel.two_sample:
            if padded:
                ma = (i1 >= 0).to(torch.float32)
                mb = (i2 >= 0).to(torch.float32)
                sums = self._pair_sum(a, b, ma, mb)
                counts = (ma.sum(1, dtype=torch.float64)
                          * mb.sum(1, dtype=torch.float64))
            else:
                sums = self._pair_sum(a, b)
                counts = float(i1.shape[1] * i2.shape[1])
            return sums / counts
        vals = torch.stack([
            torch.stack(self._one_sample_stats(
                aw[iw >= 0], iw[iw >= 0])).to(torch.float64)
            for aw, iw in zip(a, i1)
        ])
        return vals[:, 0] / vals[:, 1]

    def _round(self, A, B, gen, n_workers, scheme, alive):
        # draw_blocks never pads: every worker holds m rows, so the round
        # takes the unmasked kernel without a pad check
        i1 = draw_blocks(gen, A.shape[0], n_workers, scheme)
        i2 = (draw_blocks(gen, B.shape[0], n_workers, scheme)
              if self.kernel.two_sample else None)
        return self._round_from_blocks(A, B, i1, i2, alive, padded=False)

    def local_average(self, A, B=None, *, n_workers, seed=0, scheme="swor",
                      dropped_workers=()) -> float:
        A = self.to_device(A)
        B = None if B is None else self.to_device(B)
        gen = generator(seed, "local_average", device=self.device)
        alive = alive_mask(n_workers, dropped_workers)
        return float(self._round(A, B, gen, n_workers, scheme, alive))

    def repartitioned(self, A, B=None, *, n_workers, n_rounds, seed=0,
                      scheme="swor", dropped_workers=()) -> float:
        A = self.to_device(A)
        B = None if B is None else self.to_device(B)
        alive = alive_mask(n_workers, dropped_workers)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for t in range(n_rounds):
            gen = generator(seed, "repartition_round", t, device=self.device)
            total += self._round(A, B, gen, n_workers, scheme, alive)
        return float(total / n_rounds)

    def incomplete(self, A, B=None, *, n_pairs, seed=0, design="swr") -> float:
        """B sampled tuples; design in {"swr", "swor", "bernoulli"},
        drawn on the device by ``ops.device_design`` ("swr" with
        replacement from generator (seed, "incomplete"), the distinct
        designs from (seed, "design") with ``floor_one=True``: bernoulli's
        size is at least 1); the mean over the drawn tuples is taken in
        float64. The distinct designs bound the budget at 0.8 x the grid
        (ValueError above)."""
        A = self.to_device(A)
        k = self.kernel
        gen = generator(seed, "incomplete" if design == "swr" else "design",
                        device=self.device)
        if k.kind == "triplet":
            B = self.to_device(B)
            i, j, kk, w = device_design.draw_triplet_design_device(
                gen, A.shape[0], B.shape[0], n_pairs, design, floor_one=True)
            vals = k.triplet_values(A[i], A[j], B[kk])
        elif k.two_sample:
            B = self.to_device(B)
            i, j, w = device_design.draw_pair_design_device(
                gen, A.shape[0], B.shape[0], n_pairs, design, floor_one=True)
            vals = k.pair_elementwise(A[i], B[j])
        else:
            i, j, w = device_design.draw_pair_design_device(
                gen, A.shape[0], A.shape[0] - 1, n_pairs, design,
                one_sample=True, floor_one=True)
            vals = k.pair_elementwise(A[i], A[j])
        return float(device_design.weighted_mean(vals, w))
