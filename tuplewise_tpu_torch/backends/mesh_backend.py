"""Multi-worker mesh backend (the counterpart of
``tuplewise_tpu.backends.mesh_backend``).

The workers of a mesh (``parallel.mesh``) each hold one shard of the
data; their collectives go through the mesh's communicator: the worker
axis of one device (``LocalComm``, how one card runs config 5's eight
shards) or one worker per ``torch.distributed`` rank (``DistComm``).

* **complete** statistics run the ring (``parallel.ring``): the
  packed blocks rotate, each stop is one batched launch of kernel 1 (no
  padding: N divides n), kernel 2 (padding) or kernel 5 (triplets, the
  double ring), and one all-reduce gives the global value. The built-in
  scatter takes its moment form (``ops.scatter_exact``): one all-reduce,
  no ring.
* **local_average** / **repartitioned** draw fresh worker blocks each
  round (``parallel.device_partition.draw_blocks``, the same generator
  chain on every rank), regather them from the workers' shards (one
  collective a round: what repartitioning prices) and average the
  per-worker means of ONE batched launch
  (``TorchBackend.block_means``) over the survivors of
  ``dropped_workers``.
* **incomplete**: swr samples ceil(B / N) tuples inside each shard of a
  random packing (the paper's within-worker sampling), the packing and
  every worker's tuples from the generator (seed, "incomplete_shard"),
  the same on every rank; swor and bernoulli draw the
  global tuple set (``ops.device_design``, (seed, "design"), the same on
  every rank), split it into worker blocks (``shard_design_blocks``),
  regather and take the weighted global mean.

Each scheme's shard-level half (``complete_stats``, ``round_mean``,
``incomplete_swr``, ``incomplete_designed``) takes the workers' shards
and a generator, so the mesh Monte-Carlo (``harness.mesh_mc``) runs the
same code on the rows it makes on each worker.

``impl``: "kernel" (the CUDA kernels on the card) or "plain" (the plain
PyTorch versions). Values agree with the JAX mesh backend exactly for
complete auc (to its float32 carry) and statistically for the schemes
that draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from tuplewise_tpu_torch.backends.base import register_backend
from tuplewise_tpu_torch.backends.torch_backend import TorchBackend
from tuplewise_tpu_torch.ops import device_design, pair_tiles
from tuplewise_tpu_torch.ops.kernels import Kernel, get_kernel
from tuplewise_tpu_torch.ops.scatter_exact import (
    is_builtin_scatter, scatter_mesh_stats,
)
from tuplewise_tpu_torch.parallel import ring
from tuplewise_tpu_torch.parallel.device_partition import (
    draw_blocks, pack_blocks, pad_blocks,
)
from tuplewise_tpu_torch.parallel.faults import alive_mask
from tuplewise_tpu_torch.parallel.mesh import make_mesh
from tuplewise_tpu_torch.utils.profiling import annotate
from tuplewise_tpu_torch.utils.rng import generator

F64 = torch.float64


@register_backend("mesh")
class MeshBackend:
    """The four schemes over a 1-D or 2-D mesh of workers."""

    name = "mesh"

    def __init__(self, kernel: Kernel, mesh=None,
                 n_workers: Optional[int] = None, device=None,
                 impl: str = "kernel"):
        """mesh: a ``parallel.mesh.Mesh``; None builds the worker axis
        ``make_mesh(n_workers, device)`` (device None: the card, raising
        where there is none)."""
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.kernel = get_kernel(kernel)
        if mesh is None:
            mesh = make_mesh(n_workers, device)
        elif (device is not None
              and torch.device(device).type != mesh.device.type):
            raise ValueError(f"device {device} conflicts with the mesh's "
                             f"{mesh.device}")
        if len(mesh.shape) > 2:
            raise ValueError(f"mesh must be 1-D or 2-D, got axes "
                             f"{mesh.axis_names}")
        self.mesh, self.comm, self.device = mesh, mesh.comm, mesh.device
        self.n_shards = mesh.n_workers
        self.impl = impl
        self._local = TorchBackend(self.kernel, device=self.device, impl=impl)

    def to_device(self, x) -> torch.Tensor:
        return self._local.to_device(x)

    # ------------------------------------------------------------------ #
    def _inputs(self, A, B):
        """(A, B) on the mesh's device; B is A for one-sample kernels."""
        A = self.to_device(A)
        return A, (self.to_device(B) if self.kernel.two_sample else A)

    def _shards(self, A, B):
        """The workers' zero-padded shards of A and B (``pad_blocks``)."""
        As = pad_blocks(A, self.mesh)
        return As, (As if B is A else pad_blocks(B, self.mesh))

    def complete(self, A, B=None) -> float:
        k = self.kernel
        A, B = self._inputs(A, B)
        a, ma, ia = pack_blocks(A, self.mesh)
        if k.two_sample:
            b, mb, ib = pack_blocks(B, self.mesh)
        else:
            b, mb, ib = a, ma, ia
        N = self.n_shards
        no_masks = A.shape[0] % N == 0 and B.shape[0] % N == 0
        s, c = self.complete_stats(a, ma, ia, b, mb, ib, no_masks)
        # on the host: the correctly rounded quotient of the exact sum
        # and count
        return float(s) / float(c)

    def complete_stats(self, a, ma, ia, b, mb, ib, no_masks: bool):
        """(sum, count) of the complete statistic over the workers'
        packed blocks (``pack_blocks``'s layout; b, mb, ib are a's for a
        one-sample kernel): the ring, or the scatter's moment form.
        ``no_masks``: every block is full (kernel 1 at every stop)."""
        k = self.kernel
        two_d = len(self.mesh.shape) == 2
        if is_builtin_scatter(k):
            return scatter_mesh_stats(a, ma, b, mb, comm=self.comm,
                                      one_sample=not k.two_sample)
        if k.kind == "triplet":
            fn = (ring.ring_triplet_stats_2d if two_d
                  else ring.ring_triplet_stats)
            return fn(k, a, b, mask_x=ma, mask_y=mb, ids_x=ia,
                      mesh=self.mesh, impl=self.impl)
        fn = ring.ring_pair_stats_2d if two_d else ring.ring_pair_stats
        return fn(k, a, b,
                  mask_a=None if no_masks else ma,
                  mask_b=None if no_masks else mb,
                  ids_a=None if k.two_sample else ia,
                  ids_b=None if k.two_sample else ib,
                  mesh=self.mesh, impl=self.impl)

    # ------------------------------------------------------------------ #
    def round_mean(self, As, Bs, n1, n2, gen, scheme, alive):
        """One round: fresh [N, m] blocks from ``gen`` (the same on every
        rank), regathered from the workers' shards As, Bs (``pad_blocks``;
        Bs is As for a one-sample kernel) of the n1 and n2 real rows, and
        the survivors' mean of the per-worker means (float64 0-d);
        ``alive`` is this process's rows of the alive mask. Spans: a
        ``mesh.round`` over ``mesh.partition`` (the draws),
        ``mesh.regather`` and ``mesh.block_means``."""
        k = self.kernel
        comm = self.comm
        with annotate("mesh.round"):
            with annotate("mesh.partition"):
                i1 = comm.local_rows(draw_blocks(gen, n1, self.n_shards,
                                                 scheme))
            with annotate("mesh.regather"):
                a = comm.regather(As, i1)
            i2 = b = None
            if k.two_sample:
                with annotate("mesh.partition"):
                    i2 = comm.local_rows(draw_blocks(gen, n2, self.n_shards,
                                                     scheme))
                with annotate("mesh.regather"):
                    b = comm.regather(Bs, i2)
            with annotate("mesh.block_means"):
                vals = self._local.block_means(a, b, i1, i2, padded=False)
            tot = comm.all_reduce_sum(torch.stack([vals * alive, alive],
                                                  dim=1))
            return tot[0] / tot[1]

    def _schemes_setup(self, A, B, n_workers, dropped_workers):
        self._check_workers(n_workers)
        A, B = self._inputs(A, B)
        self._check_sizes(A, B)
        As, Bs = self._shards(A, B)
        alive = self.comm.local_rows(torch.as_tensor(
            alive_mask(self.n_shards, dropped_workers), dtype=F64,
            device=self.device))
        return As, Bs, A.shape[0], B.shape[0], alive

    def local_average(self, A, B=None, *, n_workers=None, seed=0,
                      scheme="swor", dropped_workers=()) -> float:
        As, Bs, n1, n2, alive = self._schemes_setup(A, B, n_workers,
                                                    dropped_workers)
        gen = generator(seed, "local_average", device=self.device)
        return float(self.round_mean(As, Bs, n1, n2, gen, scheme, alive))

    def repartitioned(self, A, B=None, *, n_workers=None, n_rounds,
                      seed=0, scheme="swor", dropped_workers=()) -> float:
        As, Bs, n1, n2, alive = self._schemes_setup(A, B, n_workers,
                                                    dropped_workers)
        total = torch.zeros((), dtype=F64, device=self.device)
        for t in range(n_rounds):
            gen = generator(seed, "repartition_round", t, device=self.device)
            total += self.round_mean(As, Bs, n1, n2, gen, scheme, alive)
        return float(total / n_rounds)

    # ------------------------------------------------------------------ #
    def incomplete(self, A, B=None, *, n_pairs, seed=0, design="swr") -> float:
        """B sampled tuples. swr: ceil(n_pairs / N) tuples inside each
        shard of a random packing (``draw_blocks``), drawn for all
        workers at once from (seed, "incomplete_shard"), so the budget is
        rounded UP to a multiple of N. swor / bernoulli: the distinct
        global set drawn on the device (a budget above 0.8 x the grid
        raises ValueError), split over the workers and regathered; the
        mean is weighted by the realized tuples."""
        A, B = self._inputs(A, B)
        As, Bs = self._shards(A, B)
        n1, n2 = A.shape[0], B.shape[0]
        if design == "swr":
            self._check_sizes(A, B)
            gen = generator(seed, "incomplete_shard", device=self.device)
            return float(self.incomplete_swr(As, Bs, n1, n2, n_pairs, gen))
        gen = generator(seed, "design", device=self.device)
        return float(self.incomplete_designed(As, Bs, n1, n2, n_pairs, gen,
                                              design))

    def incomplete_designed(self, As, Bs, n1, n2, n_pairs, gen, design):
        """The swor / bernoulli estimate (float64 0-d) over the workers'
        shards As, Bs of n1 and n2 rows: the design drawn from ``gen``
        (the same on every rank), split into worker blocks
        (``shard_design_blocks``) and regathered."""
        k = self.kernel
        comm = self.comm
        if k.kind == "triplet":
            i, j, kk, w = device_design.draw_triplet_design_device(
                gen, n1, n2, n_pairs, design, floor_one=True)
            pi, pj, pk, pw = (comm.local_rows(t) for t in
                              device_design.shard_design_blocks(
                                  (i, j, kk), w, self.n_shards))
            vals = k.triplet_values(comm.regather(As, pi),
                                    comm.regather(As, pj),
                                    comm.regather(Bs, pk))
        else:
            one = not k.two_sample
            i, j, w = device_design.draw_pair_design_device(
                gen, n1, n1 - 1 if one else n2, n_pairs, design,
                one_sample=one, floor_one=True)
            pi, pj, pw = (comm.local_rows(t) for t in
                          device_design.shard_design_blocks(
                              (i, j), w, self.n_shards))
            vals = k.pair_elementwise(comm.regather(As, pi),
                                      comm.regather(Bs, pj))
        part = torch.stack([(vals * pw).sum(-1, dtype=F64),
                            pw.sum(-1, dtype=F64)], dim=1)
        tot = comm.all_reduce_sum(part)
        return tot[0] / tot[1]

    def incomplete_swr(self, As, Bs, n1, n2, n_pairs, gen):
        """The swr estimate (float64 0-d) over the workers' shards As, Bs
        of n1 and n2 rows: a random packing and every worker's
        ceil(n_pairs / N) tuples inside its block, all from ``gen`` (the
        same on every rank); each process regathers its workers' rows."""
        k = self.kernel
        N, comm, dev = self.n_shards, self.comm, self.device
        ia = draw_blocks(gen, n1, N)
        ib = draw_blocks(gen, n2, N) if k.two_sample else ia
        per = -(-n_pairs // N)          # ceil: draw AT LEAST n_pairs
        na, nb = ia.shape[1], ib.shape[1]

        def rows(X, ix, t):
            return comm.regather(X, comm.local_rows(ix.gather(1, t)))

        if k.kind == "triplet":
            i, j = pair_tiles.sample_pair_indices(gen, na, na, per, True,
                                                  batch=(N,))
            kn = torch.randint(0, nb, (N, per), generator=gen, device=dev)
            vals = k.triplet_values(rows(As, ia, i), rows(As, ia, j),
                                    rows(Bs, ib, kn))
        else:
            i, j = pair_tiles.sample_pair_indices(
                gen, na, nb if k.two_sample else na, per, not k.two_sample,
                batch=(N,))
            vals = k.pair_elementwise(rows(As, ia, i), rows(Bs, ib, j))
        return comm.all_reduce_sum(vals.mean(-1, dtype=F64)) / N

    # ------------------------------------------------------------------ #
    def _check_sizes(self, A, B):
        if min(A.shape[0], B.shape[0]) < self.n_shards:
            raise ValueError(
                f"n={min(A.shape[0], B.shape[0])} too small for "
                f"{self.n_shards} workers")

    def _check_workers(self, n_workers):
        if n_workers is not None and n_workers != self.n_shards:
            raise ValueError(
                f"mesh backend has {self.n_shards} shards (one worker a "
                f"shard); per-call n_workers={n_workers} is not supported: "
                "build the backend with a mesh of the desired size")
