"""The Monte-Carlo runner of mesh configs (the counterpart of
``tuplewise_tpu.harness.mesh_mc``): data made on each worker, estimates
by the mesh backend's own shard-level code.

* **Data is made on each worker, one rep at a time.** Worker w draws
  its own Gaussian ``[cap]`` block (``[cap, dim]`` for feature kernels,
  the class shift on the first feature, as the JAX runner's) from the
  generator of (seed, "mc_rep", rep, "shard", w): shard w holds global
  rows [w cap, (w + 1) cap), its padding rows zeroed and masked, which is
  ``parallel.device_partition.pack_layout``'s layout. On a distributed
  mesh each rank makes only its own workers' rows: no data crosses the
  host. A rep's rows are drawn just before it is estimated and freed
  before the next rep is drawn, so a chunk of k reps draws those k reps
  and no others, a retried or checkpointed chunk regenerates the same
  data, and live memory is one rep's working set (the reference's
  ``lax.map`` over reps): 2 x N x cap float32 values, 80 MB at config 5
  (n = 10^7 a class, N = 8).
* **complete** runs the ring (``MeshBackend.complete_stats``): kernel 1
  at each stop on full shards, kernel 2 on ragged ones, kernel 5 for
  triplets (the double ring), the scatter's moment form for the built-in
  scatter; 1-D and 2-D meshes alike. Its value on a rep's data equals
  ``Estimator(backend="mesh").complete`` on the same rows bit for bit.
* **local** and **repartitioned** regather fresh worker blocks a round
  and take the per-worker means in one batched launch
  (``MeshBackend.round_mean``), the rounds of rep r from the generators
  (seed, "partition", r) (local) and (seed, "partition", r, t).
* **incomplete**: swr samples within the shards of a random packing
  (``MeshBackend.incomplete_swr``, generator (seed, "incomplete_shard",
  r)); swor and bernoulli draw the design on the device, split it into
  worker blocks and regather (``MeshBackend.incomplete_designed``,
  generator (seed, "design", r)).

Statistical contract, as the JAX runner's: the estimates have the
distribution of the mesh Estimator looped over fresh data. ``chaos`` (a
``testing.chaos.FaultInjector``) fires at ``"mesh_mc"`` once a ``run``
call, before any draw: the reference's point before each dispatch of its
compiled program. The runner keys every draw by the absolute rep index
and the logical worker, never by a slot, so a runner rebuilt on a healed
mesh of the same width gives the same values.

Spans (``utils.profiling.annotate``, recorded while a profiler runs):
``mc.run`` a call, ``mc.rep`` a rep, ``mc.draw`` a rep's draw, ``mc.read``
the host's reads of the estimate, each counted under
``obs.tracing.COUNTS["host_read[mc.read]"]`` (two a complete rep, one a
round or an incomplete rep).
"""

from __future__ import annotations

import numpy as np
import torch

from tuplewise_tpu_torch.backends.mesh_backend import MeshBackend
from tuplewise_tpu_torch.obs.tracing import COUNTS
from tuplewise_tpu_torch.ops.kernels import get_kernel
from tuplewise_tpu_torch.parallel.device_partition import pack_layout
from tuplewise_tpu_torch.parallel.mesh import make_mesh
from tuplewise_tpu_torch.utils.profiling import annotate
from tuplewise_tpu_torch.utils.rng import generator

READ = "host_read[mc.read]"


def worker_draws(cfg, mesh, chain):
    """The workers' rows of each class: a tuple of one or two [n_local,
    cap(, dim)] float32 tensors (one for a one-sample kernel),
    worker w's drawn from the generator of (*chain, "shard", w), the
    first class shifted by cfg.separation (on the first feature for
    feature kernels), padding rows zeroed."""
    kernel = get_kernel(cfg.kernel)
    feat = () if kernel.kind == "diff" else (cfg.dim,)
    sizes = (cfg.n_pos,) if not kernel.two_sample else (cfg.n_pos,
                                                         cfg.n_neg)
    masks = [pack_layout(n, mesh)[0] for n in sizes]
    # the ids on the host: reading them back from the card would sync
    # inside the body once a call
    workers = mesh.comm.worker_ids("cpu").tolist()
    outs = [torch.empty(m.shape + feat, device=mesh.device)
            for m in masks]
    for i, w in enumerate(workers):
        # a retried chunk, or the harness's warm-up, draws a rep again:
        # the chain is shared by design, so the key audit does not record
        # it
        g = generator(cfg.seed, *chain, "shard", w, device=mesh.device,
                      record=False)
        for out in outs:
            out[i] = torch.randn(out.shape[1:], generator=g,
                                 device=mesh.device)
    if feat:
        outs[0][..., 0] += cfg.separation
    else:
        outs[0] += cfg.separation
    for out, mask in zip(outs, masks):
        pad = mask.reshape(mask.shape + (1,) * len(feat)) == 0
        out.masked_fill_(pad, 0.0)
    return tuple(outs)


def make_mesh_mc_runner(cfg, mesh=None, chaos=None, device=None):
    """The runner of a mesh config: ``run(reps)`` takes a range of
    absolute rep indices and returns their estimates, float64 numpy.

    ``mesh``: a 1-D or 2-D ``parallel.mesh.Mesh`` of cfg.n_workers
    workers; None builds ``make_mesh(cfg.n_workers, device)`` (device
    None: the card, raising where there is none). A healed mesh of the
    same width gives the same values (module docstring)."""
    kernel = get_kernel(cfg.kernel)
    if mesh is None:
        mesh = make_mesh(cfg.n_workers, device)
    elif mesh.n_workers != cfg.n_workers:
        raise ValueError(f"n_workers={cfg.n_workers} conflicts with the "
                         f"mesh's {mesh.n_workers} workers")
    backend = MeshBackend(kernel, mesh=mesh)
    N, dev = mesh.n_workers, mesh.device
    one_sample = not kernel.two_sample
    n1 = cfg.n_pos
    n2 = n1 if one_sample else cfg.n_neg
    ma, ia = pack_layout(n1, mesh)
    mb, ib = (ma, ia) if one_sample else pack_layout(n2, mesh)
    no_masks = n1 % N == 0 and n2 % N == 0
    alive = mesh.comm.local_rows(torch.ones(N, dtype=torch.float64,
                                            device=dev))

    def read(*values):
        # the host reads device values: a float each
        with annotate("mc.read"):
            out = tuple(map(float, values))
        COUNTS[READ] += len(out)
        return out

    def estimate(rep: int, a, b) -> float:
        if cfg.scheme == "complete":
            s, c = read(*backend.complete_stats(a, ma, ia, b, mb, ib,
                                                 no_masks))
            # on the host: the correctly rounded quotient, as
            # MeshBackend.complete
            return s / c
        if cfg.scheme in ("local", "repartitioned"):
            chains = ([(rep,)] if cfg.scheme == "local"
                      else [(rep, t) for t in range(cfg.n_rounds)])
            total = 0.0
            for chain in chains:
                g = generator(cfg.seed, "partition", *chain, device=dev,
                              record=False)
                total += read(backend.round_mean(
                    a, b, n1, n2, g, cfg.partition_scheme, alive))[0]
            return total / len(chains)
        if cfg.design == "swr":
            g = generator(cfg.seed, "incomplete_shard", rep, device=dev,
                          record=False)
            m = backend.incomplete_swr(a, b, n1, n2, cfg.n_pairs, g)
        else:
            g = generator(cfg.seed, "design", rep, device=dev, record=False)
            m = backend.incomplete_designed(a, b, n1, n2, cfg.n_pairs, g,
                                            cfg.design)
        return read(m)[0]

    def rep_data(chain):
        with annotate("mc.draw"):
            data = worker_draws(cfg, mesh, chain)
        return data[0], data[-1]

    def run(reps) -> np.ndarray:
        with annotate("mc.run"):
            if chaos is not None:
                chaos.fire("mesh_mc")
            fixed = (rep_data(("data_fixed",))
                     if getattr(cfg, "fix_data", False) else None)
            out = []
            for r in reps:
                with annotate("mc.rep"):
                    a, b = fixed or rep_data(("mc_rep", r))
                    out.append(estimate(r, a, b))
                    # one rep's rows live at a time
                    del a, b
            return np.asarray(out, dtype=np.float64)

    return run
