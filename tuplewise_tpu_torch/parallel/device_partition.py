"""Worker index blocks drawn on the device, and the mesh's blocks.

The counterpart of ``tuplewise_tpu.parallel.device_partition``.
``draw_blocks``: leading ``batch`` dimensions draw independent
partitions at once (one per Monte-Carlo rep), which is how the harness
batches reps instead of vmapping them. The mesh half: the zero-padded
worker shards of a global array (``pad_blocks``, the JAX ``pad_put``)
and the complete packing (``pack_blocks``,
``parallel.partition.pack_all`` on the device). ``ShardedRows`` holds a
global array as those shards and answers ``X[idx]`` by a regather, how
the trainers take their worker blocks on a mesh. The JAX
``linear_shard_index`` is ``comm.worker_ids``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_blocks(gen: torch.Generator, n: int, n_workers: int,
                scheme: str = "swor", m: Optional[int] = None,
                batch: Tuple[int, ...] = ()) -> torch.Tensor:
    """[*batch, N, m] int64 worker index blocks over range(n).

    swor: one permutation cut into N blocks (random remainder dropped
    when n > N*m); swr: i.i.d. uniform draws.
    """
    m = n // n_workers if m is None else m
    dev = gen.device
    if scheme == "swor":
        if batch:
            # independent permutations per batch row: argsort of float64
            # uniforms (ties have probability ~n^2 2^-53)
            u = torch.rand(*batch, n, generator=gen, device=dev,
                           dtype=torch.float64)
            idx = torch.argsort(u, dim=-1)
        else:
            idx = torch.randperm(n, generator=gen, device=dev)
        return idx[..., : n_workers * m].reshape(*batch, n_workers, m)
    if scheme == "swr":
        return torch.randint(0, n, (*batch, n_workers, m), generator=gen,
                             device=dev)
    raise ValueError(f"unknown partition scheme {scheme!r}")


def pad_blocks(X: torch.Tensor, mesh) -> torch.Tensor:
    """Zero-pad axis 0 of X to a multiple of the mesh size and cut it
    into worker shards [N, cap, ...] on the mesh's device; this process
    keeps its own rows ([1, cap, ...] under ``DistComm``).

    Padding (never truncation) keeps every real row reachable: callers
    draw indices over the TRUE n, so padded rows are never gathered."""
    X = X.to(mesh.device)
    n_workers = mesh.n_workers
    pad = (-X.shape[0]) % n_workers
    if pad:
        X = torch.cat([X, X.new_zeros((pad,) + X.shape[1:])])
    blocks = X.reshape((n_workers, -1) + X.shape[1:])
    return mesh.comm.local_rows(blocks).contiguous()


def pack_layout(n: int, mesh):
    """The packing of n rows over the mesh's workers, this process's
    rows: (mask [n_local, cap] float32 (1 for a row, 0 for padding), ids
    [n_local, cap] int64 (the row index, -1 for padding)), worker w
    holding rows w cap .. (w + 1) cap - 1, cap = ceil(n / N):
    ``parallel.partition.pack_all``'s layout."""
    cap = -(-n // mesh.n_workers)
    pos = torch.arange(mesh.n_workers * cap, device=mesh.device)
    ids = torch.where(pos < n, pos, -1).reshape(mesh.n_workers, cap)
    ids = mesh.comm.local_rows(ids).contiguous()
    return (ids >= 0).to(torch.float32), ids


def pack_blocks(X: torch.Tensor, mesh):
    """Every row of X packed into worker blocks, this process's rows:
    (blocks [n_local, cap, ...], mask, ids) in ``pack_layout``'s
    layout."""
    return (pad_blocks(X, mesh),) + pack_layout(X.shape[0], mesh)


class ShardedRows:
    """A global [n, ...] array held as the mesh's zero-padded worker
    shards (``pad_blocks``). ``rows[idx]``, idx [*batch, N, m] int64 row
    indices of every worker, regathers this process's workers' rows
    through the communicator (one collective a batch row; on the worker
    axis an index of the shards): [*batch, n_local, m, ...]."""

    def __init__(self, X: torch.Tensor, mesh):
        self.shape = tuple(X.shape)
        self.device = mesh.device
        self.comm = mesh.comm
        self.shards = pad_blocks(X, mesh)
        # one process holds every worker: the regather is one index of
        # the flattened shards, taken without a loop a step
        self._rows = (self.shards.reshape((-1,) + self.shards.shape[2:])
                      if mesh.comm.n_local == mesh.n_workers else None)

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        if self._rows is not None:
            return self._rows[idx]
        flat = idx.reshape((-1,) + idx.shape[-2:])
        parts = [self.comm.regather(self.shards, self.comm.local_rows(i))
                 for i in flat]
        out = parts[0][None] if len(parts) == 1 else torch.stack(parts)
        return out.reshape(idx.shape[:-2] + out.shape[1:])
