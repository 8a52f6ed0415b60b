"""The collectives of a mesh: the port's ``lax.ppermute``, ``lax.psum``
and ``lax.axis_index``.

PyTorch has no ``shard_map``, so the ring code is written once against a
small communicator with one interface and two forms:

* :class:`LocalComm`: all N workers in this process, on one device. A
  per-worker tensor is ``[N, ...]``, its rows in worker order (row-major
  over the mesh shape ``(N,)`` or ``(D, I)``). A rotation is
  ``torch.roll`` of the rows along one mesh axis, a device copy on the
  current stream.
* :class:`DistComm`: one worker per rank of a ``torch.distributed``
  group (NCCL across GPUs, gloo across CPU processes). A per-worker
  tensor is ``[1, ...]``, this rank's row. A rotation is one
  ``batch_isend_irecv``: send to the next rank along the axis, receive
  from the previous one.

Either way a rotation moves worker i's block to worker i + 1 along the
axis (the JAX permutation ``[(i, (i + 1) % n)]`` of
``tuplewise_tpu.parallel.ring._ring_perm``), and an axis of one worker
rotates to itself, as ``ppermute`` over a size-1 axis does.
:meth:`start_rotate` issues the rotation and returns a handle whose
``wait()`` gives the rotated blocks, so a ring issues the next visiting
block before the current stop's kernel and waits after it (the double
buffering of the JAX ring).

``all_reduce_sum`` sums over all workers in worker order: an all-gather,
then one local sum of the gathered ``[N, ...]`` float64 rows. Float64
addition is not associative, and this is what makes the distributed form
equal the worker axis bit for bit; the payloads (a ring's sum and count,
a round's means) are a few numbers. ``sum_partials`` adds one partial a
process (a trainer's gradient over its own workers) the same way; on
the worker axis one process holds every worker and it is the identity.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch


class _Ready:
    """A rotation that is already done (the worker axis, a 1-wide axis)."""

    def __init__(self, tensors):
        self._tensors = list(tensors)

    def wait(self) -> List[torch.Tensor]:
        return self._tensors


class _InFlight:
    """A rotation in flight: ``wait()`` completes its receives."""

    def __init__(self, works, bufs):
        self._works, self._bufs = works, bufs

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        return self._bufs


class LocalComm:
    """N workers as the leading axis of each tensor on one device."""

    def __init__(self, shape: Sequence[int]):
        self.shape = tuple(int(s) for s in shape)
        if not self.shape or min(self.shape) < 1:
            raise ValueError(f"mesh shape must be positive, got {self.shape}")
        self.n_workers = math.prod(self.shape)
        self.n_local = self.n_workers

    def worker_ids(self, device) -> torch.Tensor:
        """[n_local] int64 row-major worker ids of this process's rows
        (the JAX ``linear_shard_index``): per-worker generator chains
        ``(seed, ..., w)`` derive the same w on the worker axis and
        across ranks."""
        return torch.arange(self.n_workers, device=device)

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This process's rows of an [N, ...] tensor every worker holds."""
        return t

    def start_rotate(self, tensors, axis: int):
        out = []
        for t in tensors:
            v = t.reshape(self.shape + t.shape[1:])
            out.append(torch.roll(v, 1, dims=axis).reshape(t.shape))
        return _Ready(out)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """[n_local, ...] -> [...] float64: the sum over all workers."""
        return self.all_gather(t.to(torch.float64)).sum(0)

    def sum_partials(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over processes of each process's partial ``t`` (in its
        own dtype): one process here, so ``t`` itself."""
        return t

    def regather(self, shards: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` [n_local, m] of the global array whose worker
        shards are ``shards`` [n_local, cap, ...] (worker w holds global
        rows w cap .. (w + 1) cap - 1): [n_local, m, ...]. On the worker
        axis it is an index."""
        full = self.all_gather(shards)
        return full.reshape((-1,) + full.shape[2:])[idx]


class DistComm(LocalComm):
    """One worker per rank of the default ``torch.distributed`` group;
    rank r is worker r (row-major over the mesh shape)."""

    def __init__(self, shape: Sequence[int]):
        import torch.distributed as dist

        super().__init__(shape)
        world = dist.get_world_size()
        if world != self.n_workers:
            raise ValueError(f"a {self.shape} mesh needs {self.n_workers} "
                             f"ranks, the group has {world}")
        self.rank = dist.get_rank()
        self.n_local = 1
        self._coords = _unravel(self.rank, self.shape)

    def worker_ids(self, device) -> torch.Tensor:
        return torch.tensor([self.rank], device=device)

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.rank:self.rank + 1]

    def _peer(self, axis: int, step: int) -> int:
        c = list(self._coords)
        c[axis] = (c[axis] + step) % self.shape[axis]
        return _ravel(c, self.shape)

    def start_rotate(self, tensors, axis: int):
        import torch.distributed as dist

        if self.shape[axis] == 1:
            return _Ready(tensors)
        nxt, prv = self._peer(axis, 1), self._peer(axis, -1)
        sends = [t.contiguous() for t in tensors]
        bufs = [torch.empty_like(t) for t in sends]
        ops = ([dist.P2POp(dist.isend, t, nxt) for t in sends]
               + [dist.P2POp(dist.irecv, b, prv) for b in bufs])
        return _InFlight(dist.batch_isend_irecv(ops), bufs)

    def sum_partials(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's partial, gathered and summed in float64 in rank
        order, cast back to ``t``'s dtype: the same value on every rank."""
        return self.all_gather(t.to(torch.float64)[None]).sum(0).to(t.dtype)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.n_workers)]
        dist.all_gather(parts, t)
        return torch.cat(parts)


def _unravel(r: int, shape) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r
