"""Worker meshes (the counterpart of ``tuplewise_tpu.parallel.mesh``).

A :class:`Mesh` names N workers laid out as ``(N,)`` on the axis ``"w"``
(the ring) or as ``(D, I)`` on ``("dcn", "w")`` (the trailing axis the
fast inner ring, the leading one the slow hop between rows), the device
their blocks live on, and the communicator (``parallel.comm``) that
moves blocks between them:

* ``make_mesh(8)``: eight workers as the leading axis of each tensor on
  one device (``LocalComm``): how one card runs config 5's eight shards,
  as the JAX package runs them on eight virtual CPU devices;
* ``make_mesh(distributed=True)``: one worker per rank of the
  ``torch.distributed`` group (``DistComm``; see
  ``parallel.distributed``).

Worker slots stand in for the JAX package's devices where a heal
rebuilds a mesh (``parallel.self_heal.MeshHealer``): ``slots`` is the
physical slot of each logical worker (``range(N)`` by default) and
``pool`` the slots a heal may use, the counterpart of the JAX
``pool=jax.devices()``. A local mesh's default pool is ``range(max(N,
8))``, the JAX package's 8-device test pool: ``make_mesh(2)`` has 6
spare slots, ``make_mesh(8)`` none (``make_mesh(8, pool=12)`` has 4). A
distributed mesh's pool is its ranks. Values depend on the logical
worker index only: a slot never enters a computation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from tuplewise_tpu_torch.parallel.comm import DistComm, LocalComm
from tuplewise_tpu_torch.utils.device import resolve_device

shard_axis_name = "w"
dcn_axis_name = "dcn"
# the JAX package's test pool: 8 (virtual) devices
DEFAULT_POOL = 8


Slots = Union[int, Sequence[int], None]


def _slot_range(x: Slots, default: int) -> Tuple[int, ...]:
    """A slot tuple: ``range(x)`` for an int, ``default`` slots for None."""
    if x is None:
        x = default
    return tuple(range(x)) if isinstance(x, int) else tuple(int(s) for s in x)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Workers of shape ``shape`` on the axes ``axis_names``; worker w
    (row-major) sits in slot ``slots[w]`` of the ``pool``."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    comm: LocalComm
    slots: Slots = None
    pool: Slots = None

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")
        if tuple(self.comm.shape) != tuple(self.shape):
            raise ValueError(f"communicator of shape {self.comm.shape} for "
                             f"a mesh of shape {self.shape}")
        n = self.n_workers
        if self.distributed and (self.slots, self.pool) != (None, None):
            raise ValueError("a distributed mesh's slots are its ranks")
        slots = _slot_range(self.slots, n)
        pool = _slot_range(self.pool, n if self.distributed else max(
            n, DEFAULT_POOL, max(slots) + 1))
        object.__setattr__(self, "slots", slots)
        object.__setattr__(self, "pool", pool)
        if (len(self.slots) != self.n_workers
                or len(set(self.slots)) != len(self.slots)
                or not set(self.slots) <= set(self.pool)):
            raise ValueError(f"slots {self.slots} must be {self.n_workers} "
                             f"distinct slots of the pool {self.pool}")

    @property
    def n_workers(self) -> int:
        return math.prod(self.shape)

    @property
    def distributed(self) -> bool:
        return isinstance(self.comm, DistComm)


def _group_device(device) -> torch.device:
    """The device of this rank's worker: the process group's backend
    decides (NCCL: the current CUDA device, gloo: the CPU)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a distributed mesh needs an initialized process "
                           "group (parallel.distributed.initialize)")
    nccl = dist.get_backend() == "nccl"
    want = (torch.device("cuda", torch.cuda.current_device()) if nccl
            else torch.device("cpu"))
    if device is not None and torch.device(device).type != want.type:
        raise ValueError(f"the {dist.get_backend()} group runs on "
                         f"{want.type}, not {device}")
    return want


def _build(shape, names, device, distributed, slots, pool) -> Mesh:
    if distributed:
        return Mesh(shape, names, _group_device(device), DistComm(shape),
                    slots, pool)
    return Mesh(shape, names, resolve_device(device), LocalComm(shape),
                slots, pool)


def make_mesh(n_workers: Optional[int] = None, device=None, *,
              distributed: bool = False, slots: Slots = None,
              pool: Slots = None) -> Mesh:
    """A 1-D mesh of ``n_workers`` workers on the axis ``"w"``.

    Local (default): the workers are the leading axis of each tensor on
    ``device`` (None: the card, raising where there is none); n_workers
    defaults to 1. ``slots`` / ``pool``: the workers' slots and the
    slots a heal may use, each a sequence or an int n for range(n)
    (module docstring). ``distributed=True``: one worker per rank of the
    process group, n_workers its world size."""
    if distributed:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else None
        n_workers = world if n_workers is None else n_workers
    n_workers = 1 if n_workers is None else int(n_workers)
    return _build((n_workers,), (shard_axis_name,), device, distributed,
                  slots, pool)


def make_mesh_2d(n_dcn: int, n_ici: int, device=None, *,
                 distributed: bool = False, slots: Slots = None,
                 pool: Slots = None) -> Mesh:
    """A 2-D ``(n_dcn, n_ici)`` mesh: the trailing axis is the inner
    ring, the leading one is crossed once an inner cycle (the JAX
    ``make_mesh_2d``). Distributed, rank r = d n_ici + i is worker (d,
    i). ``slots`` / ``pool`` as in :func:`make_mesh`."""
    return _build((int(n_dcn), int(n_ici)), (dcn_axis_name, shard_axis_name),
                  device, distributed, slots, pool)
