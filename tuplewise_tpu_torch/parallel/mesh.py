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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from tuplewise_tpu_torch.parallel.comm import DistComm, LocalComm
from tuplewise_tpu_torch.utils.device import resolve_device

shard_axis_name = "w"
dcn_axis_name = "dcn"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Workers of shape ``shape`` on the axes ``axis_names``."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    comm: LocalComm

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")
        if tuple(self.comm.shape) != tuple(self.shape):
            raise ValueError(f"communicator of shape {self.comm.shape} for "
                             f"a mesh of shape {self.shape}")

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


def _build(shape, names, device, distributed) -> Mesh:
    if distributed:
        return Mesh(shape, names, _group_device(device), DistComm(shape))
    return Mesh(shape, names, resolve_device(device), LocalComm(shape))


def make_mesh(n_workers: Optional[int] = None, device=None, *,
              distributed: bool = False) -> Mesh:
    """A 1-D mesh of ``n_workers`` workers on the axis ``"w"``.

    Local (default): the workers are the leading axis of each tensor on
    ``device`` (None: the card, raising where there is none); n_workers
    defaults to 1. ``distributed=True``: one worker per rank of the
    process group, n_workers its world size."""
    if distributed:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else None
        n_workers = world if n_workers is None else n_workers
    n_workers = 1 if n_workers is None else int(n_workers)
    return _build((n_workers,), (shard_axis_name,), device, distributed)


def make_mesh_2d(n_dcn: int, n_ici: int, device=None, *,
                 distributed: bool = False) -> Mesh:
    """A 2-D ``(n_dcn, n_ici)`` mesh: the trailing axis is the inner
    ring, the leading one is crossed once an inner cycle (the JAX
    ``make_mesh_2d``). Distributed, rank r = d n_ici + i is worker (d,
    i)."""
    return _build((int(n_dcn), int(n_ici)), (dcn_axis_name, shard_axis_name),
                  device, distributed)
