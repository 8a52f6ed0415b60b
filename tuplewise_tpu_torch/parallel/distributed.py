"""Multi-process launch (the counterpart of
``tuplewise_tpu.parallel.distributed``).

* :func:`initialize` brings up the ``torch.distributed`` process group
  from explicit arguments or the ``TUPLEWISE_DIST_*`` flags
  (COORDINATOR ``host:port``, NUM_PROCESSES, PROCESS_ID): NCCL when the
  device is the card (each rank on its own GPU), gloo when the caller
  asks for the CPU. Nothing switches one for the other.
* :func:`global_mesh` builds the mesh from the process topology: a 2-D
  ``("dcn", "w")`` mesh of ``DistComm`` workers, one per rank, whose
  ``dcn`` axis is the node and whose ``w`` axis the rank within it.
  The node's size comes from ``LOCAL_WORLD_SIZE`` (set by ``torchrun``)
  or the ``TUPLEWISE_DIST_LOCAL_SIZE`` flag, else all ranks share one
  node. One rank a GPU is PyTorch's idiom, where the JAX package puts
  every device of a host in one process.

On a single process both are inert: ``initialize`` is a no-op without
flags, and ``global_mesh`` returns the local mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from tuplewise_tpu_torch.utils.device import resolve_device

_ENV_PREFIX = "TUPLEWISE_DIST_"


def dist_env() -> dict:
    """The TUPLEWISE_DIST_* launch flags present in the environment:
    COORDINATOR (host:port), NUM_PROCESSES, PROCESS_ID."""
    out = {}
    for key, cast in (("COORDINATOR", str), ("NUM_PROCESSES", int),
                      ("PROCESS_ID", int)):
        val = os.environ.get(_ENV_PREFIX + key)
        if val is not None:
            out[key.lower()] = cast(val)
    return out


def _local_size(world: int) -> int:
    """Ranks on this node: ``LOCAL_WORLD_SIZE``, else the
    ``TUPLEWISE_DIST_LOCAL_SIZE`` flag, else the whole world."""
    for key in ("LOCAL_WORLD_SIZE", _ENV_PREFIX + "LOCAL_SIZE"):
        if os.environ.get(key):
            return int(os.environ[key])
    return world


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    init_method: Optional[str] = None,
    retries: int = 0,
    retry_backoff_s: float = 0.5,
    chaos=None,
) -> bool:
    """Bring up the process group; returns True when distributed mode is
    active.

    Explicit arguments win, then the TUPLEWISE_DIST_* flags; with
    neither, this is a no-op returning False, and a partial set raises
    ValueError. ``init_method`` (for example a ``file://`` store) stands
    in for the coordinator, which otherwise becomes ``tcp://host:port``.
    ``device``: None runs on the card (NCCL; rank r takes GPU
    ``LOCAL_RANK``, else r mod the node's size) and raises where there is
    none; "cpu" runs gloo. A failed bring-up retries ``retries`` times
    with ``parallel.self_heal.Backoff``; ``chaos`` (anything with
    ``fire(point)``) fires ``"dist_init"`` before each attempt.
    """
    env = dist_env()
    coordinator_address = coordinator_address or env.get("coordinator")
    if num_processes is None:
        num_processes = env.get("num_processes")
    if process_id is None:
        process_id = env.get("process_id")
    if (coordinator_address is None and init_method is None
            and num_processes is None and process_id is None):
        return False   # nothing set anywhere: single-process mode
    if not ((coordinator_address or init_method)
            and num_processes is not None and process_id is not None):
        raise ValueError(
            "distributed launch needs coordinator_address, num_processes "
            f"AND process_id (got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}); set all three "
            f"{_ENV_PREFIX}* flags or pass them explicitly"
        )
    import torch.distributed as dist

    from tuplewise_tpu_torch.parallel.self_heal import Backoff

    world, rank = int(num_processes), int(process_id)
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK",
                                       rank % _local_size(world)))
        torch.cuda.set_device(index)
    method = init_method or f"tcp://{coordinator_address}"
    backoff = Backoff(base_s=retry_backoff_s, cap_s=10.0, seed=rank)
    attempt = 0
    while True:
        try:
            if chaos is not None:
                chaos.fire("dist_init")
            dist.init_process_group(backend, init_method=method,
                                    world_size=world, rank=rank)
            return True
        except Exception:
            attempt += 1
            if attempt > retries:
                raise
            backoff.sleep(attempt)


def global_mesh(n_workers: Optional[int] = None, device=None):
    """The mesh of the process topology.

    Several processes: a 2-D ``(nodes, local_size)`` ``("dcn", "w")``
    mesh with one worker per rank (``n_workers``, if given, must be the
    world size). One process, or no group: the local 1-D mesh of
    ``n_workers`` workers on ``device`` (``parallel.mesh.make_mesh``)."""
    import torch.distributed as dist

    from tuplewise_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return make_mesh(n_workers, device)
    world = dist.get_world_size()
    if n_workers is not None and n_workers != world:
        raise ValueError(f"n_workers={n_workers} conflicts with the "
                         f"group's {world} ranks (one worker a rank)")
    local = _local_size(world)
    if world % local:
        raise ValueError(f"{world} ranks do not divide into nodes of "
                         f"{local}")
    return make_mesh_2d(world // local, local, device, distributed=True)
