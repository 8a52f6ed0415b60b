"""L2 — partitioning and the mesh (see the package docstring): worker
meshes (``mesh``), their collectives (``comm``), the ring
(``ring``) and the multi-process launch (``distributed``)."""

from tuplewise_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d
from tuplewise_tpu_torch.parallel.ring import (
    ring_pair_stats, ring_pair_stats_2d, ring_triplet_stats,
    ring_triplet_stats_2d,
)

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "ring_pair_stats",
           "ring_pair_stats_2d", "ring_triplet_stats",
           "ring_triplet_stats_2d"]
