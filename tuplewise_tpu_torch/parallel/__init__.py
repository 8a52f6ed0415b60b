"""L2 — partitioning and the mesh (see the package docstring): worker
meshes (``mesh``), their collectives (``comm``), the ring (``ring``),
the multi-process launch (``distributed``), the host partitioner
(``partition``), drop-and-renormalize and failure detection
(``faults``) and the elastic healer (``self_heal``)."""

from tuplewise_tpu_torch.parallel.faults import (
    alive_mask, detect_dropped_workers, normalize_dropped,
    run_with_fault_tolerance, sample_failures, survivors,
)
from tuplewise_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d
from tuplewise_tpu_torch.parallel.partition import (
    draw_pair_design, draw_triplet_design, partition_indices,
    partition_two_sample,
)
from tuplewise_tpu_torch.parallel.ring import (
    ring_pair_stats, ring_pair_stats_2d, ring_triplet_stats,
    ring_triplet_stats_2d,
)
from tuplewise_tpu_torch.parallel.self_heal import (
    Backoff, HealExhaustedError, MeshHealer,
)

__all__ = ["Backoff", "HealExhaustedError", "Mesh", "MeshHealer",
           "alive_mask", "detect_dropped_workers", "draw_pair_design",
           "draw_triplet_design", "make_mesh", "make_mesh_2d",
           "normalize_dropped", "partition_indices", "partition_two_sample",
           "ring_pair_stats", "ring_pair_stats_2d", "ring_triplet_stats",
           "ring_triplet_stats_2d", "run_with_fault_tolerance",
           "sample_failures", "survivors"]
