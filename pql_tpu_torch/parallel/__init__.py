"""Multi-process PQL on torch.distributed: one process per GPU, the env axis
split over the ranks (port of pql_tpu/parallel)."""

from pql_tpu_torch.parallel.distributed import (
    any_rank,
    host_barrier,
    initialize,
    is_primary,
    local_rank,
    rank,
    replicate,
    same_on_all_ranks,
    settings,
    shutdown,
    world_size,
)
from pql_tpu_torch.parallel.mesh import ENV_AXIS_FIELDS, Mesh, make_mesh

__all__ = ["ENV_AXIS_FIELDS", "Mesh", "any_rank", "host_barrier", "initialize", "is_primary", "local_rank",
           "make_mesh", "rank", "replicate", "same_on_all_ranks", "settings", "shutdown", "world_size"]
