"""The env mesh of the port (port of pql_tpu/parallel/mesh.py and
``ENV_AXIS_FIELDS``, pql_tpu/algos/pql.py:63-71).

The JAX package shards one SPMD program's env axis over a 1-D device mesh.
The port's mesh is its process group: one rank per GPU, each holding the
slice [rank·e_local, (rank+1)·e_local) of the global env axis of every
field in ``ENV_AXIS_FIELDS`` (at the axis given there) and a replica of
everything else. ``make_mesh`` refuses a size other than the world's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pql_tpu_torch.parallel.distributed import rank, world_size

# state field → the axis that carries the env dimension (pql_tpu/algos/pql.py:63-71)
ENV_AXIS_FIELDS = {
    "env_state": 0,
    "obs": 0,
    "nstep": 1,
    "replay": 1,
    "cur_returns": 0,
    "cur_lengths": 0,
}


@dataclass(frozen=True)
class Mesh:
    size: int  # ranks on the env axis
    rank: int
    axis_name: str

    def local(self, total: int, what: str) -> int:
        """``total`` split evenly over the ranks (the JAX package's errors)."""
        if total % self.size:
            raise ValueError(f"{what}={total} not divisible by mesh size {self.size}")
        return total // self.size

    def env_slice(self, num_envs: int) -> slice:
        """This rank's slice of the global env axis."""
        e_local = self.local(num_envs, "num_envs")
        return slice(self.rank * e_local, (self.rank + 1) * e_local)

    def shard(self, x: torch.Tensor, num_envs: int, axis: int = 0) -> torch.Tensor:
        """This rank's part of a tensor whose ``axis`` is the global env axis."""
        s = self.env_slice(num_envs)
        return x.narrow(axis, s.start, s.stop - s.start)


def make_mesh(num_devices: int | None = None, axis_name: str = "env") -> Mesh:
    """The 1-D env mesh over the process group's ranks; ``num_devices`` must
    be the world size (None: the world)."""
    world = world_size()
    n = num_devices or world
    if n != world:
        raise ValueError(f"num_devices={n} but the process group has {world} rank(s): the port runs one process "
                         f"per GPU, so launch {n} ranks (torchrun --nproc_per_node={n}, or dist.num_processes="
                         f"{n} with dist.coordinator_address and dist.process_id) or leave num_devices unset")
    return Mesh(size=world, rank=rank(), axis_name=axis_name)
