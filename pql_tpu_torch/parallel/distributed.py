"""Multi-process initialization and helpers (port of pql_tpu/parallel/distributed.py).

The JAX package joins one process per host into one SPMD program through
``jax.distributed``. The port runs **one process per GPU**, joined by
``torch.distributed``:

- every process calls ``initialize(cfg, device)`` before it builds an agent
  (a ``cuda`` device without an index becomes the process's card:
  ``local_rank``);
  it makes the process group from ``cfg.dist`` (``coordinator_address``
  host:port, ``num_processes``, ``process_id``), else from
  PQL_COORDINATOR / PQL_NUM_PROCESSES / PQL_PROCESS_ID, else from torchrun's
  MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK; with ``tcp://`` init and an
  explicit timeout; NCCL for a ``cuda`` device and gloo for ``cpu``, chosen
  by the device and never by a failed attempt;
- with none of them set the run is one process and ``initialize`` does
  nothing, as in the JAX package;
- ``auto_tpu_pod`` (the JAX package's TPU metadata discovery) is refused.

``world_size``, ``rank`` and ``is_primary`` read the group (1, 0, True
without one); ``host_barrier`` is ``dist.barrier``; ``replicate`` broadcasts
tensors from rank 0; ``any_rank`` is a logical or over the ranks (the stop
check: a wall-clock budget can run out on one rank first) and
``same_on_all_ranks`` compares integers across them (the resume checks).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_ENV_COORD = "PQL_COORDINATOR"
_ENV_NPROC = "PQL_NUM_PROCESSES"
_ENV_PID = "PQL_PROCESS_ID"
TIMEOUT_S = 600.0  # init and every collective


def settings(cfg) -> tuple[str | None, int | None, int | None]:
    """(coordinator host:port, number of processes, this process's id) from
    ``cfg.dist``, then the PQL_* variables, then torchrun's; None where unset."""
    d = getattr(cfg, "dist", None)
    env = os.environ
    torchrun = (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
                if "MASTER_ADDR" in env and "MASTER_PORT" in env else None)
    coord = (d and d.coordinator_address) or env.get(_ENV_COORD) or torchrun
    nproc = (d and d.num_processes) or env.get(_ENV_NPROC) or env.get("WORLD_SIZE")
    pid = d.process_id if d is not None and d.process_id is not None else env.get(_ENV_PID, env.get("RANK"))
    return coord, (int(nproc) if nproc is not None else None), (int(pid) if pid is not None else None)


def local_rank(process_id: int) -> int:
    """A process's card on its host: torchrun's LOCAL_RANK, else its id
    modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(torch.cuda.device_count(), 1)


def initialize(cfg, device: str | torch.device, timeout_s: float = TIMEOUT_S) -> bool:
    """Join this process into the job if one is configured (see the module
    doc); True when a process group is up after the call."""
    d = getattr(cfg, "dist", None)
    if d is not None and d.auto_tpu_pod:
        raise ValueError("dist.auto_tpu_pod=true is the JAX package's TPU-pod discovery; the port takes "
                         "dist.coordinator_address, dist.num_processes and dist.process_id (or torchrun's env)")
    if dist.is_initialized():
        return True
    coord, nproc, pid = settings(cfg)
    if coord is None or nproc is None:
        return False
    if pid is None or not 0 <= pid < nproc:
        raise ValueError(f"process id {pid!r} for {nproc} processes (dist.process_id or PQL_PROCESS_ID)")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda run's process group needs a CUDA device (pass --device=cpu for gloo)")
        torch.cuda.set_device(device.index if device.index is not None else local_rank(pid))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=f"tcp://{coord}",
                            world_size=nproc, rank=pid, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that logs, evaluates and writes the best model."""
    return rank() == 0


def host_barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


@torch.no_grad()
def replicate(tensors) -> None:
    """Broadcast each tensor from rank 0 in place (a no-op on one rank)."""
    if world_size() > 1:
        for t in tensors:
            dist.broadcast(t, 0)


def same_on_all_ranks(values: list[int], device: str | torch.device) -> bool:
    """Whether every rank holds the same integers (one rank: True)."""
    if world_size() == 1:
        return True
    lo = torch.tensor(values, dtype=torch.int64, device=device)
    hi = lo.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return bool(torch.equal(lo, hi))


def any_rank(flag: bool, device: str | torch.device) -> bool:
    """True on every rank when ``flag`` is true on any (one rank: ``flag``)."""
    if world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
