"""Environment registry (port of pql_tpu/envs/__init__.py; Cartpole, the
rigid-body locomotion tasks and the in-hand manipulation tasks so far)."""

from pql_tpu_torch.envs.base import Task, VecEnv, VecEnvState, handle_timeout
from pql_tpu_torch.envs.classic import Cartpole
from pql_tpu_torch.envs.hand import AllegroHand, ShadowHand
from pql_tpu_torch.envs.rigid import Ant, Anymal, Humanoid

TASK_REGISTRY = {
    "Cartpole": Cartpole,
    "Ant": Ant,
    "Humanoid": Humanoid,
    "Anymal": Anymal,
    "AllegroHand": AllegroHand,
    "ShadowHand": ShadowHand,
}


def make_task(name: str) -> Task:
    if name not in TASK_REGISTRY:
        raise KeyError(f"Unknown task '{name}'. Ported so far: {sorted(TASK_REGISTRY)}")
    return TASK_REGISTRY[name]()


def make_env(cfg) -> VecEnv:
    """Training env with cfg.num_envs parallel instances (the device is
    that of the tensors it is stepped with)."""
    return VecEnv(make_task(cfg.task), cfg.num_envs)


__all__ = ["Task", "VecEnv", "VecEnvState", "handle_timeout", "TASK_REGISTRY", "make_task", "make_env"]
