"""Environment registry (port of pql_tpu/envs/__init__.py; the classic
tasks, the rigid-body locomotion tasks, the in-hand manipulation tasks,
FrankaCubeStack and the two-agent BimanualReacher(Sym) so far). ``make_env(cfg)`` and ``make_eval_env(cfg)`` build the train and eval
env instances."""

from pql_tpu_torch.envs.base import Task, VecEnv, VecEnvState, handle_timeout
from pql_tpu_torch.envs.bimanual import BimanualReacher, BimanualReacherSym
from pql_tpu_torch.envs.classic import BallBalance, Cartpole, Pendulum, PointMass, Reacher
from pql_tpu_torch.envs.hand import AllegroHand, ShadowHand
from pql_tpu_torch.envs.manip import FrankaCubeStack
from pql_tpu_torch.envs.rigid import Ant, Anymal, Humanoid

TASK_REGISTRY = {
    "Cartpole": Cartpole,
    "Pendulum": Pendulum,
    "PointMass": PointMass,
    "Reacher": Reacher,
    "BallBalance": BallBalance,
    "Ant": Ant,
    "Humanoid": Humanoid,
    "Anymal": Anymal,
    "AllegroHand": AllegroHand,
    "ShadowHand": ShadowHand,
    "FrankaCubeStack": FrankaCubeStack,
    "BimanualReacher": BimanualReacher,
    "BimanualReacherSym": BimanualReacherSym,
}


def make_task(name: str) -> Task:
    if name not in TASK_REGISTRY:
        raise KeyError(f"Unknown task '{name}'. Ported so far: {sorted(TASK_REGISTRY)}")
    return TASK_REGISTRY[name]()


def make_env(cfg) -> VecEnv:
    """Training env with cfg.num_envs parallel instances (the device is
    that of the tensors it is stepped with)."""
    return VecEnv(make_task(cfg.task), cfg.num_envs)


def make_eval_env(cfg) -> VecEnv:
    """A separate eval env with cfg.eval_num_envs instances and a task of its
    own (on a card, a rigid or hand task captures its own graph for them)."""
    return VecEnv(make_task(cfg.task), cfg.eval_num_envs)


__all__ = ["Task", "VecEnv", "VecEnvState", "handle_timeout", "TASK_REGISTRY", "make_task", "make_env",
           "make_eval_env"]
