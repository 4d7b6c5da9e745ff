"""Algorithms of the port on one device, by ``algo.name`` (port of
pql_tpu/algos/__init__.py:20-56): PQL / PQL-D, the off-policy baselines
DDPG, SAC and CrossQ, and the on-policy PPO with its two-agent IPPO and
MAPPO."""

from pql_tpu_torch.algos.crossq import CrossQ
from pql_tpu_torch.algos.ddpg import DDPG, OffPolicyState
from pql_tpu_torch.algos.ippo import IPPO, IPPOState
from pql_tpu_torch.algos.mappo import MAPPO
from pql_tpu_torch.algos.ppo import PPO, PPOState
from pql_tpu_torch.algos.pql import PQL, PQLState
from pql_tpu_torch.algos.sac import SAC, SACState

ALGO_REGISTRY = {"PQL": PQL, "DDPG": DDPG, "SAC": SAC, "CrossQ": CrossQ, "PPO": PPO, "IPPO": IPPO, "MAPPO": MAPPO}


def get_algo(name: str):
    if name not in ALGO_REGISTRY:
        raise NotImplementedError(f"algo.name={name!r} is not ported yet; ported: {sorted(ALGO_REGISTRY)}")
    return ALGO_REGISTRY[name]


__all__ = ["ALGO_REGISTRY", "get_algo", "PQL", "PQLState", "DDPG", "OffPolicyState", "SAC", "SACState", "CrossQ",
           "PPO", "PPOState", "IPPO", "IPPOState", "MAPPO"]
