"""Algorithms of the port on one device, by ``algo.name`` (port of
pql_tpu/algos/__init__.py:20-46): PQL / PQL-D; the off-policy baselines
DDPG, SAC and CrossQ and the two-hand IDDPG; the on-policy PPO, its
two-agent IPPO and MAPPO, QTOTV1 and QTOTV2, the split-population team
agents IART, IPPOTeam and IPPOTeam2, the equivariant family EQ, EQG, EQS,
EQS4, EQSC, EQSdata and MP, the team-distillation EQSD and EQSD2, the
visual PPOV and IPPOV, and DDPGV, visual DDPG through the host replay ring.
Only PQL runs on more than one device (``algos/pql.py``)."""

from pql_tpu_torch.algos.crossq import CrossQ
from pql_tpu_torch.algos.ddpg import DDPG, OffPolicyState
from pql_tpu_torch.algos.ddpgv import DDPGV, DDPGVState
from pql_tpu_torch.algos.eq import EQ, EQG, EQS, EQS4, EQSC, MP, EQSCState, EQSdata
from pql_tpu_torch.algos.eqsd import EQSD, EQSD2
from pql_tpu_torch.algos.iddpg import IDDPG, IDDPGState
from pql_tpu_torch.algos.ippo import IPPO, IPPOState
from pql_tpu_torch.algos.mappo import MAPPO
from pql_tpu_torch.algos.ppo import PPO, PPOState
from pql_tpu_torch.algos.ppov import IPPOV, PPOV, PPOVState
from pql_tpu_torch.algos.pql import PQL, PQLState
from pql_tpu_torch.algos.qtot import QTOTV1, QTOTV2
from pql_tpu_torch.algos.sac import SAC, SACState
from pql_tpu_torch.algos.teams import IART, IPPOTeam, IPPOTeam2

ALGO_REGISTRY = {"PQL": PQL, "DDPG": DDPG, "SAC": SAC, "CrossQ": CrossQ, "IDDPG": IDDPG, "PPO": PPO, "IPPO": IPPO,
                 "MAPPO": MAPPO, "QTOTV1": QTOTV1, "QTOTV2": QTOTV2, "IART": IART, "IPPOTeam": IPPOTeam,
                 "IPPOTeam2": IPPOTeam2, "EQ": EQ, "EQG": EQG, "EQS": EQS, "EQS4": EQS4, "EQSC": EQSC,
                 "EQSdata": EQSdata, "MP": MP, "EQSD": EQSD, "EQSD2": EQSD2, "PPOV": PPOV, "IPPOV": IPPOV, "DDPGV": DDPGV}


def get_algo(name: str):
    if name not in ALGO_REGISTRY:
        raise NotImplementedError(f"algo.name={name!r} is not ported yet; ported: {sorted(ALGO_REGISTRY)}")
    return ALGO_REGISTRY[name]


__all__ = ["ALGO_REGISTRY", "get_algo", "PQL", "PQLState", "DDPG", "OffPolicyState", "SAC", "SACState", "CrossQ",
           "IDDPG", "IDDPGState", "PPO", "PPOState", "IPPO", "IPPOState", "MAPPO", "QTOTV1", "QTOTV2", "IART",
           "IPPOTeam", "IPPOTeam2", "EQ", "EQG", "EQS", "EQS4", "EQSC", "EQSCState", "EQSdata", "MP", "EQSD",
           "EQSD2", "PPOV", "IPPOV", "PPOVState", "DDPGV", "DDPGVState"]
