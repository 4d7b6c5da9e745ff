"""Data layer of the port: on-device packed ring replay and n-step staging."""

from pql_tpu_torch.replay.buffer import ReplayBuffer, replay_slots
from pql_tpu_torch.replay.nstep import NStepState, create_nstep, nstep_push, nstep_return, nstep_scan

__all__ = [
    "NStepState",
    "ReplayBuffer",
    "create_nstep",
    "nstep_push",
    "nstep_return",
    "nstep_scan",
    "replay_slots",
]
