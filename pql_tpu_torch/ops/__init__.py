"""Numeric building blocks of the port: normalizer, noise, schedules,
distributional ops, the DDPM schedule and sampler (``ops.ddpm``), and the
hand-written kernels (``ops.kernels``)."""

from pql_tpu_torch.ops.distributional import (
    binary_cross_entropy,
    categorical_projection,
    categorical_td_target,
    dist_to_q,
)
from pql_tpu_torch.ops.kernels import c51_td_target
from pql_tpu_torch.ops.noise import add_mixed_normal_noise, add_normal_noise, mixed_noise_std
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.ops.schedules import LinearSchedule, schedule_value
from pql_tpu_torch.ops.soft_update import soft_update

__all__ = [
    "LinearSchedule",
    "RunningMeanStd",
    "add_mixed_normal_noise",
    "add_normal_noise",
    "binary_cross_entropy",
    "c51_td_target",
    "categorical_projection",
    "categorical_td_target",
    "dist_to_q",
    "mixed_noise_std",
    "schedule_value",
    "soft_update",
]
