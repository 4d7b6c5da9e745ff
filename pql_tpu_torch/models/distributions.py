"""The squashed (tanh) Gaussian of the SAC policy (port of
pql_tpu/models/distributions.py:47-65).

The sample takes its standard-normal draw as an argument instead of a key,
so the caller owns the generator and a test can hand in the JAX package's
numbers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG_SQRT_2PI = math.log(math.sqrt(2.0 * math.pi))
_LOG_2 = math.log(2.0)


def tanh_log_det_jacobian(u: torch.Tensor) -> torch.Tensor:
    """log|d tanh(u)/du| by the stable identity 2(log 2 − u − softplus(−2u)),
    not log(1 − tanh²(u)), which loses every digit once |u| passes ~9."""
    return 2.0 * (_LOG_2 - u - F.softplus(-2.0 * u))


def squashed_gaussian_sample_logprob(normal: torch.Tensor, mu: torch.Tensor, log_std: torch.Tensor):
    """a = tanh(u), u = mu + std · normal; returns (a, logp) with logp summed
    over the last axis and kept as a trailing singleton [..., 1]."""
    std = torch.exp(log_std)
    u = mu + std * normal
    logp_u = -0.5 * torch.square((u - mu) / std) - log_std - _LOG_SQRT_2PI
    logp = torch.sum(logp_u - tanh_log_det_jacobian(u), dim=-1, keepdim=True)
    return torch.tanh(u), logp
