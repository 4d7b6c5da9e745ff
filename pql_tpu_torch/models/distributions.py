"""The diagonal Gaussian of the PPO policy and the squashed (tanh) Gaussian
of the SAC policy (port of pql_tpu/models/distributions.py:23-37,47-65).

A sample takes its standard-normal draw as an argument instead of a key,
so the caller owns the generator and a test can hand in the JAX package's
numbers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG_SQRT_2PI = math.log(math.sqrt(2.0 * math.pi))
_LOG_2 = math.log(2.0)


def diag_gaussian_sample(normal: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor) -> torch.Tensor:
    """mean + std · normal."""
    return mean + torch.exp(log_std) * normal


def diag_gaussian_logprob(x: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of the per-dim Normal log-densities."""
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * torch.square(x - mean) / var - log_std - _LOG_SQRT_2PI, dim=-1)


def diag_gaussian_entropy(log_std: torch.Tensor) -> torch.Tensor:
    """Σ (0.5 + log √(2π) + log σ) over the last axis."""
    return torch.sum(0.5 + _LOG_SQRT_2PI + log_std, dim=-1)


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
