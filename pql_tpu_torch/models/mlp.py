"""MLP policies and critics (port of pql_tpu/models/mlp.py:35-96,136-160,200-263).

- MLPNet                — ELU trunk, hidden [512, 256, 128]; with
  ``use_batchnorm`` a flax-rule ``BatchNorm`` after each hidden Linear
- TanhMLPPolicy         — deterministic tanh policy (PQL, DDPG, CrossQ)
- TanhDiagGaussianMLPPolicy — SAC's squashed Gaussian, log_std in [-5, 5]
- DoubleQ               — twin Q heads on concat(obs, act), ``q_min``
- DoubleQBatchNorm      — CrossQ's twin Q heads with BatchNorm
- DistributionalDoubleQ — twin C51 heads (softmax over num_atoms), ``q_min``
  over a linspace support

Init is torch.nn.Linear's default, U(±1/sqrt(fan_in)) for weight and
bias, drawn from an explicit generator. Params are fp32; with
``dtype=torch.bfloat16`` the input, weight and bias are cast for the
product and the trunk returns fp32 (mlp.py:62,84). Submodule names follow
the flax modules so ``utils/convert.py`` can map parameters across.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pql_tpu_torch.models.distributions import squashed_gaussian_sample_logprob

DEFAULT_HIDDEN = (512, 256, 128)


class Linear(nn.Module):
    """nn.Linear's layout ([out, in] weight) with its init drawn from an
    explicit generator and a configurable compute dtype (the port of
    TorchLinear)."""

    def __init__(self, in_features, out_features, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features).uniform_(-bound, bound, generator=gen))
        self.bias = nn.Parameter(torch.empty(out_features).uniform_(-bound, bound, generator=gen))

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5) over the batch axis,
    whose rules differ from torch.nn.BatchNorm1d's:

    - ``train=True`` normalizes by the batch's mean and its biased variance
      E[x²] − E[x]² (clamped at 0), through which gradients flow; ``False``
      by the running ``mean`` and ``var``;
    - a train-mode pass does not touch the running statistics: it keeps its
      batch's (mean, var) in ``batch_stats``, and ``commit`` folds them in as
      running = 0.9 · running + 0.1 · batch, the biased variance included
      (torch's ``momentum`` weighs the batch, and it keeps the unbiased
      variance). A pass whose statistics are discarded, as CrossQ's actor
      pass, is not committed.

    Statistics and the affine map are fp32; the output has the compute dtype."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.eps, self.compute_dtype = momentum, eps, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.batch_stats: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x, train: bool = False):
        x = x.float()
        if train:
            mean = x.mean(0)
            var = torch.clamp(torch.mean(x * x, 0) - mean * mean, min=0.0)
            self.batch_stats = (mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        return ((x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias).to(self.compute_dtype)

    @torch.no_grad()
    def commit(self) -> None:
        """Fold the last train-mode pass's batch statistics into the running ones."""
        mean, var = self.batch_stats
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        self.var.copy_(m * self.var + (1 - m) * var)


class MLPNet(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32,
                 use_batchnorm: bool = False):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], gen, dtype) for i in range(len(dims) - 1)
        )
        # flax names these BatchNorm_i, beside TorchLinear_i (utils/convert.py)
        self.norms = nn.ModuleList(BatchNorm(h, dtype=dtype) for h in hidden) if use_batchnorm else None

    def forward(self, x, train: bool = False):
        for i, layer in enumerate(self.layers[:-1]):
            x = layer(x)
            if self.norms is not None:
                x = self.norms[i](x, train)
            x = F.elu(x)
        return self.layers[-1](x).float()


class TanhMLPPolicy(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_dim = act_dim
        self.net = MLPNet(obs_dim, act_dim, hidden, gen, dtype)

    def forward(self, obs):
        return torch.tanh(self.net(obs))


class TanhDiagGaussianMLPPolicy(nn.Module):
    """SAC's squashed Gaussian: the trunk emits (mu, log_std), log_std
    clamped to [log_std_min, log_std_max]."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32,
                 log_std_min: float = -5.0, log_std_max: float = 5.0):
        super().__init__()
        self.act_dim = act_dim
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        self.net = MLPNet(obs_dim, 2 * act_dim, hidden, gen, dtype)

    def forward(self, obs):
        mu, log_std = torch.chunk(self.net(obs), 2, dim=-1)
        return mu, torch.clamp(log_std, self.log_std_min, self.log_std_max)

    def mean_action(self, obs):
        return torch.tanh(self(obs)[0])

    def sample(self, obs, normal):
        """(tanh(u), logp [..., 1]) with u = mu + std · normal."""
        mu, log_std = self(obs)
        return squashed_gaussian_sample_logprob(normal, mu, log_std)


class DoubleQ(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net_q1 = MLPNet(obs_dim + act_dim, 1, hidden, gen, dtype)
        self.net_q2 = MLPNet(obs_dim + act_dim, 1, hidden, gen, dtype)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.net_q1(x), self.net_q2(x)

    def q_min(self, obs, act):
        q1, q2 = self(obs, act)
        return torch.minimum(q1, q2)


class DoubleQBatchNorm(nn.Module):
    """CrossQ's critic: twin Q heads with a ``BatchNorm`` after each hidden
    layer and no target net; ``train=True`` normalizes by the batch."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net_q1 = MLPNet(obs_dim + act_dim, 1, hidden, gen, dtype, use_batchnorm=True)
        self.net_q2 = MLPNet(obs_dim + act_dim, 1, hidden, gen, dtype, use_batchnorm=True)

    def forward(self, obs, act, train: bool = False):
        x = torch.cat([obs, act], dim=-1)
        return self.net_q1(x, train), self.net_q2(x, train)

    def q_min(self, obs, act, train: bool = False):
        q1, q2 = self(obs, act, train)
        return torch.minimum(q1, q2)

    def commit_batch_stats(self) -> None:
        """Fold the last train-mode pass's statistics into every BatchNorm."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.commit()


class DistributionalDoubleQ(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32,
                 v_min: float = -10.0, v_max: float = 10.0, num_atoms: int = 51):
        super().__init__()
        self.v_min, self.v_max, self.num_atoms = v_min, v_max, num_atoms
        self.net_q1 = MLPNet(obs_dim + act_dim, num_atoms, hidden, gen, dtype)
        self.net_q2 = MLPNet(obs_dim + act_dim, num_atoms, hidden, gen, dtype)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return torch.softmax(self.net_q1(x), dim=-1), torch.softmax(self.net_q2(x), dim=-1)

    def q_min(self, obs, act):
        p1, p2 = self(obs, act)
        z = torch.linspace(self.v_min, self.v_max, self.num_atoms, dtype=p1.dtype, device=p1.device)
        return torch.minimum(torch.sum(p1 * z, dim=-1), torch.sum(p2 * z, dim=-1))[..., None]
