"""MLP policy and critics (port of pql_tpu/models/mlp.py:35-96,200-263).

- MLPNet                — ELU trunk, hidden [512, 256, 128]
- TanhMLPPolicy         — deterministic tanh policy
- DoubleQ               — twin Q heads on concat(obs, act), ``q_min``
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


class MLPNet(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], gen, dtype) for i in range(len(dims) - 1)
        )

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.elu(layer(x))
        return self.layers[-1](x).float()


class TanhMLPPolicy(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_dim = act_dim
        self.net = MLPNet(obs_dim, act_dim, hidden, gen, dtype)

    def forward(self, obs):
        return torch.tanh(self.net(obs))


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
