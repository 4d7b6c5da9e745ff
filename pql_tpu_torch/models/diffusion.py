"""Diffusion policies (port of pql_tpu/models/diffusion.py).

DDPM ε-prediction policies: a conditional noise-prediction net denoises a
Gaussian action sample through ``diffusion_iter`` reverse steps
(``ops/ddpm.py``).

- ``mish``, ``SinusoidalPosEmb`` (the frequency divisor is half − 1);
- ``DiffusionNet``: a time MLP dim → 4·dim → dim with Mish, then
  concat(t, cond, x) → [1024, 512, 256] Mish → the action;
- ``MLPResNetBlock`` / ``MLPResNet``: the residual MLP variant, with a
  flax-rule ``LayerNorm`` (eps 1e-6) and a dropout that draws from an
  explicit generator, or is off when ``deterministic``;
- ``DDPMPolicy``, the interface both diffusion policies share:
  ``get_actions(obs, x_T, step_noise)`` runs the reverse diffusion from the
  given draws (``ops.ddpm.draw_sample``) and returns the first
  ``action_dim`` columns; ``get_loss(obs, action, noise, timesteps)`` is the
  ε-MSE on the action noised at integer ``timesteps``;
- ``StateDiffusionPolicy``: state-conditioned, on ``DiffusionNet``.

``DiffusionPolicy`` (conditioned on the point-cloud ``Encoder``) comes with
the vision tier, which ports the encoder.

Linear maps are ``models/mlp.py``'s ``Linear`` ([out, in] weight, init from
an explicit generator, a compute dtype); submodule names follow the flax
modules for ``utils/convert.py``: a flax ``TorchLinear_i`` is ``layers.i``
(``DiffusionNet``: 0-1 the time MLP, 2-5 the trunk), ``MLPResNetBlock_i``
``blocks.i`` with ``norm`` (``LayerNorm_0``), ``dense1`` (``TorchLinear_0``)
and ``dense2``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pql_tpu_torch.models.mlp import Linear
from pql_tpu_torch.ops.ddpm import DDPMSchedule, ddpm_add_noise, ddpm_sample


def mish(x: torch.Tensor) -> torch.Tensor:
    """x · tanh(softplus(x))."""
    return F.mish(x)


class SinusoidalPosEmb(nn.Module):
    """[B] float timesteps → [B, dim]: sin ∥ cos of t · 10000^(−k/(half−1))."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        emb = math.log(10000.0) / (half - 1)
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
        ang = t[:, None] * freqs[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class DiffusionNet(nn.Module):
    """ε-prediction MLP on (x [B, x_dim], time [B], cond [B, cond_dim])."""

    TRUNK = (1024, 512, 256)

    def __init__(self, x_dim: int, cond_dim: int, out_dim: int, dim: int = 256, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_emb = SinusoidalPosEmb(dim)
        dims = [dim + cond_dim + x_dim, *self.TRUNK, out_dim]
        self.layers = nn.ModuleList([Linear(dim, 4 * dim, gen, dtype), Linear(4 * dim, dim, gen, dtype)]
                                    + [Linear(dims[i], dims[i + 1], gen, dtype) for i in range(len(dims) - 1)])

    def forward(self, x, time, cond):
        t = self.layers[1](mish(self.layers[0](self.pos_emb(time))))
        h = torch.cat([t.float(), cond, x], dim=-1)
        for layer in self.layers[2:-1]:
            h = mish(layer(h))
        return self.layers[-1](h).float()


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm(epsilon=1e-6) over the last axis: statistics in
    fp32 with the variance E[x²] − E[x]² (clamped at 0), then
    (x − mean) · (rsqrt(var + eps) · scale) + bias, in the compute dtype."""

    def __init__(self, features: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.compute_dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp(torch.mean(x * x, -1, keepdim=True) - mean * mean, min=0.0)
        return ((x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias).to(self.compute_dtype)


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """flax's Dropout: keep each element with probability 1 − rate, scaled by 1/(1 − rate)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class MLPResNetBlock(nn.Module):
    """x + dense2(mish(dense1(norm(dropout(x)))))."""

    def __init__(self, features: int, dropout_rate: float | None = None, use_layer_norm: bool = False,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm = LayerNorm(features, dtype=dtype) if use_layer_norm else None
        self.dense1 = Linear(features, 4 * features, gen, dtype)
        self.dense2 = Linear(4 * features, features, gen, dtype)

    def forward(self, x, deterministic: bool = True, gen: torch.Generator | None = None):
        residual = x
        if self.dropout_rate and not deterministic:
            if gen is None:
                raise ValueError("a non-deterministic dropout needs a generator")
            x = dropout(x, self.dropout_rate, gen)
        if self.norm is not None:
            x = self.norm(x)
        return residual + self.dense2(mish(self.dense1(x)))


class MLPResNet(nn.Module):
    """Linear(in → hidden), ``num_blocks`` residual blocks, Mish, Linear(hidden → out)."""

    def __init__(self, num_blocks: int, in_dim: int, out_dim: int, hidden_dim: int = 256, dropout_rate: float = 0.1,
                 use_layer_norm: bool = True, gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([Linear(in_dim, hidden_dim, gen, dtype), Linear(hidden_dim, out_dim, gen, dtype)])
        self.blocks = nn.ModuleList(MLPResNetBlock(hidden_dim, dropout_rate, use_layer_norm, gen, dtype)
                                    for _ in range(num_blocks))

    def forward(self, x, deterministic: bool = True, gen: torch.Generator | None = None):
        x = self.layers[0](x)
        for block in self.blocks:
            x = block(x, deterministic, gen)
        return self.layers[1](mish(x)).float()


class DDPMPolicy(nn.Module):
    """What both diffusion policies share: ``net(x, t, cond)`` predicts the
    noise, ``sched`` is the DDPM schedule; ``action_dim`` and ``sample_dim``
    (= action_dim · horizon) are set by the subclass."""

    def forward(self, obs, x_T, step_noise):
        return self.get_actions(obs, x_T, step_noise)

    def get_actions(self, obs, x_T, step_noise):
        """The first action block of the reverse diffusion from x_T [B, d]
        with ``step_noise`` [T, B, d]."""
        out = ddpm_sample(self.sched, lambda x, t: self.net(x, t, obs), x_T, step_noise)
        return out[:, : self.action_dim]

    def get_loss(self, obs, action, noise, timesteps):
        """mean((ε̂(x_t, t, obs) − noise)²) with x_t the action noised at ``timesteps`` [B] (int)."""
        noisy = ddpm_add_noise(self.sched, action, noise, timesteps)
        eps = self.net(noisy, timesteps.float(), obs)
        return torch.mean(torch.square(eps - noise))


class StateDiffusionPolicy(DDPMPolicy):
    """A state-conditioned DDPM policy on ``DiffusionNet``: the plain-network
    counterpart of ``EquivariantDiffusionPolicy`` (``models/ediffusion.py``)."""

    def __init__(self, obs_dim: int, action_dim: int, diffusion_iter: int = 5, horizon: int = 1,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.action_dim, self.horizon = action_dim, horizon
        self.sample_dim = action_dim * horizon
        self.net = DiffusionNet(self.sample_dim, obs_dim, self.sample_dim, gen=gen, dtype=dtype)
        self.sched = DDPMSchedule(diffusion_iter)
