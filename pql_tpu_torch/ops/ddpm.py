"""The DDPM noise schedule and sampler of the diffusion policies (port of
pql_tpu/ops/ddpm.py).

diffusers' DDPMScheduler with ``beta_schedule='squaredcos_cap_v2'``,
``clip_sample=True`` and ``prediction_type='epsilon'``, as the JAX
package writes it:

- squaredcos_cap_v2: ᾱ(t) = cos²(((t/T)+0.008)/1.008 · π/2),
  β_i = min(1 − ᾱ((i+1)/T)/ᾱ(i/T), 0.999), built in float32 as the JAX
  package builds it (a float64 schedule rounds differently);
- add_noise: x_t = √ᾱ_t x₀ + √(1−ᾱ_t) ε;
- step (variance 'fixed_small'): x̂₀ = (x_t − √(1−ᾱ_t) ε̂)/√ᾱ_t, always
  clipped to [−1, 1] (no caller of the JAX package turns the clip off); the
  posterior mean from x̂₀ and x_t; variance β̃_t = (1−ᾱ_{t−1})/(1−ᾱ_t)·β_t
  (at least 1e−20), noise added for t > 0 (at t = 0 the draw is multiplied
  by 0, and ᾱ_{−1} = 1).

The draws come in as tensors: ``ddpm_sample`` takes x_T [B, d] and one
standard normal per reverse step, ``step_noise`` [T, B, d], row i for
t = T−1−i (``draw_sample`` makes both from a generator), so a test can hand
in the JAX key chain's numbers. The reverse loop runs on the host over T
steps, as the reference's does (the JAX package scans it inside jit).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


class DDPMSchedule(nn.Module):
    """β, α and ᾱ [T] in float32 as non-persistent buffers: they follow
    ``.to()`` and stay out of a policy's ``state_dict``."""

    def __init__(self, num_timesteps: int):
        super().__init__()
        self.num_timesteps = num_timesteps
        t = torch.arange(num_timesteps + 1, dtype=torch.float32) / num_timesteps

        def alpha_bar(x):
            return torch.cos((x + 0.008) / 1.008 * math.pi / 2.0) ** 2

        betas = torch.clamp(1.0 - alpha_bar(t[1:]) / alpha_bar(t[:-1]), max=0.999)
        alphas = 1.0 - betas
        self.register_buffer("betas", betas, persistent=False)
        self.register_buffer("alphas", alphas, persistent=False)
        self.register_buffer("alphas_cumprod", torch.cumprod(alphas, 0), persistent=False)


def ddpm_add_noise(sched: DDPMSchedule, x0: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor):
    """The forward process q(x_t | x₀) at integer ``timesteps`` [B]."""
    a_bar = sched.alphas_cumprod[timesteps]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return torch.sqrt(a_bar).reshape(shape) * x0 + torch.sqrt(1.0 - a_bar).reshape(shape) * noise


def ddpm_step(sched: DDPMSchedule, eps_pred: torch.Tensor, t: int, x_t: torch.Tensor, noise: torch.Tensor):
    """One reverse (ancestral) step from t to t−1 with the standard normal ``noise``."""
    a_bar_t = sched.alphas_cumprod[t]
    a_bar_prev = sched.alphas_cumprod[t - 1] if t > 0 else torch.ones_like(a_bar_t)
    beta_t, alpha_t = sched.betas[t], sched.alphas[t]

    x0 = torch.clamp((x_t - torch.sqrt(1.0 - a_bar_t) * eps_pred) / torch.sqrt(a_bar_t), -1.0, 1.0)

    coef_x0 = torch.sqrt(a_bar_prev) * beta_t / (1.0 - a_bar_t)
    coef_xt = torch.sqrt(alpha_t) * (1.0 - a_bar_prev) / (1.0 - a_bar_t)
    mean = coef_x0 * x0 + coef_xt * x_t

    var = torch.clamp((1.0 - a_bar_prev) / (1.0 - a_bar_t) * beta_t, min=1e-20)
    return mean + (torch.sqrt(var) if t > 0 else 0.0) * noise


def ddpm_sample(sched: DDPMSchedule, eps_fn: Callable, x_T: torch.Tensor, step_noise: torch.Tensor) -> torch.Tensor:
    """The reverse diffusion x_T → x₀. ``eps_fn(x_t, t_batch)`` predicts the
    noise; ``t_batch`` is float [B] (the reference feeds ``ones(B) * k``)."""
    x = x_T
    for i, t in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t_batch = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        x = ddpm_step(sched, eps_fn(x, t_batch), t, x, step_noise[i])
    return x


def draw_sample(gen: torch.Generator, batch: int, dim: int, num_timesteps: int):
    """(x_T [B, d], step_noise [T, B, d]): the standard normals of one
    ``ddpm_sample``, drawn on ``gen``'s device."""
    x_T = torch.randn(batch, dim, generator=gen, device=gen.device)
    return x_T, torch.randn(num_timesteps, batch, dim, generator=gen, device=gen.device)
