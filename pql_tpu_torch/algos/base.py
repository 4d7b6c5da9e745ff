"""Shared actor-critic machinery (port of pql_tpu/algos/base.py:61-90,136-144).

The optimizer is the JAX package's optax chain
``clip_by_global_norm(max_norm)`` then ``adamw(lr, 0.9, 0.999, 1e-8,
weight_decay=0.01)`` over every parameter, biases included. AdamW is
``torch.optim.AdamW``; the clip is written by hand because
``torch.nn.utils.clip_grad_norm_`` scales by max/(norm+1e-6) and always
applies, while optax scales by max/norm and only when norm ≥ max.
"""

from __future__ import annotations

import torch
from torch import nn

from pql_tpu_torch.models import get_model
from pql_tpu_torch.ops.noise import add_normal_noise


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.algo.compute_dtype == "bfloat16" else torch.float32


def build_actor(cfg, obs_dim: int, act_dim: int, gen: torch.Generator) -> nn.Module:
    """The policy named by cfg.algo.act_class."""
    cls = get_model(cfg.algo.act_class)
    return cls(obs_dim, act_dim, gen=gen, dtype=compute_dtype(cfg))


def build_critic(cfg, obs_dim: int, act_dim: int, gen: torch.Generator) -> nn.Module:
    """The critic named by cfg.algo.cri_class; distl=True prepends
    'Distributional' (reference pql_v_learner.py:30-31)."""
    name = cfg.algo.cri_class
    if cfg.algo.distl and "Distributional" not in name:
        name = "Distributional" + name
    kwargs = {}
    if "Distributional" in name:
        kwargs = dict(v_min=cfg.algo.v_min, v_max=cfg.algo.v_max, num_atoms=cfg.algo.num_atoms)
    return get_model(name)(obs_dim, act_dim, gen=gen, dtype=compute_dtype(cfg), **kwargs)


def build_optimizer(module: nn.Module, lr: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g ← g / norm · max where
    norm ≥ max, unchanged otherwise. Sync-free on the device."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def optimizer_step(opt: torch.optim.Optimizer, params: list[torch.Tensor],
                   grads: list[torch.Tensor], max_grad_norm: float | None) -> None:
    """Clip (if max_grad_norm is set), then one AdamW step with ``grads``."""
    if max_grad_norm is not None:
        clip_by_global_norm_(grads, max_grad_norm)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def target_policy_actions(cfg, actor: nn.Module, next_obs: torch.Tensor, normal: torch.Tensor):
    """Target-policy smoothing: actor(next_obs) + clip(std·normal, ±b),
    clamped to ±1 (reference ddpg.py:71-79)."""
    b = cfg.algo.noise.tgt_pol_noise_bound
    return add_normal_noise(
        actor(next_obs), normal, cfg.algo.noise.tgt_pol_std, noise_bounds=(-b, b), out_bounds=(-1.0, 1.0)
    )
