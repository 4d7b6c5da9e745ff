"""C51 categorical distributional ops (port of pql_tpu/ops/distributional.py).

The plain dense hat-kernel projection,

    proj[b, j] = sum_i p[b, i] * max(0, 1 - |pos[b, i] - j|),
    pos = (clip(r + (1-d)·γ·z_i, v_min, v_max) - v_min) / Δz,

is the CPU path and the reference the CUDA kernel in ``ops/kernels.py``
is held against. It builds the [B, A, A] weight tensor, which the kernel
never does.
"""

from __future__ import annotations

import torch


def support_atoms(v_min: float, v_max: float, num_atoms: int, dtype=torch.float32, device=None):
    return torch.linspace(v_min, v_max, num_atoms, dtype=dtype, device=device)


def categorical_projection(
    next_dist: torch.Tensor,  # [B, A]
    reward: torch.Tensor,  # [B] or [B, 1]
    done: torch.Tensor,  # [B] or [B, 1]
    gamma: float,
    v_min: float = -10.0,
    v_max: float = 10.0,
) -> torch.Tensor:
    """Project r + (1-d)·γ·Z onto the fixed support (distributional.py:29-51)."""
    num_atoms = next_dist.shape[-1]
    delta_z = (v_max - v_min) / (num_atoms - 1)
    z = support_atoms(v_min, v_max, num_atoms, next_dist.dtype, next_dist.device)
    reward = reward.reshape(reward.shape[0], -1)
    done = done.reshape(done.shape[0], -1).to(next_dist.dtype)
    target_z = torch.clamp(reward + (1.0 - done) * gamma * z[None, :], v_min, v_max)
    pos = (target_z - v_min) / delta_z  # [B, A]
    atom_idx = torch.arange(num_atoms, dtype=next_dist.dtype, device=next_dist.device)
    w = torch.clamp(1.0 - torch.abs(pos[:, :, None] - atom_idx[None, None, :]), min=0.0)
    return torch.einsum("bi,bij->bj", next_dist, w)


def categorical_td_target(next_dist1, next_dist2, reward, done, gamma_n, v_min, v_max):
    """Elementwise min of the two projected twin distributions
    (reference pql_v_learner.py:83-102)."""
    p1 = categorical_projection(next_dist1, reward, done, gamma_n, v_min, v_max)
    p2 = categorical_projection(next_dist2, reward, done, gamma_n, v_min, v_max)
    return torch.minimum(p1, p2)


def dist_to_q(dist: torch.Tensor, v_min: float, v_max: float) -> torch.Tensor:
    """Expected value over the support (reference mlp.py:256-259)."""
    z = support_atoms(v_min, v_max, dist.shape[-1], dist.dtype, dist.device)
    return torch.sum(dist * z, dim=-1)


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Mean over all elements, pred clipped to [eps, 1-eps] (distributional.py:77-81)."""
    pred = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(target * torch.log(pred) + (1.0 - target) * torch.log1p(-pred))
