"""Exploration noise (port of pql_tpu/ops/noise.py).

Each function takes its standard-normal draw as an argument instead of a
key, so the caller owns the generator and a test can hand in the JAX
package's numbers. Noise is clipped to ``noise_bounds`` first and the sum
to ``out_bounds`` after (noise.py:97-101).
"""

from __future__ import annotations

import torch


def mixed_noise_std(
    num_envs_global: int,
    std_min: float,
    std_max: float,
    global_start: int = 0,
    num_local: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Per-env std ladder over the GLOBAL env index:
    linspace(std_min, std_max, E_global)[start:start+local] (noise.py:59-77)."""
    num_local = num_local if num_local is not None else num_envs_global
    if num_envs_global == 1:
        return torch.full((1,), std_min, dtype=torch.float32, device=device)
    step = (std_max - std_min) / (num_envs_global - 1)
    idx = torch.arange(num_local, dtype=torch.float32, device=device) + float(global_start)
    return std_min + step * idx


def _bound(out: torch.Tensor, bounds: tuple[float, float] | None) -> torch.Tensor:
    return out if bounds is None else torch.clamp(out, bounds[0], bounds[1])


def add_normal_noise(
    x: torch.Tensor,
    normal: torch.Tensor,
    std: float,
    noise_bounds: tuple[float, float] | None = None,
    out_bounds: tuple[float, float] | None = None,
) -> torch.Tensor:
    """x + clip(std · normal), then clamp (noise.py:32-56)."""
    noise = _bound(normal * std, noise_bounds)
    return _bound(x + noise, out_bounds)


def add_mixed_normal_noise(
    x: torch.Tensor,  # [E_local, act_dim]
    normal: torch.Tensor,  # [E_local, act_dim] standard normal
    std_min: float,
    std_max: float,
    noise_bounds: tuple[float, float] | None = None,
    out_bounds: tuple[float, float] | None = None,
    num_envs_global: int | None = None,
    global_start: int = 0,
) -> torch.Tensor:
    """Per-env mixed-std noise (noise.py:80-102)."""
    e_local = x.shape[0]
    e_global = num_envs_global if num_envs_global is not None else e_local
    std = mixed_noise_std(e_global, std_min, std_max, global_start, e_local, x.device)
    noise = _bound(normal * std[:, None], noise_bounds)
    return _bound(x + noise, out_bounds)
