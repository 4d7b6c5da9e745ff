"""Noise-decay and weight schedules (port of pql_tpu/ops/schedules.py).

Evaluated on the host at the iteration index, which the port keeps as a
Python integer; float32 arithmetic as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LinearSchedule:
    """start_val → end_val over total_iters steps, then held (EQSD2's KL
    weight, kl_max → 0 over kl_decay_iters)."""

    start_val: float
    end_val: float
    total_iters: int

    def __call__(self, step: int) -> float:
        f32 = np.float32
        frac = np.clip(f32(step) / f32(self.total_iters), f32(0.0), f32(1.0))
        start, end = f32(self.start_val), f32(self.end_val)
        return float(start + (end - start) * frac)


def schedule_value(noise_cfg, step: int) -> float:
    """Current exploration std (reference pql_actor.py:59-69): std_max
    without decay, else the linear or exponential schedule toward std_min."""
    f32 = np.float32
    if noise_cfg.decay == "linear":
        return LinearSchedule(noise_cfg.std_max, noise_cfg.std_min, noise_cfg.lin_decay_iters)(step)
    if noise_cfg.decay == "exp":
        val = f32(noise_cfg.std_max) * np.power(f32(noise_cfg.exp_decay_rate), f32(step))
        end = f32(noise_cfg.std_min)
        return float(max(val, end) if noise_cfg.std_min <= noise_cfg.std_max else min(val, end))
    return float(np.float32(noise_cfg.std_max))
