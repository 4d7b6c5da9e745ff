"""Polyak averaging of target parameters (port of pql_tpu/ops/soft_update.py)."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def soft_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """target ← (1-τ)·target + τ·online, in place."""
    t = list(target.parameters())
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, list(online.parameters()), alpha=tau)
