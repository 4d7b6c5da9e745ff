"""Running mean/std observation normalizer (port of pql_tpu/ops/running_norm.py).

Chan et al. parallel merge of batch moments, batch variance with ddof=1,
count starting at epsilon=1e-4 (reference torch_util.py:68-114). The batch
moments are taken the way the JAX package's ``update_sharded`` takes them
(mean, then the sum of squared deviations over n-1), which on one device is
the whole batch. ``normalize`` has no clamp (the actor); ``normalize_clip``
clamps to ±5 (the learners, reference common.py:139-145); ``unnormalize``
is normalize's inverse (PPO's value normalization).

The moments live in tensors on the device and are updated in place.
"""

from __future__ import annotations

import torch


class RunningMeanStd:
    def __init__(self, shape, epsilon: float = 1e-4, device: str | torch.device = "cuda"):
        self.epsilon = epsilon
        self.mean = torch.zeros(shape, dtype=torch.float32, device=device)
        self.var = torch.ones(shape, dtype=torch.float32, device=device)
        self.count = torch.full((), epsilon, dtype=torch.float32, device=device)

    @torch.no_grad()
    def update(self, x: torch.Tensor) -> None:
        """Merge a batch (leading axis = batch) into the running moments."""
        n = x.shape[0]
        batch_mean = x.sum(0) / n
        batch_var = ((x - batch_mean) ** 2).sum(0) / max(n - 1, 1)
        delta = batch_mean - self.mean
        tot = self.count + n
        new_mean = self.mean + delta * n / tot
        m2 = self.var * self.count + batch_var * n + delta.square() * self.count * n / tot
        self.mean.copy_(new_mean)
        self.var.copy_(m2 / tot)
        self.count.copy_(tot)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / torch.sqrt(self.var + self.epsilon)

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(self.var + self.epsilon) + self.mean

    def normalize_clip(self, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        return torch.clamp(self.normalize(x), -clip, clip)
