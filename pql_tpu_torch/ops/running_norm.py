"""Running mean/std observation normalizer (port of pql_tpu/ops/running_norm.py).

Chan et al. parallel merge of batch moments, batch variance with ddof=1,
count starting at epsilon=1e-4 (reference torch_util.py:68-114). The batch
moments are taken the way the JAX package's ``update_sharded`` takes them
(mean, then the sum of squared deviations over n-1), which on one device is
the whole batch. ``normalize`` has no clamp (the actor); ``normalize_clip``
clamps to ±5 (the learners, reference common.py:139-145); ``unnormalize``
is normalize's inverse (PPO's value normalization).

``update_sharded`` merges a batch split over the ranks of a process group
(the JAX package's ``update_sharded``, running_norm.py:49-61): all-reduce
the count and Σx, then Σ(x − ḡ)² about the global mean, unbiased; every
rank ends with the same moments, within fp32 reassociation of the
one-process update on the gathered batch.

The moments live in tensors on the device and are updated in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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
        self._merge(batch_mean, ((x - batch_mean) ** 2).sum(0) / max(n - 1, 1), n)

    @torch.no_grad()
    def update_sharded(self, x: torch.Tensor, group=None) -> None:
        """``update`` of the batch whose rows are split over ``group``'s ranks
        (x: this rank's rows)."""
        n_total = torch.tensor(float(x.shape[0]), dtype=torch.float32, device=x.device)
        dist.all_reduce(n_total, group=group)
        gsum = x.sum(0)
        dist.all_reduce(gsum, group=group)
        gmean = gsum / n_total
        gsumsq = ((x - gmean) ** 2).sum(0)
        dist.all_reduce(gsumsq, group=group)
        self._merge(gmean, gsumsq / torch.clamp(n_total - 1.0, min=1.0), n_total)

    def _merge(self, batch_mean, batch_var, n) -> None:
        """Chan et al.'s merge of a batch's moments (torch_util.py:91-103)."""
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
