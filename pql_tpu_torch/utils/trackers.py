"""Sliding-window episode trackers (port of pql_tpu/utils/trackers.py:22-55).

A ring of the last ``length`` finished-episode values; the mean is over
min(count, length) inserted values. Insertion is sync-free on the device:
masked lanes take consecutive slots in env order.

Rule when more than ``length`` values arrive in one update (every env of
Cartpole@4096 times out together at step 500): the ring keeps the LAST
``length`` of them in env order, each at the slot sequential insertion
would give it. The JAX package scatters all of them and XLA leaves the
winner of duplicate slots unspecified, so rings are compared only when
fewer than ``length`` values arrive at once.
"""

from __future__ import annotations

import torch


class Tracker:
    def __init__(self, length: int, device="cuda"):
        self.length = length
        self.ring = torch.zeros(length, dtype=torch.float32, device=device)
        self.ptr = torch.zeros((), dtype=torch.int64, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)

    @torch.no_grad()
    def update(self, values: torch.Tensor, mask: torch.Tensor) -> None:
        """Insert values[i] where mask[i], in env order."""
        mask = mask.to(torch.int64)
        offsets = torch.cumsum(mask, 0) - 1  # slot offset of each masked lane
        n_new = mask.sum()
        keep = (mask > 0) & (offsets >= n_new - self.length)  # the last `length` of them
        slots = torch.where(keep, (self.ptr + offsets) % self.length, self.length)
        ring = torch.cat([self.ring, self.ring.new_zeros(1)])  # slot `length` swallows the rest
        ring.scatter_(0, slots, values.float())
        self.ring.copy_(ring[: self.length])
        self.ptr.copy_((self.ptr + n_new) % self.length)
        self.count.add_(n_new)

    def mean(self) -> torch.Tensor:
        n = torch.clamp(self.count, max=self.length)
        valid = (torch.arange(self.length, device=self.ring.device) < n).float()
        return torch.sum(self.ring * valid) / torch.clamp(n.float(), min=1.0)
