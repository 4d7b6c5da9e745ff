"""Sliding-window episode trackers (port of pql_tpu/utils/trackers.py:22-157).

A ring of the last ``length`` finished-episode values; the mean is over
min(count, length) inserted values. Insertion is sync-free on the device:
masked lanes take consecutive slots in env order.

Rule when more than ``length`` values arrive in one update (every env of
Cartpole@4096 times out together at step 500): the ring keeps the LAST
``length`` of them in env order, each at the slot sequential insertion
would give it. The JAX package scatters all of them and XLA leaves the
winner of duplicate slots unspecified, so rings are compared only when
fewer than ``length`` values arrive at once.

``EpisodeStats`` holds the baselines' per-env accumulators and trackers:
return, length and success, one per detailed-reward term, and one per
tracked info key.
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


INFO_MODES = ("last", "all-episode", "all-step")


class EpisodeStats:
    """Episode accounting of the off-policy baselines (port of
    pql_tpu/utils/trackers.py:58-157). On each step the unscaled reward and
    a step are added to every env's accumulators; an env that is done pushes
    its episode's return, length and (if the task reports it) success into
    the trackers and restarts them. Detailed-reward terms accumulate per
    episode alike. An info key is tracked by its mode: ``last`` pushes its
    value at the done step, ``all-episode`` its sum over the episode,
    ``all-step`` its value at every step of every env. Updated in place."""

    def __init__(self, num_envs: int, tracker_len: int = 100, detailed_keys: tuple = (),
                 info_keys: tuple = (), info_modes: tuple = (), device="cuda"):
        for mode in info_modes:
            if mode not in INFO_MODES:
                raise ValueError(f"info_track_step {mode!r}; one of {INFO_MODES}")
        zeros = lambda: torch.zeros(num_envs, dtype=torch.float32, device=device)  # noqa: E731
        self.current_returns = zeros()
        self.current_lengths = zeros()
        self.return_tracker = Tracker(tracker_len, device)
        self.step_tracker = Tracker(tracker_len, device)
        self.success_tracker = Tracker(tracker_len, device)
        self.detailed_acc = {k: zeros() for k in detailed_keys}
        self.detailed_tracker = {k: Tracker(tracker_len, device) for k in detailed_keys}
        self.info_keys, self.info_modes = tuple(info_keys), tuple(info_modes)
        self.info_acc = {k: zeros() for k in info_keys}
        self.info_tracker = {k: Tracker(tracker_len, device) for k in info_keys}

    @torch.no_grad()
    def update(self, reward: torch.Tensor, done: torch.Tensor, info: dict) -> None:
        returns = self.current_returns + reward
        lengths = self.current_lengths + 1.0
        done_mask = done > 0.5
        zero = torch.zeros_like(returns)
        self.return_tracker.update(returns, done_mask)
        self.step_tracker.update(lengths, done_mask)
        self.current_returns = torch.where(done_mask, zero, returns)
        self.current_lengths = torch.where(done_mask, zero, lengths)
        if "success" in info:
            self.success_tracker.update(info["success"].float(), done_mask)
        if self.detailed_acc and "detailed_reward" in info:
            for k, acc in self.detailed_acc.items():
                total = acc + info["detailed_reward"][k]
                self.detailed_tracker[k].update(total, done_mask)
                self.detailed_acc[k] = torch.where(done_mask, zero, total)
        for k, mode in zip(self.info_keys, self.info_modes):
            if k not in info:
                continue
            val = info[k].float()
            if mode == "last":
                self.info_tracker[k].update(val, done_mask)
            elif mode == "all-episode":
                total = self.info_acc[k] + val
                self.info_tracker[k].update(total, done_mask)
                self.info_acc[k] = torch.where(done_mask, zero, total)
            else:  # all-step: every step of every env
                self.info_tracker[k].update(val, torch.ones_like(done_mask))

    def metrics(self) -> dict[str, torch.Tensor]:
        out = {
            "train/return": self.return_tracker.mean(),
            "train/episode_length": self.step_tracker.mean(),
            "train/success_rate": self.success_tracker.mean(),
        }
        for k, t in self.detailed_tracker.items():
            out[f"train/detailed_reward/{k}"] = t.mean()
        for k, t in self.info_tracker.items():
            out[k] = t.mean()
        return out

    def trackers(self) -> dict[str, Tracker]:
        """Every tracker by a flat name (``detailed/<k>``, ``info/<k>``)."""
        out = {"return": self.return_tracker, "step": self.step_tracker, "success": self.success_tracker}
        out.update({f"detailed/{k}": t for k, t in self.detailed_tracker.items()})
        out.update({f"info/{k}": t for k, t in self.info_tracker.items()})
        return out

    def accumulators(self) -> dict[str, torch.Tensor]:
        """Every per-env accumulator by a flat name."""
        out = {"returns": self.current_returns, "lengths": self.current_lengths}
        out.update({f"detailed/{k}": v for k, v in self.detailed_acc.items()})
        out.update({f"info/{k}": v for k, v in self.info_acc.items()})
        return out

    def state_dict(self) -> dict:
        return dict(accumulators=self.accumulators(),
                    trackers={n: dict(ring=t.ring, ptr=t.ptr, count=t.count) for n, t in self.trackers().items()})

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Write a ``state_dict`` of stats with the same keys, on this device."""
        if set(sd["trackers"]) != set(self.trackers()):
            raise ValueError(f"episode stats {sorted(sd['trackers'])}, these {sorted(self.trackers())}")
        dev = self.current_returns.device
        for name, v in sd["accumulators"].items():
            v = v.to(dev)
            if name == "returns":
                self.current_returns = v
            elif name == "lengths":
                self.current_lengths = v
            else:
                kind, key = name.split("/", 1)
                (self.detailed_acc if kind == "detailed" else self.info_acc)[key] = v
        for name, t in self.trackers().items():
            for k in ("ring", "ptr", "count"):
                getattr(t, k).copy_(sd["trackers"][name][k])
