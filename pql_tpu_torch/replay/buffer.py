"""On-device circular replay buffer (port of pql_tpu/replay/buffer.py).

One packed tensor ``[slots, E, D]`` holds obs ∥ action ∥ reward ∥
next_obs ∥ done along the feature axis, described by a ``layout`` tuple of
(name, start, dim). A batch is one row gather. The JAX package pads rows
narrower than 64 columns for the TPU's lanes; the port does not, so rows
are exactly D wide and parity is checked on field views.

A batch is either iid (slot, env) pairs or, with ``algo.sample_slots`` =
n > 0, a slot-stratified window: n random slots, and from each the same
B/n consecutive envs from a random circular offset (``window_index``).

Pointers and counters are Python integers (the write pattern is fixed by
the loop), so sampling needs no host-device sync. A ``valid_start``
watermark excludes the first nstep-1 slots, written while the n-step FIFO
was filling, until the ring first wraps.
"""

from __future__ import annotations

import torch

from pql_tpu_torch.replay.nstep import FIELDS


def replay_slots(memory_size: int, num_envs: int, write_len: int = 1) -> int:
    """Ring depth for a transition capacity, rounded down to a multiple of
    the per-call write length so writes never wrap mid-chunk."""
    slots = max(int(memory_size) // num_envs, 1)
    return max((slots // write_len) * write_len, write_len)


class ReplayBuffer:
    def __init__(self, slots, num_envs, obs_dim, action_dim, dtype=torch.float32,
                 valid_start=0, device="cuda"):
        dims = [("obs", obs_dim), ("action", action_dim), ("reward", 1),
                ("next_obs", obs_dim), ("done", 1)]
        layout, start = [], 0
        for name, dim in dims:
            layout.append((name, start, dim))
            start += dim
        self.layout = tuple(layout)
        self.slots = slots
        self.num_envs = num_envs
        self.data = torch.zeros(slots, num_envs, start, dtype=dtype, device=device)
        self.ptr = 0
        self.total_writes = 0
        self.valid_start_init = valid_start

    @property
    def filled(self) -> int:
        return min(self.total_writes, self.slots)

    @property
    def valid_start(self) -> int:
        return 0 if self.total_writes > self.slots else self.valid_start_init

    def field_range(self, name: str) -> tuple[int, int]:
        for n, s, d in self.layout:
            if n == name:
                return s, d
        raise KeyError(f"replay field {name!r}; have {[n for n, _, _ in self.layout]}")

    def field(self, name: str) -> torch.Tensor:
        """[slots, E, dim] view of one packed field."""
        s, d = self.field_range(name)
        return self.data[..., s : s + d]

    @torch.no_grad()
    def add(self, rows: dict[str, torch.Tensor]) -> None:
        """Write a [T, E, ...] chunk at the ring pointer, with wraparound."""
        packed = torch.cat([rows[name].to(self.data.dtype) for name, _, _ in self.layout], dim=-1)
        t = packed.shape[0]
        if self.ptr + t <= self.slots:
            self.data[self.ptr : self.ptr + t] = packed
        else:
            idx = (self.ptr + torch.arange(t, device=self.data.device)) % self.slots
            self.data[idx] = packed
        self.ptr = (self.ptr + t) % self.slots
        self.total_writes += t

    def _slot_index(self, raw_slot: torch.Tensor) -> torch.Tensor:
        """slot = valid_start + raw_slot % span (buffer.py:216-217, 229-230);
        ``raw_slot`` is uniform on [0, 2^30)."""
        lo = self.valid_start
        span = max(self.filled - lo, 1)
        return lo + torch.remainder(raw_slot, span)

    def sample_index(self, raw_slot: torch.Tensor, env_idx: torch.Tensor) -> torch.Tensor:
        """Flat row indices [..., B] of iid (slot, env) pairs."""
        return self._slot_index(raw_slot) * self.num_envs + env_idx

    def window_index(self, raw_slot: torch.Tensor, offset: torch.Tensor, batch_size: int) -> torch.Tensor:
        """Flat row indices [..., B] of the slot-stratified window
        (buffer.py:219-228): ``raw_slot`` [..., n] picks n slots, and each
        gives B/n consecutive envs from the circular offset ``offset`` [...],
        slot-major, as the JAX package's ``win.reshape(batch_size, -1)``.
        The JAX code gathers the n whole [E, D] slabs and slices the window
        out of them; the port gathers the same rows alone, in the same order."""
        per = batch_size // raw_slot.shape[-1]
        env = torch.remainder(offset[..., None] + torch.arange(per, device=offset.device), self.num_envs)
        rows = self._slot_index(raw_slot)[..., :, None] * self.num_envs + env[..., None, :]
        return rows.flatten(-2)

    def rows(self, index: torch.Tensor) -> torch.Tensor:
        """One row gather: [..., D] packed rows at flat indices ``index``."""
        return self.data.view(self.slots * self.num_envs, -1)[index]

    def split(self, rows: torch.Tensor, fields=FIELDS) -> dict[str, torch.Tensor]:
        """Field views of packed rows, as float32."""
        out = {}
        for name in fields:
            s, d = self.field_range(name)
            out[name] = rows[..., s : s + d].float()
        return out

    def sample(self, raw_slot: torch.Tensor, env_idx: torch.Tensor, fields=FIELDS) -> dict[str, torch.Tensor]:
        """Batch at slot = valid_start + raw_slot % span, env = env_idx
        (buffer.py:229-234): one [B, D] row gather."""
        return self.split(self.rows(self.sample_index(raw_slot, env_idx)), fields)


def window_fits(sample_slots: int, batch_size: int, num_envs: int) -> bool:
    """Whether ``sample_slots`` = n selects the slot-stratified window: n > 0,
    n divides the batch and B/n <= E; otherwise the sample is iid pairs
    (buffer.py:219)."""
    return bool(sample_slots) and batch_size % sample_slots == 0 and batch_size // sample_slots <= num_envs


def draw_sample_indices(gen: torch.Generator, count: int, batch_size: int, num_envs: int):
    """Raw slot draws on [0, 2^30) and env indices for ``count`` batches, [count, B] each."""
    raw = torch.randint(0, 1 << 30, (count, batch_size), generator=gen, device=gen.device)
    env = torch.randint(0, num_envs, (count, batch_size), generator=gen, device=gen.device)
    return raw, env


def draw_window_indices(gen: torch.Generator, count: int, sample_slots: int, num_envs: int):
    """Raw slot draws on [0, 2^30), [count, n], and circular env offsets on
    [0, E), [count], for ``count`` window batches."""
    raw = torch.randint(0, 1 << 30, (count, sample_slots), generator=gen, device=gen.device)
    off = torch.randint(0, num_envs, (count,), generator=gen, device=gen.device)
    return raw, off
