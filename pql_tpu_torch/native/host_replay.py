"""Host-memory replay over the native ring (port of pql_tpu/native/host_replay.py).

The heavy fields of a vision agent's replay (uint8 frames, fp16 rows) stay
in host RAM; each update gathers one [batch, dim] block per field there and
ships only that block to the card. Writes and the random-row gather run in
the C++ ring (``native/host_ring.cpp``: one ``malloc``'d arena per field,
a thread pool for the gather).

``sample`` draws its (slot, env) pairs from ``numpy.random.default_rng(0)``
in the JAX class's order (slot indices, then env indices, each
``integers(0, n, batch, dtype=int64)``), so the port samples the same rows
as the JAX package after the same writes. With ``out`` it gathers straight
into caller-owned CPU tensors (pinned staging buffers on the card's path);
the ring itself is never pinned: it is touched only where it is written.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch


class HostReplay:
    """Ring over named fields; all fields share (slots, num_envs)."""

    def __init__(self, slots: int, num_envs: int, field_dims: dict[str, int],
                 dtypes: dict[str, np.dtype] | None = None, threads: int = 0):
        from pql_tpu_torch.native import load_host_ring

        self._lib = load_host_ring()
        self.slots = int(slots)
        self.num_envs = int(num_envs)
        self.fields = dict(field_dims)
        self.dtypes = {k: np.dtype((dtypes or {}).get(k, np.float16)) for k in field_dims}
        self._rings = {}
        for k, dim in field_dims.items():
            h = self._lib.host_ring_create(self.slots, self.num_envs, int(dim) * self.dtypes[k].itemsize, threads)
            if not h:
                raise MemoryError(f"host_ring_create failed for field '{k}'")
            self._rings[k] = ctypes.c_void_p(h)
        self._rng = np.random.default_rng(0)

    def __del__(self):
        for h in getattr(self, "_rings", {}).values():
            self._lib.host_ring_destroy(h)

    def torch_dtype(self, field: str) -> torch.dtype:
        return torch.from_numpy(np.empty(0, self.dtypes[field])).dtype

    @property
    def filled(self) -> int:
        return int(self._lib.host_ring_filled(next(iter(self._rings.values()))))

    @property
    def ptr(self) -> int:
        return int(self._lib.host_ring_ptr(next(iter(self._rings.values()))))

    def add(self, rows: dict) -> None:
        """Write a [T, E, dim] chunk per field (arrays or CPU tensors; the
        ring wraps in C++)."""
        for k, v in rows.items():
            v = np.ascontiguousarray(np.asarray(v), dtype=self.dtypes[k])
            if v.shape[1] != self.num_envs or v[0, 0].size != self.fields[k]:
                raise ValueError(f"field {k!r}: chunk {v.shape} for {self.num_envs} envs × {self.fields[k]}")
            self._lib.host_ring_write(self._rings[k], v.ctypes.data, v.shape[0])

    def draw_index(self, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        """The next batch's (slot, env) indices, uniform over the filled slots."""
        filled = max(self.filled, 1)
        slot_idx = self._rng.integers(0, filled, batch_size, dtype=np.int64)
        env_idx = self._rng.integers(0, self.num_envs, batch_size, dtype=np.int64)
        return slot_idx, env_idx

    def sample(self, batch_size: int, fields: tuple[str, ...] | None = None, seed: int | None = None,
               out: dict[str, torch.Tensor] | None = None) -> dict:
        """Uniform (slot, env) sample gathered by the native thread pool:
        new numpy arrays [batch, dim], or ``out``'s CPU tensors filled in place."""
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        slot_idx, env_idx = self.draw_index(batch_size)
        sp = slot_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        ep = env_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        result = {}
        for k in fields or self.fields:
            if out is None:
                buf = np.empty((batch_size, self.fields[k]), dtype=self.dtypes[k])
                addr = buf.ctypes.data
            else:
                buf = out[k]
                want = self.torch_dtype(k)
                if (buf.device.type != "cpu" or buf.dtype != want or not buf.is_contiguous()
                        or tuple(buf.shape) != (batch_size, self.fields[k])):
                    raise ValueError(f"out[{k!r}]: want a contiguous CPU {want} tensor of "
                                     f"{(batch_size, self.fields[k])}, got {buf.dtype} {tuple(buf.shape)} "
                                     f"on {buf.device}")
                addr = buf.data_ptr()
            self._lib.host_ring_gather(self._rings[k], sp, ep, batch_size, addr)
            result[k] = buf
        return result
