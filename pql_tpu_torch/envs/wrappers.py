"""Task wrappers (port of pql_tpu/envs/wrappers.py:24-70). ``VecEnv`` already
force-resets and tasks return flat obs, so these adapt tasks that need it:

- ``FlatObTask`` turns a task whose ``get_obs`` returns a dict of [E, d]
  tensors into one of flat [E, D] obs (keys sorted unless given), and keeps
  each key's column range in ``slices``;
- ``ClipActionTask`` clips actions to [-1, 1] before the task's dynamics.

Both are Task → Task, so they stack and run under ``VecEnv`` unchanged.
"""

from __future__ import annotations

import torch


class FlatObTask:
    def __init__(self, task, keys: tuple[str, ...] | None = None):
        self._task = task
        gen = torch.Generator().manual_seed(0)
        probe = task.get_obs(task.init_state(task.draw_reset(gen, 1)))
        if not isinstance(probe, dict):
            raise ValueError("FlatObTask expects a dict-observation task")
        self.keys = tuple(keys or sorted(probe))
        self.slices, start = {}, 0
        for k in self.keys:
            d = int(probe[k].shape[-1])
            self.slices[k] = (start, start + d)
            start += d
        self.obs_dim = start
        self.action_dim = task.action_dim
        self.max_episode_length = task.max_episode_length

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        return self._task.draw_reset(gen, num_envs)

    def init_state(self, draw: torch.Tensor):
        return self._task.init_state(draw)

    def get_obs(self, state) -> torch.Tensor:
        obs = self._task.get_obs(state)
        return torch.cat([obs[k] for k in self.keys], dim=-1)

    def dynamics(self, state, action: torch.Tensor, *step_draw: torch.Tensor):
        return self._task.dynamics(state, action, *step_draw)


class ClipActionTask:
    def __init__(self, task):
        self._task = task
        self.obs_dim = task.obs_dim
        self.action_dim = task.action_dim
        self.max_episode_length = task.max_episode_length

    def __getattr__(self, name):
        return getattr(self._task, name)

    def dynamics(self, state, action: torch.Tensor, *step_draw: torch.Tensor):
        return self._task.dynamics(state, torch.clamp(action, -1.0, 1.0), *step_draw)
