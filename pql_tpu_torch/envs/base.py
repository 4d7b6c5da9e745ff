"""Batched auto-resetting environment (port of pql_tpu/envs/base.py).

The JAX package writes single-env dynamics and vmaps them; here a Task
works on an explicit leading ``[E]`` batch dimension. The step contract is
the same:

- auto-reset: a done env returns its new episode's first observation,
- ``info['truncated']`` marks time-limit endings (consumed by
  ``handle_timeout``),
- obs and reward pass through ``nan_to_num``.

Randomness never comes from a global RNG: the fresh episode states used by
auto-reset are drawn by the caller (``Task.draw_reset``) and handed to
``step``, which is the seam the parity tests inject JAX's draws through. A
task that draws inside its dynamics (the hand re-samples its goal on
success) also has ``draw_step(gen, E)``; the caller hands that draw to
``step`` too, which passes it to ``dynamics`` as a third argument (the
JAX package derives it per env from the step's key, ``fold_in(k_dyn, i)``).

A task on the ported engine (``GraphedTask``: the rigid tasks, the hand's
bowl palm, FrankaCubeStack) runs its control step on a card as one captured
CUDA graph per (E, device) (``GraphedStep``): eagerly it is tens of
thousands of launches, more than the host can issue. The CPU runs it
eagerly. A failed capture or replay raises; nothing falls back to eager.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import torch

from pql_tpu_torch.ops import graphs


class Task(Protocol):
    """Batched dynamics over a leading env dimension."""

    obs_dim: int
    action_dim: int
    max_episode_length: int

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """Random numbers that ``init_state`` turns into fresh episodes."""

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        """Fresh episode states from a ``draw_reset`` draw."""

    def get_obs(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        """[E, obs_dim] observations."""

    def dynamics(self, state: dict[str, torch.Tensor], action: torch.Tensor, *step_draw: torch.Tensor):
        """One step: (next_state, reward [E], terminated [E] bool, info).
        ``step_draw``: the ``draw_step`` draw, for tasks that have one."""


class GraphedStep(graphs.StaticGraph):
    """A pure step ``fn(state, *inputs) -> (next_state, reward, terminated,
    info)`` as a CUDA graph, called as fn is, with the env layer's spans and
    counters (``env.graph_*``, ``setup.graph_warmup/capture/instantiate``)."""

    def __init__(self, fn, state: dict[str, torch.Tensor], *inputs: torch.Tensor):
        super().__init__(fn, (state, *inputs), "env", warmup="setup.graph_warmup", capture="setup.graph_capture",
                         instantiate="setup.graph_instantiate", out="env.graph_out")


class GraphedTask:
    """What every task on the ported engine shares: its tensor constants,
    built once per device by ``_make_consts`` (a graph capture allows no
    host-to-device copy), and ``dynamics``, which runs ``control_step``
    eagerly on the CPU and through one ``GraphedStep`` per (E, device) on a
    card."""

    def __init__(self):
        self._consts: dict[torch.device, object] = {}
        self._graphs: dict[tuple[int, torch.device], GraphedStep] = {}

    def _make_consts(self, device: torch.device):
        raise NotImplementedError

    def _on(self, device: torch.device):
        c = self._consts.get(device)
        if c is None:
            c = self._consts[device] = self._make_consts(device)
        return c

    def control_step(self, state, action, *draw):
        """One control step, eagerly: (next_state, reward [E], terminated [E], info)."""
        raise NotImplementedError

    def dynamics(self, state: dict[str, torch.Tensor], action: torch.Tensor, *draw: torch.Tensor):
        """``control_step``; on a CUDA device through its captured graph."""
        if action.device.type != "cuda":
            return self.control_step(state, action, *draw)
        key = (action.shape[0], action.device)
        graph = self._graphs.get(key)
        if graph is None:
            self._on(action.device)  # constants first: capture allows no copies from the host
            graph = self._graphs[key] = GraphedStep(self.control_step, state, action, *draw)
        return graph(state, action, *draw)


@dataclass
class VecEnvState:
    state: dict[str, torch.Tensor]  # every leaf [E, ...]
    time: torch.Tensor  # [E] int32 — steps since episode start


class VecEnv:
    """Batched auto-resetting environment over a Task."""

    def __init__(self, task: Task, num_envs: int):
        self.task = task
        self.num_envs = num_envs
        self.obs_dim = task.obs_dim
        self.action_dim = task.action_dim
        self.max_episode_length = task.max_episode_length
        # a two-agent task carries a MultiAgentSpec (utils/symmetry.py)
        self.multi = getattr(task, "multi", None)

    def symmetry_tracker(self, s: VecEnvState) -> torch.Tensor:
        """[E] mirrored-episode flags from a task with ``get_symmetry``;
        zeros for the others."""
        if hasattr(self.task, "get_symmetry"):
            return self.task.get_symmetry(s.state)
        return torch.zeros(self.num_envs, dtype=torch.float32, device=s.time.device)

    def reset(self, draw: torch.Tensor):
        state = self.task.init_state(draw)
        time = torch.zeros(self.num_envs, dtype=torch.int32, device=draw.device)
        return VecEnvState(state=state, time=time), self.task.get_obs(state)

    def step(self, s: VecEnvState, actions: torch.Tensor, reset_draw: torch.Tensor,
             step_draw: torch.Tensor | None = None):
        """Lockstep step with auto-reset; ``reset_draw`` holds every env's
        would-be fresh state (only done envs use theirs); ``step_draw`` is
        the task's ``draw_step`` draw, None for a task without one.

        Returns (state, obs, reward, done, info) with done = terminated or
        truncated, as float32.
        """
        extra = () if step_draw is None else (step_draw,)
        next_state, reward, terminated, info = self.task.dynamics(s.state, actions, *extra)
        time = s.time + 1
        truncated = (time >= self.max_episode_length) & ~terminated
        done = terminated | truncated

        fresh = self.task.init_state(reset_draw)
        next_state = {
            k: torch.where(done.view((-1,) + (1,) * (v.dim() - 1)), fresh[k], v)
            for k, v in next_state.items()
        }
        time = torch.where(done, torch.zeros_like(time), time)
        obs = self.task.get_obs(next_state)

        info = dict(info)  # a nested dict (``detailed_reward``) passes through as it is
        info["truncated"] = truncated
        return (
            VecEnvState(state=next_state, time=time),
            torch.nan_to_num(obs),
            torch.nan_to_num(reward.float()),
            done.float(),
            info,
        )


def handle_timeout(done: torch.Tensor, info: dict) -> torch.Tensor:
    """Bootstrap through timeouts: clear done where truncated."""
    truncated = info.get("truncated")
    if truncated is None:
        return done
    return done * (1.0 - truncated.to(done.dtype))
