"""Policy evaluation (port of pql_tpu/utils/evaluator.py:23-94).

A fresh eval-env batch is reset and rolled for one episode horizon
(``max_episode_length`` steps) with the deterministic policy on the
normalized, unclipped obs (``obs_rms.normalize``); finished episodes'
returns and lengths go into ``Tracker``s of ``eval_num_envs`` slots, whose
means are ``eval/return`` and ``eval/episode_length``.

Every random number of one rollout comes from ``draw``: the first reset,
one reset draw per step for auto-reset, and a per-step draw for a task that
has ``draw_step``. ``eval_policy`` takes such a dict (the parity tests hand
in the JAX package's draws) or draws from a ``torch.Generator``.

``eval_policy_async`` enqueues the rollout and returns device tensors
without waiting for the device; ``resolve`` turns them into floats. On one
stream the training work queued after the rollout runs after it, as the JAX
package's async dispatch queues its eval program between train blocks.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from pql_tpu_torch.envs.base import VecEnv
from pql_tpu_torch.utils.trackers import Tracker

EVAL_SEED_OFFSET = 1  # the eval draws' generator: seed + 1, apart from the loop's


class Evaluator:
    def __init__(self, cfg, env: VecEnv, actor_apply: Callable, device: str | torch.device = "cuda"):
        """actor_apply(actor, normalized_obs) -> deterministic action. A
        visual agent's hook has ``needs_env_state = True`` and also takes
        the eval env's state, which it renders its observations from."""
        self.cfg = cfg
        self.env = env
        self.actor_apply = actor_apply
        self._needs_env_state = bool(getattr(actor_apply, "needs_env_state", False))
        self.device = torch.device(device)
        self.start_time = time.time()

    def draw(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        """Every random number of one rollout, drawn on ``gen``'s device and
        returned on the evaluator's: ``init`` [E, k] (the first reset),
        ``reset`` [T, E, k] and, for a task with ``draw_step``, ``step`` [T, E, k]."""
        task, E, T = self.env.task, self.env.num_envs, self.env.max_episode_length
        d = {"init": task.draw_reset(gen, E)}
        d["reset"] = torch.stack([task.draw_reset(gen, E) for _ in range(T)])
        if hasattr(task, "draw_step"):
            d["step"] = torch.stack([task.draw_step(gen, E) for _ in range(T)])
        return {k: v.to(self.device) for k, v in d.items()}

    @torch.no_grad()
    def _rollout(self, actor, obs_rms, draws: dict) -> dict[str, torch.Tensor]:
        env = self.env
        env_state, obs = env.reset(draws["init"])
        ret_tracker = Tracker(env.num_envs, self.device)
        len_tracker = Tracker(env.num_envs, self.device)
        cur_ret = torch.zeros(env.num_envs, dtype=torch.float32, device=self.device)
        cur_len = torch.zeros_like(cur_ret)
        for t in range(env.max_episode_length):
            obs_n = obs_rms.normalize(obs) if self.cfg.algo.obs_norm else obs
            if self._needs_env_state:
                action = self.actor_apply(actor, obs_n, env_state)
            else:
                action = self.actor_apply(actor, obs_n)
            step_draw = draws["step"][t] if "step" in draws else None
            env_state, obs, reward, done, _info = env.step(env_state, action, draws["reset"][t], step_draw)
            cur_ret = cur_ret + reward
            cur_len = cur_len + 1.0
            done_mask = done > 0.5
            ret_tracker.update(cur_ret, done_mask)
            len_tracker.update(cur_len, done_mask)
            cur_ret = torch.where(done_mask, torch.zeros_like(cur_ret), cur_ret)
            cur_len = torch.where(done_mask, torch.zeros_like(cur_len), cur_len)
        return {"eval/return": ret_tracker.mean(), "eval/episode_length": len_tracker.mean()}

    def eval_policy_async(self, actor, obs_rms, gen: torch.Generator | None = None,
                          draws: dict | None = None) -> dict[str, torch.Tensor]:
        """Enqueue the rollout without waiting for the device; returns a
        handle of device tensors for ``resolve``. ``draws`` (from ``draw``)
        or ``gen`` supplies the random numbers."""
        if draws is None:
            draws = self.draw(gen)
        return self._rollout(actor, obs_rms, draws)

    @staticmethod
    def resolve(handle: dict[str, torch.Tensor]) -> dict[str, float]:
        """Floats of a handle from ``eval_policy_async`` (waits for the device)."""
        return {k: float(v) for k, v in handle.items()}

    def eval_policy(self, actor, obs_rms, gen: torch.Generator | None = None,
                    draws: dict | None = None) -> dict[str, float]:
        return self.resolve(self.eval_policy_async(actor, obs_rms, gen, draws))

    def check_if_should_stop(self, step: int | None = None) -> bool:
        """Stop on max_step if set, else on the wall-clock budget
        (reference evaluator.py:34-38)."""
        if self.cfg.max_step is not None:
            return step is not None and step > self.cfg.max_step
        return (time.time() - self.start_time) > self.cfg.max_time
