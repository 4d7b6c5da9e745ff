"""Synchronous DDPG with n-step replay and mixed exploration noise on one
device (port of pql_tpu/algos/ddpg.py).

One iteration, as the JAX package orders it:

- explore, ``horizon_len`` steps: obs-rms update, then normalize; the
  deterministic actor plus exploration noise whose std follows the noise
  schedule at iteration ``env_steps // (horizon_len · E)`` (warm-up
  included); ``VecEnv.step`` with auto-reset; episode statistics
  (``EpisodeStats``); n-step staging; one ring-replay write. ``env_steps``
  counts total env steps (horizon · E per call), not steps per env as PQL's;
- update, ``update_times`` times: sample a batch (iid pairs) and normalize it
  (no clamp); the target from the target policy (the live actor with
  ``no_tgt_actor``, else ``actor_target``) plus clipped smoothing noise,
  evaluated on ``critic_target`` as the previous update left it (soft-updated
  after every update; PQL instead freezes a copy per critic phase); the
  critic's MSE step; the actor's DPG step against the critic as this update's
  critic step left it; then polyak of the critic target (and of the actor
  target without ``no_tgt_actor``).

Warm-up is one explore call of ``warm_up`` steps with uniform actions and
no updates. SAC and CrossQ (``algos/sac.py``, ``algos/crossq.py``) share
this skeleton and change the exploration action and the update.

Every random number of one call comes from ``draw_iteration``; ``warmup``
and ``train_iter`` take such a dict (the parity tests hand in the JAX
package's draws) or draw from the state's own ``torch.Generator``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from pql_tpu_torch.algos import base, ma_base
from pql_tpu_torch.envs import make_env
from pql_tpu_torch.envs.base import VecEnvState
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.ops.soft_update import soft_update
from pql_tpu_torch.replay import NStepState, ReplayBuffer, create_nstep, nstep_scan, replay_slots
from pql_tpu_torch.replay.buffer import draw_sample_indices
from pql_tpu_torch.utils.trackers import EpisodeStats


@dataclass
class OffPolicyState:
    actor: nn.Module
    actor_opt: torch.optim.Optimizer
    actor_target: nn.Module | None  # None with algo.no_tgt_actor: the live actor is the target policy
    critic: nn.Module
    critic_opt: torch.optim.Optimizer
    critic_target: nn.Module | None  # None for CrossQ, which has no target critic
    obs_rms: RunningMeanStd
    env_state: VecEnvState
    obs: torch.Tensor
    nstep: NStepState
    replay: ReplayBuffer
    stats: EpisodeStats
    gen: torch.Generator
    env_steps: int  # total env steps, warm-up included
    update_count: int


def check_supported(cfg) -> None:
    """Fail on options the port does not implement yet."""
    if cfg.algo.noise.type not in ("mixed", "fixed"):
        raise ValueError(f"unknown algo.noise.type {cfg.algo.noise.type!r}")


class DDPG(base.ActorCriticAgent):
    """DDPG trainer on one device."""

    name = "DDPG"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.env = make_env(cfg)
        self.num_envs = cfg.num_envs
        self.obs_dim = self.env.obs_dim
        self.action_dim = self.env.action_dim
        self.policy_dim = self.action_dim  # the action width of one policy: the update's normals
        self.update_times = int(cfg.algo.update_times)

    # ---------------------------------------------------------------- init

    def init(self, seed: int | None = None) -> OffPolicyState:
        """Fresh state. Params and the first env states are drawn on the CPU
        from ``seed``; the loop's generator lives on the device."""
        cfg, dev, E = self.cfg, self.device, self.num_envs
        seed = cfg.seed if seed is None else seed
        g_init = torch.Generator().manual_seed(seed)
        actor, critic, actor_opt, critic_opt = base.init_actor_critic(cfg, self.obs_dim, self.action_dim, g_init, dev)
        env_state, obs = self.env.reset(self.env.task.draw_reset(g_init, E).to(dev))
        replay_dtype = torch.bfloat16 if cfg.algo.replay_dtype == "bfloat16" else torch.float32
        return OffPolicyState(
            actor=actor,
            actor_opt=actor_opt,
            actor_target=None if cfg.algo.no_tgt_actor else copy.deepcopy(actor).requires_grad_(False),
            critic=critic,
            critic_opt=critic_opt,
            critic_target=copy.deepcopy(critic).requires_grad_(False),
            obs_rms=RunningMeanStd((self.obs_dim,), device=dev),
            env_state=env_state,
            obs=obs,
            nstep=create_nstep(E, self.obs_dim, self.action_dim, cfg.algo.nstep, cfg.algo.gamma, device=dev),
            replay=ReplayBuffer(replay_slots(cfg.algo.memory_size, E, cfg.algo.horizon_len), E, self.obs_dim,
                                self.action_dim, replay_dtype, valid_start=cfg.algo.nstep - 1, device=dev),
            stats=base.make_stats(cfg, self.env, dev),
            gen=torch.Generator(device=dev).manual_seed(seed),
            env_steps=0,
            update_count=0,
        )

    # --------------------------------------------------------------- draws

    def draw_iteration(self, gen: torch.Generator, random: bool = False) -> dict[str, torch.Tensor]:
        """Every random number of one call: warm-up (``random=True``) or one
        iteration. Drawn on ``gen``'s device, returned on the agent's.

        - ``action_uniform`` [H, E, A] U(-1, 1) (warm-up) or ``explore_normal``
          [H, E, A] standard normal (the exploration noise; SAC's policy sample);
        - ``reset`` [H, E, k]: the task's fresh-episode draws; ``step`` [H, E, k]
          the per-step draws of a task with ``draw_step``;
        - ``sample_slot`` / ``sample_env`` [U, B]: raw slot draws on [0, 2^30)
          and env indices of the ``update_times`` batches;
        - the update's normals, [U, B, policy_dim] each (``_update_normals``).
        """
        cfg, E = self.cfg, self.num_envs
        horizon = cfg.algo.warm_up if random else cfg.algo.horizon_len
        d = base.draw_rollout(gen, self.env.task, horizon, E, self.action_dim, random)
        if not random:
            U, B = self.update_times, cfg.algo.batch_size
            d["sample_slot"], d["sample_env"] = draw_sample_indices(gen, U, B, E)
            for name in self._update_normals:
                d[name] = torch.randn(U, B, self.policy_dim, generator=gen, device=gen.device)
        return {k: v.to(self.device) for k, v in d.items()}

    _update_normals = ("target_normal",)  # target-policy smoothing

    # ----------------------------------------------------------- public API

    def warmup(self, state: OffPolicyState, draws: dict | None = None):
        """``warm_up`` steps of uniform actions, no updates."""
        draws = self.draw_iteration(state.gen, random=True) if draws is None else draws
        return self.explore(state, draws, random=True), {}

    def train_iter(self, state: OffPolicyState, draws: dict | None = None):
        """One iteration: explore ``horizon_len`` steps, then ``update_times`` updates."""
        draws = self.draw_iteration(state.gen) if draws is None else draws
        return self.update(self.explore(state, draws), draws)

    # -------------------------------------------------------------- explore

    def explore(self, state: OffPolicyState, draws: dict, random: bool = False) -> OffPolicyState:
        """``warm_up`` steps of uniform actions (``random``) or ``horizon_len``
        exploring steps from ``draws``, n-step staging and one replay write."""
        cfg = self.cfg
        horizon = cfg.algo.warm_up if random else cfg.algo.horizon_len
        step = state.env_steps // (cfg.algo.horizon_len * self.num_envs)  # the noise schedule's iteration

        def action_fn(obs_n, t):
            if random:
                return draws["action_uniform"][t]
            return self._explore_action(state, obs_n, draws["explore_normal"][t], step)

        traj = base.rollout(self.env, cfg, state, action_fn, draws, horizon, self._rewards)
        state.nstep, emitted, _valid = nstep_scan(state.nstep, traj)
        state.replay.add(emitted)  # the valid_start watermark excludes the FIFO's fill
        state.env_steps += horizon * self.num_envs
        return state

    def _explore_action(self, state: OffPolicyState, obs_n, normal, step: int):
        return base.exploration_action(self.cfg, state.actor, obs_n, normal, step)

    _rewards = staticmethod(base.env_rewards)  # the rollout's reward channels

    # --------------------------------------------------------------- update

    def update(self, state: OffPolicyState, draws: dict):
        """``update_times`` updates on the batches of ``draws``; returns the
        state and the metrics (the mean of each network's loss, the episode
        statistics); ``_one_update`` gives the losses by network name."""
        cfg = self.cfg
        if draws["sample_slot"].shape[0] != self.update_times:
            raise ValueError(f"{draws['sample_slot'].shape[0]} batches drawn for {self.update_times} updates")
        losses: dict[str, list] = {}
        for u in range(self.update_times):
            batch = state.replay.sample(draws["sample_slot"][u], draws["sample_env"][u])
            if cfg.algo.obs_norm:
                batch["obs"] = state.obs_rms.normalize(batch["obs"])
                batch["next_obs"] = state.obs_rms.normalize(batch["next_obs"])
            for k, v in self._one_update(state, batch, {k: draws[k][u] for k in self._update_normals}).items():
                losses.setdefault(k, []).append(v)
            state.update_count += 1
        return state, {**ma_base.loss_metrics(losses), **state.stats.metrics()}

    def _td_target(self, batch: dict, q_next: torch.Tensor) -> torch.Tensor:
        gamma_n = self.cfg.algo.gamma ** self.cfg.algo.nstep
        return batch["reward"] + (1.0 - batch["done"]) * gamma_n * q_next

    def _critic_step(self, state: OffPolicyState, q1, q2, target) -> torch.Tensor:
        loss = torch.mean(torch.square(q1 - target)) + torch.mean(torch.square(q2 - target))
        return base.descend(state.critic_opt, list(state.critic.parameters()), loss, self.cfg.algo.max_grad_norm)

    def _actor_step(self, state: OffPolicyState, loss) -> torch.Tensor:
        return base.descend(state.actor_opt, list(state.actor.parameters()), loss, self.cfg.algo.max_grad_norm)

    def _one_update(self, state: OffPolicyState, batch: dict, normals: dict):
        """One critic TD step, one actor DPG step, then polyak (ddpg.py:160-214)."""
        cfg = self.cfg
        obs_n, next_obs_n = batch["obs"], batch["next_obs"]
        with torch.no_grad():
            policy = state.actor if state.actor_target is None else state.actor_target
            next_actions = base.target_policy_actions(cfg, policy, next_obs_n, normals["target_normal"])
            target = self._td_target(batch, state.critic_target.q_min(next_obs_n, next_actions))
        critic_loss = self._critic_step(state, *state.critic(obs_n, batch["action"]), target)
        # against the critic this update's step left; only the actor gets gradients
        actor_loss = self._actor_step(state, -torch.mean(state.critic.q_min(obs_n, state.actor(obs_n))))
        soft_update(state.critic_target, state.critic, cfg.algo.tau)
        if state.actor_target is not None:
            soft_update(state.actor_target, state.actor, cfg.algo.tau)
        return {"critic": critic_loss, "actor": actor_loss}

    # ------------------------------------------------------------ eval hook

    @staticmethod
    def eval_actor_apply(actor: nn.Module, obs_n: torch.Tensor) -> torch.Tensor:
        """The deterministic action for the evaluator."""
        return actor(obs_n)
