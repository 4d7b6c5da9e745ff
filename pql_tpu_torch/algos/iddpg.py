"""IDDPG on one device: independent DDPG per hand (port of pql_tpu/algos/iddpg.py).

The off-policy counterpart of IPPO. One n-step FIFO and one replay ring
store the joint transition with two reward channels, channel 0 the right
hand's reward and channel 1 the left's (``create_nstep`` /
``ReplayBuffer`` with ``reward_dim=2``); ``done`` is one column, shared.
Per hand there is an actor, a Double-Q critic and its target.

One iteration, as the JAX package orders it:

- explore, ``horizon_len`` steps: the step's symmetry tracker; obs-rms
  update, then normalize; each hand's deterministic action on its view
  (split through the tracker), merged through the tracker, then noise on
  the joint [E, 2a] action (``mixed``: the std ladder over all E envs;
  ``fixed``: ``std_max``; no decay schedule) clamped to ±1, or uniform
  actions on [-1, 1] in the warm-up; ``VecEnv.step``; each hand's reward
  from its terms (routed by the tracker), the episode statistics on their
  unscaled sum; stored rewards ``reward_scale · [rew_r, rew_l]``, dones
  through ``handle_timeout``; n-step staging and one replay write;
- update, ``update_times`` times: one batch (iid pairs), normalized; the
  stored joint obs split with no tracker (a mirrored env's obs stay in env
  layout), the stored joint action cut at ``a`` (not un-merged); then the
  right hand and then the left each take a critic step on
  ``mean((q1-y)²) + mean((q2-y)²)`` (y from the live actor's action plus
  clipped target noise, on that hand's target critic), an actor step on
  ``-mean(q_min)`` against the critic as its step left it, and polyak of
  that hand's target at ``tau``.

The JAX module's docstring explains why the actor is trained, not frozen,
in the DPG step (its reference froze the actor). The state keeps the six
networks in one ``nn.ModuleDict`` (``actor``, ``actor_left``, ``critic``,
``critic_left``, ``critic_target``, ``critic_target_left``) and an AdamW
per trained network. The rest is DDPG's skeleton (``algos/ddpg.py``): the
warm-up, the explore call, ``draw_iteration`` (each hand's target-policy
normals ``target_normal`` / ``target_normal_left`` [U, B, a]) and the
update loop.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from pql_tpu_torch.algos import base, ma_base
from pql_tpu_torch.algos.ddpg import DDPG
from pql_tpu_torch.envs.base import VecEnvState
from pql_tpu_torch.models import get_model
from pql_tpu_torch.ops.noise import add_mixed_normal_noise, add_normal_noise
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.ops.soft_update import soft_update
from pql_tpu_torch.replay import NStepState, ReplayBuffer, create_nstep, replay_slots
from pql_tpu_torch.utils.trackers import EpisodeStats

HANDS = ("", "_left")  # the right hand's network names carry no suffix


@dataclass
class IDDPGState:
    nets: nn.ModuleDict
    opts: dict[str, torch.optim.Optimizer]  # actor, actor_left, critic, critic_left
    obs_rms: RunningMeanStd  # of the joint obs
    env_state: VecEnvState
    obs: torch.Tensor
    nstep: NStepState
    replay: ReplayBuffer
    stats: EpisodeStats
    gen: torch.Generator
    env_steps: int  # total env steps, warm-up included
    update_count: int


class IDDPG(ma_base.NetsDictAgent, DDPG):
    name = "IDDPG"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        base.refuse_equivariant(cfg)
        super().__init__(cfg, device)
        self.ma = ma_base.MultiAgentCtx(self.env)
        self.policy_dim = self.ma.action_dim  # the target-policy normals are per hand, [U, B, a]

    _update_normals = ("target_normal", "target_normal_left")

    def init(self, seed: int | None = None) -> IDDPGState:
        """Fresh state. Params and the first env states are drawn on the CPU
        from ``seed``; the loop's generator lives on the device."""
        cfg, dev, E, ma = self.cfg, self.device, self.num_envs, self.ma
        seed = cfg.seed if seed is None else seed
        g = torch.Generator().manual_seed(seed)
        critic_cls, dtype = get_model(cfg.algo.cri_class), base.compute_dtype(cfg)
        nets = {f"actor{s}": ma.make_actor(cfg, g, side) for side, s in enumerate(HANDS)}
        nets.update({f"critic{s}": critic_cls(ma.obs_dims[side], ma.action_dim, gen=g, dtype=dtype)
                     for side, s in enumerate(HANDS)})
        trained = list(nets)
        for s in HANDS:
            nets[f"critic_target{s}"] = copy.deepcopy(nets[f"critic{s}"]).requires_grad_(False)
        nets = nn.ModuleDict(nets).to(dev)
        opts = {k: base.build_optimizer(nets[k], cfg.algo.actor_lr if k.startswith("actor") else cfg.algo.critic_lr)
                for k in trained}
        env_state, obs = self.env.reset(self.env.task.draw_reset(g, E).to(dev))
        replay_dtype = torch.bfloat16 if cfg.algo.replay_dtype == "bfloat16" else torch.float32
        return IDDPGState(
            nets=nets,
            opts=opts,
            obs_rms=RunningMeanStd((self.obs_dim,), device=dev),
            env_state=env_state,
            obs=obs,
            nstep=create_nstep(E, self.obs_dim, self.action_dim, cfg.algo.nstep, cfg.algo.gamma, device=dev,
                               reward_dim=2),
            replay=ReplayBuffer(replay_slots(cfg.algo.memory_size, E, cfg.algo.horizon_len), E, self.obs_dim,
                                self.action_dim, replay_dtype, valid_start=cfg.algo.nstep - 1, device=dev,
                                reward_dim=2),
            stats=base.make_stats(cfg, self.env, dev),
            gen=torch.Generator(device=dev).manual_seed(seed),
            env_steps=0,
            update_count=0,
        )

    # -------------------------------------------------------------- explore

    def _explore_action(self, state: IDDPGState, obs_n, normal, step: int):
        """Both hands' deterministic actions, split and merged through the
        step's tracker, plus noise on the joint action at ``std_max`` (no
        decay schedule; iddpg.py:131-145)."""
        noise = self.cfg.algo.noise
        tracker = self.env.symmetry_tracker(state.env_state)
        ob_r, ob_l = self.ma.split_obs(obs_n, tracker)
        action = self.ma.merge_actions(state.nets["actor"](ob_r), state.nets["actor_left"](ob_l), tracker)
        if noise.type == "mixed":
            return add_mixed_normal_noise(action, normal, noise.std_min, noise.std_max, out_bounds=(-1.0, 1.0),
                                          num_envs_global=self.num_envs)
        return add_normal_noise(action, normal, noise.std_max, out_bounds=(-1.0, 1.0))

    def _rewards(self, env_state, reward, info):
        """Each hand's reward, routed by the step's tracker: their sum for the
        statistics, [rew_r, rew_l] to store (iddpg.py:166-169)."""
        rew_r, rew_l = self.ma.split_reward(info, self.env.symmetry_tracker(env_state))
        return rew_r + rew_l, torch.stack([rew_r, rew_l], dim=-1)

    # --------------------------------------------------------------- update

    def _one_update(self, state: IDDPGState, batch: dict, normals: dict) -> dict:
        """The stored joint transition split without a tracker, its action cut
        at ``a`` (iddpg.py:253-258); then each hand's update, right first."""
        a = self.ma.action_dim
        obs = self.ma.split_obs(batch["obs"], None)
        next_obs = self.ma.split_obs(batch["next_obs"], None)
        actions = (batch["action"][:, :a], batch["action"][:, a:])
        losses = {}
        for side, s in enumerate(HANDS):
            views = (obs[side], actions[side], batch["reward"][:, side : side + 1], next_obs[side], batch["done"])
            losses[f"critic{s}"], losses[f"actor{s}"] = self._hand_update(state, s, views, normals[f"target_normal{s}"])
        return losses

    def _hand_update(self, state: IDDPGState, s: str, views: tuple, normal: torch.Tensor):
        """One hand's critic TD step, actor DPG step and polyak (iddpg.py:188-239)."""
        cfg, nets, opts, g = self.cfg, state.nets, state.opts, self.cfg.algo.max_grad_norm
        actor, critic, target = nets[f"actor{s}"], nets[f"critic{s}"], nets[f"critic_target{s}"]
        obs, action, reward, next_obs, done = views
        with torch.no_grad():
            next_act = base.target_policy_actions(cfg, actor, next_obs, normal)  # the live actor
            y = reward + (1.0 - done) * cfg.algo.gamma ** cfg.algo.nstep * target.q_min(next_obs, next_act)
        q1, q2 = critic(obs, action)
        c_loss = base.descend(opts[f"critic{s}"], list(critic.parameters()),
                              torch.mean(torch.square(q1 - y)) + torch.mean(torch.square(q2 - y)), g)
        # against the critic this step left; only the actor gets gradients
        a_loss = base.descend(opts[f"actor{s}"], list(actor.parameters()),
                              -torch.mean(critic.q_min(obs, actor(obs))), g)
        soft_update(target, critic, cfg.algo.tau)
        return c_loss, a_loss

    # ------------------------------------------------------------ eval hook

    def eval_actor_apply(self, nets: nn.ModuleDict, obs_n: torch.Tensor) -> torch.Tensor:
        """Each hand's deterministic action on its view, merged without mirroring."""
        ob_r, ob_l = self.ma.split_obs(obs_n, None)
        return self.ma.merge_actions(nets["actor"](ob_r), nets["actor_left"](ob_l), None)
