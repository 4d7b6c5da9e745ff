"""MAPPO on one device: one actor for both hands, a central critic (port of
pql_tpu/algos/mappo.py).

The actor is applied to the per-hand obs views stacked as 2E agent rows
(right half, then left half); the critic sees the joint obs, repeated for
both rows. Both agent rows get the env's whole reward and done flags, so
their advantages differ only through their obs. An epoch permutes the
2·H·E rows, in minibatches of ``batch_size`` (a remainder is dropped). The
stored agent and joint obs are normalized as the rollout saw them. The
state is a ``PPOState``; the rest is PPO's (``algos/ppo.py``).
"""

from __future__ import annotations

import torch

from pql_tpu_torch.algos import base, ma_base
from pql_tpu_torch.algos.ppo import PPO, critic_value, value_targets


def _rep(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x], 0)


class MAPPO(PPO):
    name = "MAPPO"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        base.refuse_equivariant(cfg)
        super().__init__(cfg, device)
        self.ma = ma_base.MultiAgentCtx(self.env)
        if self.ma.obs_dims[0] != self.ma.obs_dims[1]:
            raise ValueError("MAPPO's shared actor requires equal per-hand obs dims")

    def _check_batches(self) -> None:
        pass  # epoch_minibatches drops the remainder

    @property
    def rows(self) -> int:
        return 2 * self.cfg.algo.horizon_len * self.num_envs

    def _models(self, g: torch.Generator) -> dict:
        actor = self.ma.make_actor(self.cfg, g).to(self.device)
        critic = self.ma.make_critic(self.cfg, g, central=True).to(self.device)
        return dict(actor=actor, actor_opt=base.build_optimizer(actor, self.cfg.algo.actor_lr),
                    critic=critic, critic_opt=base.build_optimizer(critic, self.cfg.algo.critic_lr))

    def _action_normals(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        H, E, A = self.cfg.algo.horizon_len, self.num_envs, self.ma.action_dim
        return {"action_normal": torch.randn(H, 2 * E, A, generator=gen, device=gen.device)}

    def _act(self, state, obs_n, draws: dict, t: int):
        tracker = self.env.symmetry_tracker(state.env_state)
        agent_obs = torch.cat(self.ma.split_obs(obs_n, tracker), 0)  # [2E, d]
        shared_obs = _rep(obs_n)  # [2E, D]
        action, logp, _ = state.actor.sample(agent_obs, draws["action_normal"][t])
        value = critic_value(self.cfg, state.critic, shared_obs, state.value_rms)
        E = self.num_envs
        execute = self.ma.merge_actions(action[:E], action[E:], tracker)
        return execute, dict(obs=agent_obs, shared_obs=shared_obs, action=action, logp=logp, value=value)

    def _record_step(self, state, record: dict, reward, done, info) -> None:
        state.stats.update(reward, done, info)
        record.update(reward=_rep(self.cfg.algo.reward_scale * reward), dones=_rep(state.dones),
                      truncated=_rep(info["truncated"].float()))

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """(agent obs, joint obs, action, logp, adv, returns, values), flat [2·H·E, ...]."""
        cfg, f = self.cfg, ma_base.flat
        next_value = critic_value(cfg, state.critic, _rep(self._normalize(state, state.obs)), state.value_rms)
        adv, ret = ma_base.gae(traj["reward"], traj["dones"], traj["value"], traj["truncated"], next_value,
                               _rep(state.dones), cfg.algo.gamma, cfg.algo.lambda_gae_adv, cfg.algo.use_gae)
        b_ret, b_val = value_targets(cfg, state.value_rms, ret, traj["value"])
        return (f(traj["obs"]), f(traj["shared_obs"]), f(traj["action"]), f(traj["logp"]), f(adv), b_ret, b_val)

    def _minibatch_update(self, state, batch: tuple) -> dict:
        return self._step_actor_critic(state, *self._losses(state.actor, state.critic, *batch))

    def eval_actor_apply(self, actor, obs_n: torch.Tensor) -> torch.Tensor:
        """The shared policy's mean on each hand's view, merged without mirroring."""
        ob_r, ob_l = self.ma.split_obs(obs_n, None)
        return self.ma.merge_actions(actor(ob_r)[0], actor(ob_l)[0], None)
