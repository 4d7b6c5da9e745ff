"""IPPO on one device: independent PPO per hand (port of pql_tpu/algos/ippo.py).

Two actor/critic pairs, one per hand, each trained by PPO on its own obs
view and reward channel (its ``detailed_reward`` terms and the shared ones,
``utils/symmetry.py``), with a value-rms each; with ``algo.same_policy``
(or a subclass's hook ``same_policy = True``, EQ's) one pair serves both
hands and takes one step on the summed losses. The joint
obs-rms is updated in the rollout and each hand's view is cut from the
normalized joint obs, as the rollout saw it. One permutation per epoch
orders both hands' minibatches. The mirrored-episode tracker routes obs,
actions and rewards in the rollout; the eval hook passes none.

The state keeps the networks in one ``nn.ModuleDict`` (``actor``,
``critic``, and ``actor_left``, ``critic_left`` unless ``same_policy``) with
an AdamW each; the rest is PPO's skeleton (``algos/ppo.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from pql_tpu_torch.algos import ma_base
from pql_tpu_torch.algos.ppo import PPO, critic_value, value_targets
from pql_tpu_torch.envs.base import VecEnvState
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.utils.trackers import EpisodeStats


@dataclass
class IPPOState:
    nets: nn.ModuleDict
    opts: dict[str, torch.optim.Optimizer]
    obs_rms: RunningMeanStd  # of the joint obs
    value_rms: RunningMeanStd
    value_rms_left: RunningMeanStd
    env_state: VecEnvState
    obs: torch.Tensor
    dones: torch.Tensor
    stats: EpisodeStats
    gen: torch.Generator
    env_steps: int
    update_count: int
    value_rms_tot: RunningMeanStd | None = None  # QTOT's total-critic stream (algos/qtot.py)


class IPPO(ma_base.NetsDictAgent, PPO):
    name = "IPPO"
    same_policy = False  # a subclass's hook (EQ: True), as cfg.algo.same_policy

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        self.ma = ma_base.MultiAgentCtx(self.env)
        if cfg.algo.same_policy:
            self.same_policy = True
        if self.same_policy and self.ma.obs_dims[0] != self.ma.obs_dims[1]:
            raise ValueError("same_policy requires equal per-hand obs dims")

    def _left(self, kind: str) -> str:
        return kind if self.same_policy else f"{kind}_left"

    def _models(self, g: torch.Generator) -> dict:
        return self._build(self._nets(g))

    def _nets(self, g: torch.Generator) -> dict:
        cfg, ma = self.cfg, self.ma
        nets = {"actor": ma.make_actor(cfg, g, 0), "critic": ma.make_critic(cfg, g, 0)}
        if not self.same_policy:
            nets.update(actor_left=ma.make_actor(cfg, g, 1), critic_left=ma.make_critic(cfg, g, 1))
        return nets

    def _state_cls(self):
        return IPPOState

    def _value_norms(self) -> dict:
        return dict(value_rms=RunningMeanStd((1,), device=self.device),
                    value_rms_left=RunningMeanStd((1,), device=self.device))

    def _action_normals(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        H, E, A = self.cfg.algo.horizon_len, self.num_envs, self.ma.action_dim
        return {"action_normal": torch.randn(H, E, A, generator=gen, device=gen.device),
                "action_normal_left": torch.randn(H, E, A, generator=gen, device=gen.device)}

    # -------------------------------------------------------------- rollout

    def _act(self, state, obs_n, draws: dict, t: int):
        nets, cfg = state.nets, self.cfg
        tracker = self.env.symmetry_tracker(state.env_state)
        ob_r, ob_l = self.ma.split_obs(obs_n, tracker)
        act_r, logp_r, _ = nets["actor"].sample(ob_r, draws["action_normal"][t])
        act_l, logp_l, _ = nets[self._left("actor")].sample(ob_l, draws["action_normal_left"][t])
        val_r = critic_value(cfg, nets["critic"], ob_r, state.value_rms)
        val_l = critic_value(cfg, nets[self._left("critic")], ob_l, state.value_rms_left)
        record = dict(obs_r=ob_r, obs_l=ob_l, act_r=act_r, act_l=act_l, logp_r=logp_r, logp_l=logp_l, val_r=val_r,
                      val_l=val_l, tracker=tracker)
        return self.ma.merge_actions(act_r, act_l, tracker), record

    def _record_step(self, state, record: dict, reward, done, info) -> None:
        """Each hand's reward from the terms, routed by the step's tracker;
        the statistics count their sum."""
        rew_r, rew_l = self.ma.split_reward(info, record.pop("tracker"))
        state.stats.update(rew_r + rew_l, done, info)
        scale = self.cfg.algo.reward_scale
        record.update(rew_r=scale * rew_r, rew_l=scale * rew_l, dones=state.dones,
                      truncated=info["truncated"].float(), **self._extra_rewards(rew_r, rew_l))

    def _extra_rewards(self, rew_r: torch.Tensor, rew_l: torch.Tensor) -> dict:
        """Further reward streams of the step from the hands' unscaled
        rewards (QTOT's total)."""
        return {}

    # ------------------------------------------------------------ advantage

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """The right hand's (obs, action, logp, adv, returns, values), then the
        left's, flat [H·E, ...]."""
        cfg, f = self.cfg, ma_base.flat
        last = self.ma.split_obs(self._normalize(state, state.obs), self.env.symmetry_tracker(state.env_state))
        data = ()
        for s, ob, critic, rms in (("r", last[0], "critic", state.value_rms),
                                   ("l", last[1], self._left("critic"), state.value_rms_left)):
            next_value = critic_value(cfg, state.nets[critic], ob, rms)
            adv, ret = ma_base.gae(traj[f"rew_{s}"], traj["dones"], traj[f"val_{s}"], traj["truncated"], next_value,
                                   state.dones, cfg.algo.gamma, cfg.algo.lambda_gae_adv, cfg.algo.use_gae)
            b_ret, b_val = value_targets(cfg, rms, ret, traj[f"val_{s}"])
            data += (f(traj[f"obs_{s}"]), f(traj[f"act_{s}"]), f(traj[f"logp_{s}"]), f(adv), b_ret, b_val)
        return data

    # --------------------------------------------------------------- update

    def _minibatch_update(self, state, batch: tuple) -> dict:
        """With ``same_policy`` one step of the actor on the summed actor
        losses, then one of the critic; else a step of each of the four
        networks on its own loss, in the order actor, critic, actor_left,
        critic_left."""
        return self._step_all(state, self._minibatch_losses(state, batch))

    def _minibatch_losses(self, state, batch: tuple) -> dict:
        nets = state.nets
        (ob_r, *rest_r), (ob_l, *rest_l) = batch[:6], batch[6:12]
        a_r, c_r = self._losses(nets["actor"], nets["critic"], ob_r, ob_r, *rest_r)
        a_l, c_l = self._losses(nets[self._left("actor")], nets[self._left("critic")], ob_l, ob_l, *rest_l)
        if self.same_policy:
            return {"actor": a_r + a_l, "critic": c_r + c_l}
        return {"actor": a_r, "critic": c_r, "actor_left": a_l, "critic_left": c_l}

    # ------------------------------------------------------------ eval hook

    def eval_actor_apply(self, nets: nn.ModuleDict, obs_n: torch.Tensor) -> torch.Tensor:
        """Each hand's policy mean on its view, merged without mirroring."""
        ob_r, ob_l = self.ma.split_obs(obs_n, None)
        return self.ma.merge_actions(nets["actor"](ob_r)[0], nets[self._left("actor")](ob_l)[0], None)
