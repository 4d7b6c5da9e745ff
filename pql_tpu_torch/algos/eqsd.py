"""The team-distillation agents EQSD and EQSD2 on one device (port of
pql_tpu/algos/eqsd.py).

- EQSD (eqsd.py:36-122): IPPO's per-hand PPO plus a joint team actor on
  concat(right view, left view), trained in every minibatch, after the
  hands' losses, to imitate the executed joint action concat(right action,
  left action). The team actor is one of four (eqsd.py:44-70): with
  ``algo.diffusion`` a diffusion policy on the clipped joint action, its
  loss the ε-MSE ``get_loss`` (an ``EquivariantDiffusionPolicy`` with an
  ``Equivariant`` act_class on a task with an ``EquivarianceSpec``, else a
  ``StateDiffusionPolicy``); without it a Gaussian actor (equivariant or
  not, as ``teams.joint_gaussian_actor``), its loss −mean log π_team. The
  diffusion loss's draws are part of the iteration's: ``team_noise``
  [update_times, n_mb, mb, 2a] and ``team_t`` [update_times, n_mb, mb]
  (int64 in [0, diffusion_iter)), one pair per minibatch in order (the JAX
  agent splits them off ``state.rng`` once per minibatch). The eval hook is
  IPPO's: the per-hand actors.
- EQSD2 (eqsd.py:125-395): a split population on the team agents'
  skeleton (``teams._SplitPopBase``): envs [0, E/2) run the per-hand actors,
  envs [E/2, E) a joint Gaussian team actor on concat(ob_r, ob_l), the views
  split through the tracker, its two action halves executed as they are.
  The rollout records, without gradient, the team actor's log-prob
  ``lp_is`` of the individual half's joint action on that half's joint
  views. Three GAE streams (each hand's on the first half, the team's on
  the total reward of the second) on the critics' raw values: the value-rms
  pair is present and never moved. The team critic is central: equivariant
  (``make_critic(central=True)``) with the equivariant team, else
  ``cri_class`` on the joint view. The team actor's loss is its clipped
  surrogate plus ``kl_weight`` · mean(lp_is − lp_joint), lp_joint its
  log-prob of the same actions now; ``kl_weight`` is
  ``LinearSchedule(kl_max, 0, kl_decay_iters)`` read once per iteration
  at the iteration's first ``update_count``, which grows by one per
  minibatch. A minibatch steps actor, critic, actor_left, critic_left,
  actor_team, critic_team. The eval hook is the team actor's mean on the
  views split without a tracker.

Both keep an ``IPPOState`` whose ``nets`` hold ``actor_team`` (EQSD2 also
``critic_team``) beside the hands' networks, each with its AdamW.
"""

from __future__ import annotations

import torch
from torch import nn

from pql_tpu_torch.algos import base, ma_base, teams
from pql_tpu_torch.algos.ippo import IPPO
from pql_tpu_torch.models import get_model
from pql_tpu_torch.models.diffusion import StateDiffusionPolicy
from pql_tpu_torch.models.ediffusion import EquivariantDiffusionPolicy
from pql_tpu_torch.models.emlp import concat_reps
from pql_tpu_torch.ops.schedules import LinearSchedule


def _joint(ob_r: torch.Tensor, ob_l: torch.Tensor) -> torch.Tensor:
    return torch.cat([ob_r, ob_l], dim=-1)


def _value(nets: nn.ModuleDict, name: str, obs: torch.Tensor) -> torch.Tensor:
    return nets[name](obs)[..., 0]


class EQSD(IPPO):
    name = "EQSD"

    def _nets(self, g: torch.Generator) -> dict:
        return {**super()._nets(g), "actor_team": self._team_actor(g)}

    def _team_actor(self, g: torch.Generator):
        cfg, ma = self.cfg, self.ma
        joint_obs = sum(ma.obs_dims)
        if not cfg.algo.diffusion:
            return teams.joint_gaussian_actor(cfg, ma, g, joint_obs)
        dtype = base.compute_dtype(cfg)
        if teams.equivariant_team(cfg, ma):
            return EquivariantDiffusionPolicy(ma.joint_obs_gen(), concat_reps(ma.act_gen(), ma.act_gen()),
                                              cfg.algo.diffusion_iter, gen=g, dtype=dtype)
        return StateDiffusionPolicy(joint_obs, 2 * ma.action_dim, cfg.algo.diffusion_iter, gen=g, dtype=dtype)

    def draw_iteration(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        """IPPO's draws; with ``algo.diffusion`` also the team loss's
        ``team_noise`` and ``team_t``, one minibatch's per [epoch, minibatch]."""
        d = super().draw_iteration(gen)
        algo = self.cfg.algo
        if algo.diffusion:
            shape = (algo.update_times, self.rows // algo.batch_size, algo.batch_size)
            d["team_noise"] = torch.randn(*shape, 2 * self.ma.action_dim, generator=gen,
                                          device=gen.device).to(self.device)
            d["team_t"] = torch.randint(0, algo.diffusion_iter, shape, generator=gen, device=gen.device).to(self.device)
        return d

    def _minibatch_extra(self, draws: dict, first_update: int, epoch: int, index: int) -> tuple:
        if not self.cfg.algo.diffusion:
            return ()
        return draws["team_noise"][epoch, index], draws["team_t"][epoch, index]

    def _minibatch_losses(self, state, batch: tuple) -> dict:
        """IPPO's losses, then the team actor's imitation of the joint action."""
        losses = super()._minibatch_losses(state, batch)
        team = state.nets["actor_team"]
        obs, act = _joint(batch[0], batch[6]), _joint(batch[1], batch[7])
        if self.cfg.algo.diffusion:
            noise, timesteps = batch[12:]
            losses["actor_team"] = team.get_loss(obs, torch.clamp(act, -1.0, 1.0), noise, timesteps)
        else:
            losses["actor_team"] = -torch.mean(team.logprob_entropy(obs, act)[0])
        return losses


class EQSD2(teams._SplitPopBase):
    name = "EQSD2"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        self.kl_schedule = LinearSchedule(cfg.algo.kl_max, 0.0, cfg.algo.kl_decay_iters)

    def _models(self, g: torch.Generator) -> dict:
        cfg, ma = self.cfg, self.ma
        joint_obs = sum(ma.obs_dims)
        if teams.equivariant_team(cfg, ma):
            critic_team = ma.make_critic(cfg, g, central=True)
        else:
            critic_team = get_model(cfg.algo.cri_class)(joint_obs, gen=g, dtype=base.compute_dtype(cfg))
        return self._build({"actor": ma.make_actor(cfg, g, 0), "actor_left": ma.make_actor(cfg, g, 1),
                            "critic": ma.make_critic(cfg, g, 0), "critic_left": ma.make_critic(cfg, g, 1),
                            "actor_team": teams.joint_gaussian_actor(cfg, ma, g, joint_obs),
                            "critic_team": critic_team})

    def _action_normals(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        H, h, a = self.cfg.algo.horizon_len, self.half, self.ma.action_dim
        return {"action_normal": torch.randn(H, h, a, generator=gen, device=gen.device),
                "action_normal_left": torch.randn(H, h, a, generator=gen, device=gen.device),
                "action_normal_team": torch.randn(H, h, 2 * a, generator=gen, device=gen.device)}

    def _act(self, state, obs_n, draws: dict, t: int):
        nets, h = state.nets, self.half
        tracker = self.env.symmetry_tracker(state.env_state)
        ob_r, ob_l = self.ma.split_obs(obs_n, tracker)
        ob_team = _joint(ob_r, ob_l)
        a_r, lp_r, _ = nets["actor"].sample(ob_r[:h], draws["action_normal"][t])
        a_l, lp_l, _ = nets["actor_left"].sample(ob_l[:h], draws["action_normal_left"][t])
        a_team, lp_team, _ = nets["actor_team"].sample(ob_team[h:], draws["action_normal_team"][t])
        act_ind = _joint(a_r, a_l)
        record = dict(
            obs_r=ob_r[:h], obs_l=ob_l[:h], obs_team=ob_team[h:], obs_is=ob_team[:h], a_r=a_r, a_l=a_l,
            a_team=a_team, act_ind=act_ind, lp_r=lp_r, lp_l=lp_l, lp_team=lp_team,
            # the team actor's log-prob of the individual joint action (eqsd.py:228-231)
            lp_is=nets["actor_team"].logprob_entropy(ob_team[:h], act_ind)[0],
            v_r=_value(nets, "critic", ob_r[:h]), v_l=_value(nets, "critic_left", ob_l[:h]),
            v_team=_value(nets, "critic_team", ob_team[h:]), tracker=tracker,
        )
        # the individual actions merged without the tracker, the team's as drawn (eqsd.py:238-240)
        return torch.cat([self.ma.merge_actions(a_r, a_l, None), a_team]), record

    def _record_step(self, state, record: dict, reward, done, info) -> None:
        h, rs = self.half, self.cfg.algo.reward_scale
        rew_r, rew_l = self.ma.split_reward(info, record.pop("tracker"))
        state.stats.update(rew_r + rew_l, done, info)
        trunc = info["truncated"].float()
        record.update(dones_ind=state.dones[:h], dones_team=state.dones[h:], rew_r=rs * rew_r[:h],
                      rew_l=rs * rew_l[:h], rew_team=rs * (rew_r + rew_l)[h:], trunc_ind=trunc[:h],
                      trunc_team=trunc[h:])

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """Right, left, team: (obs, action, logp, adv, returns, values); then
        the individual half's joint views, joint actions and ``lp_is``; flat
        [H·E/2, ...]."""
        nets, h, f = state.nets, self.half, ma_base.flat
        _, (ob_r, ob_l) = self._final_views(state)
        ind = (traj["dones_ind"], traj["trunc_ind"], state.dones[:h])
        team = (traj["dones_team"], traj["trunc_team"], state.dones[h:])
        data = ()
        for key, critic, obs, (dones, trunc, next_done) in (
                ("r", "critic", ob_r[:h], ind), ("l", "critic_left", ob_l[:h], ind),
                ("team", "critic_team", _joint(ob_r, ob_l)[h:], team)):
            adv, ret = self._gae(traj[f"rew_{key}"], dones, traj[f"v_{key}"], trunc, _value(nets, critic, obs),
                                 next_done)
            data += (f(traj[f"obs_{key}"]), f(traj[f"a_{key}"]), f(traj[f"lp_{key}"]), f(adv), f(ret),
                     f(traj[f"v_{key}"]))
        return data + (f(traj["obs_is"]), f(traj["act_ind"]), f(traj["lp_is"]))

    def _minibatch_extra(self, draws: dict, first_update: int, epoch: int, index: int) -> tuple:
        """The KL weight, read once per iteration (eqsd.py:299)."""
        return (self.kl_schedule(first_update),)

    def _minibatch_update(self, state, batch: tuple) -> dict:
        nets = state.nets
        b_r, b_l, b_team = batch[0:6], batch[6:12], batch[12:18]
        obs_is, act_is, lp_is, kl_weight = batch[18:]
        losses = {}
        for sfx, b in (("", b_r), ("_left", b_l)):
            losses[f"actor{sfx}"] = self._actor_loss(nets[f"actor{sfx}"], *b[:4])[0]
            losses[f"critic{sfx}"] = self._value_loss(nets[f"critic{sfx}"], b[0], b[4], b[5])
        # PPO + the scheduled log-ratio on the individual half (eqsd.py:341-353); lp_is has no gradient
        lp_joint, _ = nets["actor_team"].logprob_entropy(obs_is, act_is)
        losses["actor_team"] = (self._actor_loss(nets["actor_team"], *b_team[:4])[0]
                                + kl_weight * torch.mean(lp_is - lp_joint))
        losses["critic_team"] = self._value_loss(nets["critic_team"], b_team[0], b_team[4], b_team[5])
        return self._step_all(state, losses)

    def eval_actor_apply(self, nets: nn.ModuleDict, obs_n: torch.Tensor) -> torch.Tensor:
        """The team actor's mean on the joint views split without a tracker,
        its halves merged without mirroring."""
        ob_r, ob_l = self.ma.split_obs(obs_n, None)
        mean = nets["actor_team"](_joint(ob_r, ob_l))[0]
        a = self.ma.action_dim
        return self.ma.merge_actions(mean[:, :a], mean[:, a:], None)
