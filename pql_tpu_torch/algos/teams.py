"""The split-population team agents on one device: IART, IPPOTeam and
IPPOTeam2 (port of pql_tpu/algos/teams.py).

Each trains two populations in one vectorized env batch: envs [0, E/2) run
the individual per-hand policies, envs [E/2, E) the team policies (an odd
``num_envs`` is refused). ``value_norm`` is ignored: no value-rms is read
or moved, and the critics' raw outputs are the values. One permutation of
the H·E/2 training rows per epoch orders every stream's minibatches (a
remainder is dropped).

- IART (teams.py:95-341): a second pair of per-hand actors and critics
  drives the team half on the total reward ``reward_scale · (rew_r +
  rew_l)``. Six GAE streams: each hand's own, each team hand's, and the
  individual critics on the team half's own rewards. Each individual actor
  adds an importance-weighted clipped term on the team half's actions: the
  ratio against the team actor as the minibatch found it (no gradient), the
  clip range μ·(1 ± ε) with μ = exp(logπ_ind,rollout − logπ_team). A
  minibatch steps actor, actor_left, actor_team, actor_left_team, critic,
  critic_left, critic_team, critic_left_team.
- IPPOTeam (teams.py:344-555): the team half runs one joint Gaussian actor
  on the whole joint obs (action dim 2a) with a central ``critic_team``; a
  central ``critic_tot`` values the individual half on the total reward.
  The individual actors sample on all E envs (obs split through the
  tracker, their actions merged without it), and only the first half's
  actions run; GAE runs over all envs and the first half trains. Each hand's
  actor adds a clipped term on the whitened total advantage; the team actor
  adds an imitation of the individual joint action where ``critic_tot ≥
  critic_team`` (values of the minibatch's critics before their steps). A
  minibatch steps actor, actor_left, actor_team, critic, critic_left,
  critic_tot, critic_team.
- IPPOTeam2: IPPOTeam with the individual streams on the first half alone.

The state is an ``IPPOState`` whose ``nets`` hold the agent's networks; the
rest is PPO's skeleton (``algos/ppo.py``). With an ``Equivariant``
``act_class`` / ``cri_class`` the per-hand and central networks come
equivariant from ``ma_base.MultiAgentCtx`` and IPPOTeam's team actor is a
``DiagGaussianEquivariantMLPPolicy`` on the joint reps.
"""

from __future__ import annotations

import torch
from torch import nn

from pql_tpu_torch.algos import base, ma_base
from pql_tpu_torch.algos.ippo import IPPOState
from pql_tpu_torch.algos.ppo import PPO
from pql_tpu_torch.models import get_model
from pql_tpu_torch.models.emlp import concat_reps
from pql_tpu_torch.ops.running_norm import RunningMeanStd


class _SplitPopBase(ma_base.NetsDictAgent, PPO):
    def __init__(self, cfg, device: str | torch.device = "cuda"):
        if cfg.num_envs % 2:
            raise ValueError(f"{self.name} needs an even num_envs")
        super().__init__(cfg, device)
        self.ma = ma_base.MultiAgentCtx(self.env)
        self.half = self.num_envs // 2

    def _check_batches(self) -> None:
        pass  # epoch_minibatches drops the remainder

    @property
    def rows(self) -> int:
        return self.cfg.algo.horizon_len * self.num_envs // 2

    def _state_cls(self):
        return IPPOState

    def _value_norms(self) -> dict:
        """Present as in the JAX state, never moved."""
        return dict(value_rms=RunningMeanStd((1,), device=self.device),
                    value_rms_left=RunningMeanStd((1,), device=self.device))

    def _actor_loss(self, actor, obs, actions, logp_old, adv):
        """The clipped surrogate on the whitened advantage, and the new log-probs."""
        logp_new, entropy = actor.logprob_entropy(obs, actions)
        cfg = self.cfg
        return ma_base.ppo_actor_loss(logp_new, logp_old, ma_base.normalize_advantages(adv), entropy,
                                      cfg.algo.ratio_clip, cfg.algo.lambda_entropy), logp_new, entropy

    def _value_loss(self, critic, obs, returns, v_old):
        cfg = self.cfg
        return ma_base.ppo_value_loss(critic(obs)[..., 0], returns, v_old, cfg.algo.ratio_clip, cfg.algo.value_clip)

    def _gae(self, rew, dones, val, trunc, next_value, next_done):
        cfg = self.cfg
        return ma_base.gae(rew, dones, val, trunc, next_value, next_done, cfg.algo.gamma, cfg.algo.lambda_gae_adv,
                           cfg.algo.use_gae)

    def _final_views(self, state):
        """The normalized last obs and its split through the last tracker."""
        obs_n = self._normalize(state, state.obs)
        return obs_n, self.ma.split_obs(obs_n, self.env.symmetry_tracker(state.env_state))


def equivariant_team(cfg, ma: ma_base.MultiAgentCtx) -> bool:
    """A joint team network is equivariant with an ``Equivariant`` act_class
    on a task with an ``EquivarianceSpec``."""
    return "Equivariant" in cfg.algo.act_class and ma.eq is not None


def joint_gaussian_actor(cfg, ma: ma_base.MultiAgentCtx, gen: torch.Generator, obs_dim: int):
    """A Gaussian actor on a joint obs of ``obs_dim`` with action dim 2a:
    equivariant on joint_obs_gen → act_gen ⊕ act_gen when
    ``equivariant_team``, else ``DiagGaussianMLPPolicy``."""
    dtype = base.compute_dtype(cfg)
    if equivariant_team(cfg, ma):
        return get_model("DiagGaussianEquivariantMLPPolicy")(
            gen_in=ma.joint_obs_gen(), gen_out=concat_reps(ma.act_gen(), ma.act_gen()), gen=gen, dtype=dtype)
    return get_model("DiagGaussianMLPPolicy")(obs_dim, 2 * ma.action_dim, gen=gen, dtype=dtype)


def _value(nets: nn.ModuleDict, name: str, obs: torch.Tensor) -> torch.Tensor:
    return nets[name](obs)[..., 0]


class IART(_SplitPopBase):
    name = "IART"

    def _models(self, g: torch.Generator) -> dict:
        cfg, ma = self.cfg, self.ma
        nets = {}
        for sfx in ("", "_team"):
            nets.update({f"actor{sfx}": ma.make_actor(cfg, g, 0), f"actor_left{sfx}": ma.make_actor(cfg, g, 1),
                         f"critic{sfx}": ma.make_critic(cfg, g, 0), f"critic_left{sfx}": ma.make_critic(cfg, g, 1)})
        return self._build(nets)

    def _action_normals(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        H, h, a = self.cfg.algo.horizon_len, self.half, self.ma.action_dim
        return {f"action_normal{s}": torch.randn(H, h, a, generator=gen, device=gen.device)
                for s in ("", "_left", "_team", "_left_team")}

    def _act(self, state, obs_n, draws: dict, t: int):
        nets, h = state.nets, self.half
        tracker = self.env.symmetry_tracker(state.env_state)
        ob_r, ob_l = self.ma.split_obs(obs_n, tracker)
        a_r, lp_r, _ = nets["actor"].sample(ob_r[:h], draws["action_normal"][t])
        a_l, lp_l, _ = nets["actor_left"].sample(ob_l[:h], draws["action_normal_left"][t])
        a_rt, lp_rt, _ = nets["actor_team"].sample(ob_r[h:], draws["action_normal_team"][t])
        a_lt, lp_lt, _ = nets["actor_left_team"].sample(ob_l[h:], draws["action_normal_left_team"][t])
        record = dict(
            obs_r=ob_r[:h], obs_l=ob_l[:h], obs_rt=ob_r[h:], obs_lt=ob_l[h:], a_r=a_r, a_l=a_l, a_rt=a_rt, a_lt=a_lt,
            lp_r=lp_r, lp_l=lp_l, lp_rt=lp_rt, lp_lt=lp_lt,
            # the individual actors' log-probs of the team actions (teams.py:181-189)
            lp_rt_side=nets["actor"].logprob_entropy(ob_r[h:], a_rt)[0],
            lp_lt_side=nets["actor_left"].logprob_entropy(ob_l[h:], a_lt)[0],
            v_r=_value(nets, "critic", ob_r[:h]), v_l=_value(nets, "critic_left", ob_l[:h]),
            v_rt=_value(nets, "critic_team", ob_r[h:]), v_lt=_value(nets, "critic_left_team", ob_l[h:]),
            v_rt_side=_value(nets, "critic", ob_r[h:]), v_lt_side=_value(nets, "critic_left", ob_l[h:]),
            tracker=tracker,
        )
        return self.ma.merge_actions(torch.cat([a_r, a_rt]), torch.cat([a_l, a_lt]), tracker), record

    def _record_step(self, state, record: dict, reward, done, info) -> None:
        h, rs = self.half, self.cfg.algo.reward_scale
        rew_r, rew_l = self.ma.split_reward(info, record.pop("tracker"))
        state.stats.update(rew_r + rew_l, done, info)
        trunc = info["truncated"].float()
        record.update(dones_ind=state.dones[:h], dones_team=state.dones[h:], rew_r=rs * rew_r[:h],
                      rew_l=rs * rew_l[:h], rew_rt_side=rs * rew_r[h:], rew_lt_side=rs * rew_l[h:],
                      rew_team=rs * (rew_r + rew_l)[h:], trunc_ind=trunc[:h], trunc_team=trunc[h:])

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """Per hand, then per team hand: (obs, action, logp, adv, returns,
        values); then the team half's individual log-probs and advantages,
        right and left; flat [H·E/2, ...]."""
        nets, h, f = state.nets, self.half, ma_base.flat
        _, (ob_r, ob_l) = self._final_views(state)
        ind = (traj["dones_ind"], traj["trunc_ind"], state.dones[:h])
        team = (traj["dones_team"], traj["trunc_team"], state.dones[h:])
        streams = {}
        for key, critic, obs, rew, (dones, trunc, nd) in (
                ("r", "critic", ob_r[:h], traj["rew_r"], ind), ("l", "critic_left", ob_l[:h], traj["rew_l"], ind),
                ("rt", "critic_team", ob_r[h:], traj["rew_team"], team),
                ("lt", "critic_left_team", ob_l[h:], traj["rew_team"], team),
                ("rt_side", "critic", ob_r[h:], traj["rew_rt_side"], team),
                ("lt_side", "critic_left", ob_l[h:], traj["rew_lt_side"], team)):
            streams[key] = self._gae(rew, dones, traj[f"v_{key}"], trunc, _value(nets, critic, obs), nd)
        data = ()
        for k in ("r", "l", "rt", "lt"):
            adv, ret = streams[k]
            data += (f(traj[f"obs_{k}"]), f(traj[f"a_{k}"]), f(traj[f"lp_{k}"]), f(adv), f(ret), f(traj[f"v_{k}"]))
        return data + (f(traj["lp_rt_side"]), f(streams["rt_side"][0]), f(traj["lp_lt_side"]), f(streams["lt_side"][0]))

    def _iw_actor_loss(self, actor, team_actor, own: tuple, team: tuple, lp_side, adv_side):
        """The hand's clipped surrogate plus the importance-weighted term on
        the team half's data (teams.py:255-277)."""
        clip = self.cfg.algo.ratio_clip
        loss = self._actor_loss(actor, *own)[0]
        obs2, act2 = team[:2]
        lp_off, _ = actor.logprob_entropy(obs2, act2)
        with torch.no_grad():  # the team actor as the minibatch found it
            lp_team, _ = team_actor.logprob_entropy(obs2, act2)
        ratio = torch.exp(lp_off - lp_team)
        miu = torch.exp(lp_side - lp_team)
        adv = ma_base.normalize_advantages(adv_side)
        l1 = -adv * ratio
        l2 = -adv * torch.clamp(ratio, miu * (1 - clip), miu * (1 + clip))
        return loss + torch.mean(torch.maximum(l1, l2))

    def _minibatch_update(self, state, batch: tuple) -> dict:
        nets = state.nets
        b_r, b_l, b_rt, b_lt = batch[0:6], batch[6:12], batch[12:18], batch[18:24]
        lp_rts, ad_rts, lp_lts, ad_lts = batch[24:]
        losses = {
            "actor": self._iw_actor_loss(nets["actor"], nets["actor_team"], b_r[:4], b_rt, lp_rts, ad_rts),
            "actor_left": self._iw_actor_loss(nets["actor_left"], nets["actor_left_team"], b_l[:4], b_lt, lp_lts,
                                              ad_lts),
            "actor_team": self._actor_loss(nets["actor_team"], *b_rt[:4])[0],
            "actor_left_team": self._actor_loss(nets["actor_left_team"], *b_lt[:4])[0],
        }
        for name, b in (("critic", b_r), ("critic_left", b_l), ("critic_team", b_rt), ("critic_left_team", b_lt)):
            losses[name] = self._value_loss(nets[name], b[0], b[4], b[5])
        return self._step_all(state, losses)

    def eval_actor_apply(self, nets: nn.ModuleDict, obs_n: torch.Tensor) -> torch.Tensor:
        """The individual actors' means on their views, merged without mirroring."""
        ob_r, ob_l = self.ma.split_obs(obs_n, None)
        return self.ma.merge_actions(nets["actor"](ob_r)[0], nets["actor_left"](ob_l)[0], None)


class IPPOTeam(_SplitPopBase):
    name = "IPPOTeam"
    ind_streams_full = True  # the individual streams over all envs (IPPOTeam2: the first half)

    def _ind(self) -> slice:
        return slice(None) if self.ind_streams_full else slice(0, self.half)

    def _models(self, g: torch.Generator) -> dict:
        cfg, ma = self.cfg, self.ma
        nets = {"actor": ma.make_actor(cfg, g, 0), "actor_left": ma.make_actor(cfg, g, 1),
                "critic": ma.make_critic(cfg, g, 0), "critic_left": ma.make_critic(cfg, g, 1),
                "actor_team": joint_gaussian_actor(cfg, ma, g, self.obs_dim),  # on the whole obs (teams.py:354-360)
                "critic_tot": ma.make_critic(cfg, g, central=True), "critic_team": ma.make_critic(cfg, g, central=True)}
        return self._build(nets)

    def _action_normals(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        H, a = self.cfg.algo.horizon_len, self.ma.action_dim
        n_ind = self.num_envs if self.ind_streams_full else self.half
        return {"action_normal": torch.randn(H, n_ind, a, generator=gen, device=gen.device),
                "action_normal_left": torch.randn(H, n_ind, a, generator=gen, device=gen.device),
                "action_normal_team": torch.randn(H, self.half, 2 * a, generator=gen, device=gen.device)}

    def _act(self, state, obs_n, draws: dict, t: int):
        nets, h, sl = state.nets, self.half, self._ind()
        tracker = self.env.symmetry_tracker(state.env_state)
        ob_r, ob_l = self.ma.split_obs(obs_n, tracker)
        a_r, lp_r, _ = nets["actor"].sample(ob_r[sl], draws["action_normal"][t])
        a_l, lp_l, _ = nets["actor_left"].sample(ob_l[sl], draws["action_normal_left"][t])
        a_team, lp_team, _ = nets["actor_team"].sample(obs_n[h:], draws["action_normal_team"][t])
        act_ind = self.ma.merge_actions(a_r, a_l, None)  # split with the tracker, merged without (teams.py:396)
        record = dict(
            obs_r=ob_r[sl], obs_l=ob_l[sl], obs_tot=obs_n[sl], obs_team=obs_n[h:], a_r=a_r, a_l=a_l,
            act_ind=act_ind, a_team=a_team, lp_r=lp_r, lp_l=lp_l, lp_team=lp_team,
            v_r=_value(nets, "critic", ob_r[sl]), v_l=_value(nets, "critic_left", ob_l[sl]),
            v_tot=_value(nets, "critic_tot", obs_n[sl]), v_team=_value(nets, "critic_team", obs_n[h:]),
            tracker=tracker,
        )
        return torch.cat([act_ind[:h], a_team]), record

    def _record_step(self, state, record: dict, reward, done, info) -> None:
        h, sl, rs = self.half, self._ind(), self.cfg.algo.reward_scale
        rew_r, rew_l = self.ma.split_reward(info, record.pop("tracker"))
        state.stats.update(rew_r + rew_l, done, info)
        rew_tot, trunc = rs * (rew_r + rew_l), info["truncated"].float()
        record.update(dones_ind=state.dones[sl], dones_team=state.dones[h:], rew_r=rs * rew_r[sl],
                      rew_l=rs * rew_l[sl], rew_tot=rew_tot[sl], rew_team=rew_tot[h:], trunc_ind=trunc[sl],
                      trunc_team=trunc[h:])

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """Right, left: (obs, action, logp, adv, returns, values); total:
        (obs, individual joint action, adv, returns, values); team: (obs,
        action, logp, adv, returns, values); flat [H·E/2, ...]. GAE of the
        individual streams runs over their envs; the first half trains."""
        nets, h, sl = state.nets, self.half, self._ind()
        obs_n, (ob_r, ob_l) = self._final_views(state)
        ind = (traj["dones_ind"], traj["trunc_ind"], state.dones[sl])
        adv_r, ret_r = self._gae(traj["rew_r"], ind[0], traj["v_r"], ind[1], _value(nets, "critic", ob_r[sl]), ind[2])
        adv_l, ret_l = self._gae(traj["rew_l"], ind[0], traj["v_l"], ind[1], _value(nets, "critic_left", ob_l[sl]),
                                 ind[2])
        adv_tot, ret_tot = self._gae(traj["rew_tot"], ind[0], traj["v_tot"], ind[1],
                                     _value(nets, "critic_tot", obs_n[sl]), ind[2])
        adv_team, ret_team = self._gae(traj["rew_team"], traj["dones_team"], traj["v_team"], traj["trunc_team"],
                                       _value(nets, "critic_team", obs_n[h:]), state.dones[h:])
        f = (lambda x: ma_base.flat(x[:, :h])) if self.ind_streams_full else ma_base.flat
        ft = ma_base.flat
        return (
            f(traj["obs_r"]), f(traj["a_r"]), f(traj["lp_r"]), f(adv_r), f(ret_r), f(traj["v_r"]),
            f(traj["obs_l"]), f(traj["a_l"]), f(traj["lp_l"]), f(adv_l), f(ret_l), f(traj["v_l"]),
            f(traj["obs_tot"]), f(traj["act_ind"]), f(adv_tot), f(ret_tot), f(traj["v_tot"]),
            ft(traj["obs_team"]), ft(traj["a_team"]), ft(traj["lp_team"]), ft(adv_team), ft(ret_team),
            ft(traj["v_team"]),
        )

    def _minibatch_update(self, state, batch: tuple) -> dict:
        nets, cfg = state.nets, self.cfg
        b_r, b_l = batch[0:6], batch[6:12]
        o_tot, a_tot, ad_tot, rt_tot, v_tot = batch[12:17]
        b_team = batch[17:23]
        ad_totn = ma_base.normalize_advantages(ad_tot)
        losses = {}
        for name, b in (("actor", b_r), ("actor_left", b_l)):  # own term + total term (teams.py:488-504)
            own, logp_new, entropy = self._actor_loss(nets[name], *b[:4])
            losses[name] = own + ma_base.ppo_actor_loss(logp_new, b[2], ad_totn, torch.zeros_like(entropy),
                                                        cfg.algo.ratio_clip, 0.0)
        with torch.no_grad():  # the gate of the team actor's imitation (teams.py:506-510)
            mask = (_value(nets, "critic_tot", o_tot) - _value(nets, "critic_team", b_team[0]) >= 0.0).float()
        ppo = self._actor_loss(nets["actor_team"], *b_team[:4])[0]
        lp_ind, _ = nets["actor_team"].logprob_entropy(o_tot, a_tot)
        losses["actor_team"] = ppo - torch.mean(lp_ind * mask)
        for name, (obs, ret, v) in (("critic", (b_r[0], b_r[4], b_r[5])), ("critic_left", (b_l[0], b_l[4], b_l[5])),
                                    ("critic_tot", (o_tot, rt_tot, v_tot)),
                                    ("critic_team", (b_team[0], b_team[4], b_team[5]))):
            losses[name] = self._value_loss(nets[name], obs, ret, v)
        return self._step_all(state, losses)

    def eval_actor_apply(self, nets: nn.ModuleDict, obs_n: torch.Tensor) -> torch.Tensor:
        """The team actor's mean, split at a and merged without mirroring."""
        mean = nets["actor_team"](obs_n)[0]
        a = self.ma.action_dim
        return self.ma.merge_actions(mean[:, :a], mean[:, a:], None)


class IPPOTeam2(IPPOTeam):
    name = "IPPOTeam2"
    ind_streams_full = False
