"""The equivariant agent family on one device (port of pql_tpu/algos/eq.py).

PPO-template agents that use the two-hand task's C2 mirror symmetry, with
the EMLPs of ``models/emlp.py`` at their presets
(``DiagGaussianEquivariantMLPPolicy`` / ``MLPCriticEquivariant``; MP and
EQSdata keep the plain nets):

- EQ: IPPO with one actor/critic pair shared by both hands (the class hook
  ``same_policy = True``; eq.py:45-49);
- EQS, MP: IPPO under their own names (eq.py:52-56, :403-408);
- EQG: PPO on the joint obs, its actor on joint_obs_gen → act_gen ⊕ act_gen
  and its critic on joint_obs_gen (eq.py:63-88);
- EQSC: an equivariant actor per hand and one central invariant critic on
  the whole normalized obs, fed the summed reward ``reward_scale · (rew_r
  + rew_l)``. One value-rms, moved as PPO's: at every rollout step, then by
  the bootstrap, the returns and the old values. One GAE stream, whose
  advantages, whitened per minibatch, drive both hands' clipped losses. A
  minibatch steps actor, actor_left, critic (eq.py:96-295);
- EQSdata: IPPO with plain nets, plus a transformed stream per hand: the
  stored obs view times the hand's generator goes through the same actor (a
  fresh sample over the H·E rows, ``transform_normal[_left]``) and critic,
  with the same rewards and dones; its GAE reads the value-rms, never moves
  it. Each hand's batch is real ∥ transformed, so an epoch permutes 2·H·E
  rows, and both hands' minibatches take the same permutation
  (eq.py:303-400);
- EQS4: four actor/critic pairs, each hand in its own and its opposed frame
  (the obs view times the hand's generator). Each hand executes
  ½(a + a_op · G_act). Four GAE streams on the critics' raw values: the JAX
  path applies no value-rms, whatever ``algo.value_norm`` says, and the port
  keeps that. A minibatch steps the pairs in the order right, left, right
  opposed, left opposed, actor before critic (eq.py:411-587).

EQSC's state is ``EQSCState``; the others keep IPPO's or PPO's. The eval
hooks: EQSC the hands' means; EQS4 the mean of each hand's normal and
back-transformed opposed means.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from pql_tpu_torch.algos import base, ma_base
from pql_tpu_torch.algos.ippo import IPPO
from pql_tpu_torch.algos.ppo import PPO, critic_value, value_targets
from pql_tpu_torch.envs.base import VecEnvState
from pql_tpu_torch.models import get_model
from pql_tpu_torch.models.emlp import concat_reps
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.utils.trackers import EpisodeStats


class EQ(IPPO):
    name = "EQ"
    same_policy = True


class EQS(IPPO):
    name = "EQS"


class MP(IPPO):
    name = "MP"


def _rep(gen: tuple, device) -> torch.Tensor:
    return torch.tensor(np.asarray(gen, np.float32), device=device)


def _require_spec(agent) -> None:
    if agent.ma.eq is None:
        raise ValueError(f"{agent.name} needs the task to provide an EquivarianceSpec")


# ---------------------------------------------------------------------------
# EQG — one equivariant policy over the whole system
# ---------------------------------------------------------------------------


class EQG(PPO):
    name = "EQG"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        self.ma = ma_base.MultiAgentCtx(self.env)

    def _models(self, g: torch.Generator) -> dict:
        cfg, ma, dtype = self.cfg, self.ma, base.compute_dtype(self.cfg)
        rep = ma.joint_obs_gen()
        actor = get_model(cfg.algo.act_class)(gen_in=rep, gen_out=concat_reps(ma.act_gen(), ma.act_gen()), gen=g,
                                              dtype=dtype).to(self.device)
        critic = get_model(cfg.algo.cri_class)(gen_in=rep, gen=g, dtype=dtype).to(self.device)
        return dict(actor=actor, actor_opt=base.build_optimizer(actor, cfg.algo.actor_lr),
                    critic=critic, critic_opt=base.build_optimizer(critic, cfg.algo.critic_lr))


# ---------------------------------------------------------------------------
# EQSC — per-hand equivariant actors and one central invariant critic
# ---------------------------------------------------------------------------


@dataclass
class EQSCState:
    nets: nn.ModuleDict  # actor, actor_left, critic
    opts: dict[str, torch.optim.Optimizer]
    obs_rms: RunningMeanStd  # of the joint obs
    value_rms: RunningMeanStd
    env_state: VecEnvState
    obs: torch.Tensor
    dones: torch.Tensor
    stats: EpisodeStats
    gen: torch.Generator
    env_steps: int
    update_count: int


class EQSC(ma_base.NetsDictAgent, PPO):
    name = "EQSC"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        self.ma = ma_base.MultiAgentCtx(self.env)

    def _models(self, g: torch.Generator) -> dict:
        cfg, ma = self.cfg, self.ma
        return self._build({"actor": ma.make_actor(cfg, g, 0), "actor_left": ma.make_actor(cfg, g, 1),
                            "critic": ma.make_critic(cfg, g, central=True)})

    def _state_cls(self):
        return EQSCState

    _action_normals = IPPO._action_normals

    def _act(self, state, obs_n, draws: dict, t: int):
        nets = state.nets
        tracker = self.env.symmetry_tracker(state.env_state)
        ob_r, ob_l = self.ma.split_obs(obs_n, tracker)
        act_r, logp_r, _ = nets["actor"].sample(ob_r, draws["action_normal"][t])
        act_l, logp_l, _ = nets["actor_left"].sample(ob_l, draws["action_normal_left"][t])
        value = critic_value(self.cfg, nets["critic"], obs_n, state.value_rms)
        record = dict(obs_r=ob_r, obs_l=ob_l, obs_critic=obs_n, act_r=act_r, act_l=act_l, logp_r=logp_r,
                      logp_l=logp_l, value=value, tracker=tracker)
        return self.ma.merge_actions(act_r, act_l, tracker), record

    def _record_step(self, state, record: dict, reward, done, info) -> None:
        rew_r, rew_l = self.ma.split_reward(info, record.pop("tracker"))
        state.stats.update(rew_r + rew_l, done, info)
        record.update(reward=self.cfg.algo.reward_scale * (rew_r + rew_l), dones=state.dones,
                      truncated=info["truncated"].float())

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """(obs_r, obs_l, critic obs, act_r, act_l, logp_r, logp_l, adv,
        returns, values), flat [H·E, ...]."""
        cfg, f = self.cfg, ma_base.flat
        next_value = critic_value(cfg, state.nets["critic"], self._normalize(state, state.obs), state.value_rms)
        adv, ret = ma_base.gae(traj["reward"], traj["dones"], traj["value"], traj["truncated"], next_value,
                               state.dones, cfg.algo.gamma, cfg.algo.lambda_gae_adv, cfg.algo.use_gae)
        b_ret, b_val = value_targets(cfg, state.value_rms, ret, traj["value"])
        return tuple(f(traj[k]) for k in ("obs_r", "obs_l", "obs_critic", "act_r", "act_l", "logp_r", "logp_l")) + (
            f(adv), b_ret, b_val)

    def _minibatch_update(self, state, batch: tuple) -> dict:
        nets, algo = state.nets, self.cfg.algo
        obs_r, obs_l, obs_c, act_r, act_l, logp_r, logp_l, adv, returns, v_old = batch
        adv = ma_base.normalize_advantages(adv)
        losses = {}
        for name, obs, act, logp in (("actor", obs_r, act_r, logp_r), ("actor_left", obs_l, act_l, logp_l)):
            logp_new, entropy = nets[name].logprob_entropy(obs, act)
            losses[name] = ma_base.ppo_actor_loss(logp_new, logp, adv, entropy, algo.ratio_clip, algo.lambda_entropy)
        losses["critic"] = ma_base.ppo_value_loss(nets["critic"](obs_c)[..., 0], returns, v_old, algo.ratio_clip,
                                                  algo.value_clip)
        return self._step_all(state, losses)

    def eval_actor_apply(self, nets: nn.ModuleDict, obs_n: torch.Tensor) -> torch.Tensor:
        ob_r, ob_l = self.ma.split_obs(obs_n, None)
        return self.ma.merge_actions(nets["actor"](ob_r)[0], nets["actor_left"](ob_l)[0], None)


# ---------------------------------------------------------------------------
# EQSdata — symmetry data augmentation with plain networks
# ---------------------------------------------------------------------------


class EQSdata(IPPO):
    name = "EQSdata"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        _require_spec(self)
        self._g_obs = (_rep(self.ma.obs_gen(0), self.device), _rep(self.ma.obs_gen(1), self.device))

    @property
    def rows(self) -> int:
        return 2 * self.cfg.algo.horizon_len * self.num_envs

    def _action_normals(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        d = super()._action_normals(gen)
        n, A = self.cfg.algo.horizon_len * self.num_envs, self.ma.action_dim
        d.update(transform_normal=torch.randn(n, A, generator=gen, device=gen.device),
                 transform_normal_left=torch.randn(n, A, generator=gen, device=gen.device))
        return d

    def _rollout(self, state, draws: dict) -> dict[str, torch.Tensor]:
        traj = super()._rollout(state, draws)  # the transformed stream's draws ride along
        traj.update(transform_normal=draws["transform_normal"], transform_normal_left=draws["transform_normal_left"])
        return traj

    @torch.no_grad()
    def _transformed(self, state, traj: dict, side: int) -> tuple:
        """One hand's transformed stream: (obs, action, logp, adv, returns,
        values), flat [H·E, ...]."""
        cfg, f, s, g = self.cfg, ma_base.flat, "rl"[side], self._g_obs[side]
        actor, critic = (state.nets["actor"], state.nets["critic"]) if side == 0 else (
            state.nets[self._left("actor")], state.nets[self._left("critic")])
        rms = state.value_rms if side == 0 else state.value_rms_left
        obs_t = traj[f"obs_{s}"] @ g
        T, E = obs_t.shape[:2]
        flat_obs = obs_t.reshape(T * E, -1)
        act_t, logp_t, _ = actor.sample(flat_obs, traj["transform_normal" + ("" if side == 0 else "_left")])
        val_t = critic(flat_obs)[..., 0]
        last = self.ma.split_obs(self._normalize(state, state.obs), self.env.symmetry_tracker(state.env_state))
        next_value = critic(last[side] @ g)[..., 0]
        if cfg.algo.value_norm:
            val_t = rms.unnormalize(val_t[:, None])[:, 0]
            next_value = rms.unnormalize(next_value[:, None])[:, 0]
        val_t = val_t.reshape(T, E)
        adv, ret = ma_base.gae(traj[f"rew_{s}"], traj["dones"], val_t, traj["truncated"], next_value, state.dones,
                               cfg.algo.gamma, cfg.algo.lambda_gae_adv, cfg.algo.use_gae)
        if cfg.algo.value_norm:
            b_ret, b_val = rms.normalize(ret.reshape(-1, 1))[:, 0], rms.normalize(val_t.reshape(-1, 1))[:, 0]
        else:
            b_ret, b_val = f(ret), f(val_t)
        return flat_obs, act_t, logp_t, f(adv), b_ret, b_val

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """IPPO's right and left batches, each followed by its transformed
        stream: right real ∥ transformed (6 tensors), then left's."""
        real = super()._advantages(state, traj)
        out = ()
        for side, data in enumerate((real[:6], real[6:])):
            out += tuple(torch.cat([a, b]) for a, b in zip(data, self._transformed(state, traj, side)))
        return out


# ---------------------------------------------------------------------------
# EQS4 — four policies: each hand in its own and its opposed frame
# ---------------------------------------------------------------------------

_GROUPS = ("", "_left", "_op", "_left_op")  # right, left, right opposed, left opposed


class EQS4(IPPO):
    name = "EQS4"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        _require_spec(self)
        if self.same_policy:
            raise ValueError("EQS4 trains four actor/critic pairs: algo.same_policy must be false")
        ma = self.ma
        self._g_r, self._g_l = _rep(ma.obs_gen(0), self.device), _rep(ma.obs_gen(1), self.device)
        self._g_a = _rep(ma.act_gen(), self.device)

    def _models(self, g: torch.Generator) -> dict:
        cfg, ma = self.cfg, self.ma
        nets = {}
        for sfx, side in zip(_GROUPS, (0, 1, 0, 1)):
            nets.update({f"actor{sfx}": ma.make_actor(cfg, g, side), f"critic{sfx}": ma.make_critic(cfg, g, side)})
        return self._build(nets)

    def _action_normals(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        H, E, A = self.cfg.algo.horizon_len, self.num_envs, self.ma.action_dim
        return {f"action_normal{s}": torch.randn(H, E, A, generator=gen, device=gen.device) for s in _GROUPS}

    def _views(self, obs_n, tracker) -> tuple:
        """The four groups' obs views: right, left, and each in the opposed frame."""
        ob_r, ob_l = self.ma.split_obs(obs_n, tracker)
        return ob_r, ob_l, ob_r @ self._g_r, ob_l @ self._g_l

    def _act(self, state, obs_n, draws: dict, t: int):
        nets = state.nets
        tracker = self.env.symmetry_tracker(state.env_state)
        record = dict(tracker=tracker)
        for sfx, ob in zip(_GROUPS, self._views(obs_n, tracker)):
            a, lp, _ = nets[f"actor{sfx}"].sample(ob, draws[f"action_normal{sfx}"][t])
            record.update({f"ob{sfx}": ob, f"a{sfx}": a, f"lp{sfx}": lp, f"v{sfx}": nets[f"critic{sfx}"](ob)[..., 0]})
        exec_r = 0.5 * (record["a"] + record["a_op"] @ self._g_a)
        exec_l = 0.5 * (record["a_left"] + record["a_left_op"] @ self._g_a)
        return self.ma.merge_actions(exec_r, exec_l, tracker), record

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """Per group (right, left, right opposed, left opposed): (obs, action,
        logp, adv, returns, values), flat [H·E, ...]; the opposed groups take
        their hand's reward."""
        cfg, nets, f = self.cfg, state.nets, ma_base.flat
        views = self._views(self._normalize(state, state.obs), self.env.symmetry_tracker(state.env_state))
        data = ()
        for sfx, last, rew in zip(_GROUPS, views, ("rew_r", "rew_l", "rew_r", "rew_l")):
            adv, ret = ma_base.gae(traj[rew], traj["dones"], traj[f"v{sfx}"], traj["truncated"],
                                   nets[f"critic{sfx}"](last)[..., 0], state.dones, cfg.algo.gamma,
                                   cfg.algo.lambda_gae_adv, cfg.algo.use_gae)
            data += (f(traj[f"ob{sfx}"]), f(traj[f"a{sfx}"]), f(traj[f"lp{sfx}"]), f(adv), f(ret), f(traj[f"v{sfx}"]))
        return data

    def _minibatch_update(self, state, batch: tuple) -> dict:
        nets, losses = state.nets, {}
        for i, sfx in enumerate(_GROUPS):
            ob, *rest = batch[6 * i : 6 * i + 6]
            losses[f"actor{sfx}"], losses[f"critic{sfx}"] = self._losses(nets[f"actor{sfx}"], nets[f"critic{sfx}"],
                                                                         ob, ob, *rest)
        return self._step_all(state, losses)

    def eval_actor_apply(self, nets: nn.ModuleDict, obs_n: torch.Tensor) -> torch.Tensor:
        """Each hand's ensemble of its normal and back-transformed opposed means."""
        m = [nets[f"actor{sfx}"](ob)[0] for sfx, ob in zip(_GROUPS, self._views(obs_n, None))]
        return self.ma.merge_actions(0.5 * (m[0] + m[2] @ self._g_a), 0.5 * (m[1] + m[3] @ self._g_a), None)
