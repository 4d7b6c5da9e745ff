"""QTOTV1 and QTOTV2 on one device: IPPO with a total critic (port of
pql_tpu/algos/qtot.py).

Both add ``critic_tot``, a state-value critic on the whole normalized joint
obs, trained on the total reward stream ``reward_scale · (rew_r + rew_l)``
with a value-rms of its own (``value_rms_tot``). Each hand's actor mixes
its own advantage with the total one, whitened once per minibatch:

- QTOTV1 clips one surrogate on the sum ``adv + adv_tot`` (qtot.py:95-99);
- QTOTV2 adds a second clipped surrogate on ``adv_tot`` alone, with no
  entropy term (qtot.py:100-108).

With ``value_norm`` the rollout's total values are unnormalized with the
iteration's starting ``value_rms_tot``, which the rollout does not move;
the advantage step moves it three times, with the bootstrap value, the
returns and the old values (qtot.py:53-89). One minibatch steps actor,
critic, actor_left, critic_left, then critic_tot; the three streams share
each epoch's permutation. The rest is IPPO's (``algos/ippo.py``), whose
``same_policy`` the JAX agent cannot run and the port refuses.
"""

from __future__ import annotations

import torch

from pql_tpu_torch.algos import base, ma_base
from pql_tpu_torch.algos.ippo import IPPO
from pql_tpu_torch.algos.ppo import critic_value, value_targets
from pql_tpu_torch.ops.running_norm import RunningMeanStd


class _QTOTBase(IPPO):
    sum_advantages = True  # V1: one clipped term on the summed advantages; V2: two

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        if cfg.algo.same_policy:
            raise ValueError(f"{self.name} trains one actor per hand: algo.same_policy must be false")
        super().__init__(cfg, device)

    def _models(self, g: torch.Generator) -> dict:
        models = super()._models(g)
        models["nets"]["critic_tot"] = self.ma.make_critic(self.cfg, g, central=True).to(self.device)
        models["opts"]["critic_tot"] = base.build_optimizer(models["nets"]["critic_tot"], self.cfg.algo.critic_lr)
        return models

    def _value_norms(self) -> dict:
        return dict(super()._value_norms(), value_rms_tot=RunningMeanStd((1,), device=self.device))

    # -------------------------------------------------------------- rollout

    def _act(self, state, obs_n, draws: dict, t: int):
        """IPPO's step, plus the total value of the whole normalized joint obs,
        unnormalized with the rms the iteration started from (not moved)."""
        action, record = super()._act(state, obs_n, draws, t)
        val_tot = state.nets["critic_tot"](obs_n)[..., 0]
        if self.cfg.algo.value_norm:
            val_tot = state.value_rms_tot.unnormalize(val_tot[:, None])[:, 0]
        record.update(obs_tot=obs_n, val_tot=val_tot)
        return action, record

    def _extra_rewards(self, rew_r: torch.Tensor, rew_l: torch.Tensor) -> dict:
        return dict(rew_tot=self.cfg.algo.reward_scale * (rew_r + rew_l))

    # ------------------------------------------------------------ advantage

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """IPPO's two hands' data, then the total stream's (obs, adv, returns,
        values), flat [H·E, ...]."""
        cfg, f = self.cfg, ma_base.flat
        next_value = critic_value(cfg, state.nets["critic_tot"], self._normalize(state, state.obs), state.value_rms_tot)
        adv, ret = ma_base.gae(traj["rew_tot"], traj["dones"], traj["val_tot"], traj["truncated"], next_value,
                               state.dones, cfg.algo.gamma, cfg.algo.lambda_gae_adv, cfg.algo.use_gae)
        b_ret, b_val = value_targets(cfg, state.value_rms_tot, ret, traj["val_tot"])
        return super()._advantages(state, traj) + (f(traj["obs_tot"]), f(adv), b_ret, b_val)

    # --------------------------------------------------------------- update

    def _surrogate(self, logp_new, logp_old, adv, adv_tot, entropy):
        cfg = self.cfg
        if self.sum_advantages:
            return ma_base.ppo_actor_loss(logp_new, logp_old, adv + adv_tot, entropy, cfg.algo.ratio_clip,
                                          cfg.algo.lambda_entropy)
        own = ma_base.ppo_actor_loss(logp_new, logp_old, adv, entropy, cfg.algo.ratio_clip, cfg.algo.lambda_entropy)
        return own + ma_base.ppo_actor_loss(logp_new, logp_old, adv_tot, torch.zeros_like(entropy),
                                            cfg.algo.ratio_clip, 0.0)

    def _minibatch_update(self, state, batch: tuple) -> dict:
        """A step of each hand's actor on its mixed surrogate and of its
        critic, right then left, then one of the total critic."""
        cfg, nets = self.cfg, state.nets
        obs_tot, adv_tot, ret_tot, val_tot = batch[12:]
        adv_tot = ma_base.normalize_advantages(adv_tot)
        losses = {}
        for s, (obs, actions, logp_old, adv, returns, v_old) in (("", batch[:6]), ("_left", batch[6:12])):
            logp_new, entropy = nets[f"actor{s}"].logprob_entropy(obs, actions)
            losses[f"actor{s}"] = self._surrogate(logp_new, logp_old, ma_base.normalize_advantages(adv), adv_tot,
                                                  entropy)
            losses[f"critic{s}"] = ma_base.ppo_value_loss(nets[f"critic{s}"](obs)[..., 0], returns, v_old,
                                                          cfg.algo.ratio_clip, cfg.algo.value_clip)
        losses["critic_tot"] = ma_base.ppo_value_loss(nets["critic_tot"](obs_tot)[..., 0], ret_tot, val_tot,
                                                      cfg.algo.ratio_clip, cfg.algo.value_clip)
        g = cfg.algo.max_grad_norm
        return {k: base.descend(state.opts[k], list(nets[k].parameters()), loss, g) for k, loss in losses.items()}


class QTOTV1(_QTOTBase):
    name = "QTOTV1"
    sum_advantages = True


class QTOTV2(_QTOTBase):
    name = "QTOTV2"
    sum_advantages = False
