"""Soft Actor-Critic on one device (port of pql_tpu/algos/sac.py).

The DDPG skeleton (explore, n-step replay, ``update_times`` updates) with
SAC's policy, TD target and temperature:

- exploration samples the squashed-Gaussian policy and ignores the noise
  config (uniform actions in warm-up);
- the TD target samples next actions from the live actor (SAC has no actor
  target) and subtracts α · logπ; both it and the actor loss α · logπ − Q use
  the temperature from before this update, and the actor loss the critic
  after this update's critic step;
- with ``algo.alpha`` None, log α takes one step of ``adamw(alpha_lr,
  weight_decay=0.01)`` (no gradient clip; the decay applies to log α) on
  mean(α · (−logπ − target_entropy)), logπ from the actor-loss pass with
  its gradient stopped; target entropy −action_dim;
- only the critic target is soft-updated.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch
from torch import nn

from pql_tpu_torch.algos import base
from pql_tpu_torch.algos.ddpg import DDPG, OffPolicyState
from pql_tpu_torch.ops.soft_update import soft_update


@dataclass
class SACState(OffPolicyState):
    log_alpha: torch.Tensor = None  # [1], a leaf with gradients
    alpha_opt: torch.optim.Optimizer = None


class SAC(DDPG):
    name = "SAC"
    _update_normals = ("next_normal", "actor_normal")  # the TD target's and the actor loss's policy samples

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        self.target_entropy = -float(self.action_dim)

    def init(self, seed: int | None = None) -> SACState:
        s = super().init(seed)
        log_alpha = torch.zeros(1, dtype=torch.float32, device=self.device, requires_grad=True)
        opt = torch.optim.AdamW([log_alpha], lr=self.cfg.algo.alpha_lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
        return SACState(**{f.name: getattr(s, f.name) for f in fields(s)}, log_alpha=log_alpha, alpha_opt=opt)

    def _explore_action(self, state: SACState, obs_n, normal, step: int):
        return state.actor.sample(obs_n, normal)[0]

    def _one_update(self, state: SACState, batch: dict, normals: dict):
        cfg = self.cfg
        obs_n, next_obs_n = batch["obs"], batch["next_obs"]
        alpha = torch.exp(state.log_alpha[0]).detach() if cfg.algo.alpha is None else cfg.algo.alpha
        with torch.no_grad():
            next_actions, next_logp = state.actor.sample(next_obs_n, normals["next_normal"])
            q_next = state.critic_target.q_min(next_obs_n, next_actions)
            target = self._td_target(batch, q_next - alpha * next_logp)
        critic_loss = self._critic_step(state, *state.critic(obs_n, batch["action"]), target)

        actions, logp = state.actor.sample(obs_n, normals["actor_normal"])
        actor_loss = self._actor_step(state, torch.mean(alpha * logp - state.critic.q_min(obs_n, actions)))

        if cfg.algo.alpha is None:
            alpha_loss = torch.mean(torch.exp(state.log_alpha[0]) * (-logp.detach() - self.target_entropy))
            base.descend(state.alpha_opt, [state.log_alpha], alpha_loss, None)
        soft_update(state.critic_target, state.critic, cfg.algo.tau)
        return {"critic": critic_loss, "actor": actor_loss}

    @staticmethod
    def eval_actor_apply(actor: nn.Module, obs_n: torch.Tensor) -> torch.Tensor:
        """tanh of the policy's mean."""
        return actor.mean_action(obs_n)
