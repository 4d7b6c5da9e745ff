"""CrossQ on one device (port of pql_tpu/algos/crossq.py).

No target critic: the critic (``DoubleQBatchNorm``) carries BatchNorm
layers, and (obs, action) and (next_obs, next_action) go through one joint
train-mode forward over the 2B rows, so both halves see the same batch
statistics; the next-Q half, detached, makes the TD target, and that pass's
batch statistics become the running ones (the critic's ``mean``/``var``
buffers). The actor loss runs the critic in train mode on the obs batch and
discards that pass's statistics. Exploration and the next actions are
DDPG's: the deterministic policy plus noise, and the live actor plus
clipped smoothing noise.

The state is an ``OffPolicyState`` with ``critic_target`` None: the JAX
package keeps a copy of the critic there for the shape of its state only
(crossq.py:46), which the port drops.
"""

from __future__ import annotations

import torch

from pql_tpu_torch.algos import base
from pql_tpu_torch.algos.ddpg import DDPG, OffPolicyState


class CrossQ(DDPG):
    name = "CrossQ"

    def init(self, seed: int | None = None) -> OffPolicyState:
        s = super().init(seed)
        s.critic_target = None
        return s

    def _one_update(self, state: OffPolicyState, batch: dict, normals: dict):
        cfg = self.cfg
        obs_n, next_obs_n = batch["obs"], batch["next_obs"]
        with torch.no_grad():
            next_actions = base.target_policy_actions(cfg, state.actor, next_obs_n, normals["target_normal"])
        b = obs_n.shape[0]
        q1_all, q2_all = state.critic(torch.cat([obs_n, next_obs_n]), torch.cat([batch["action"], next_actions]),
                                      train=True)
        state.critic.commit_batch_stats()
        with torch.no_grad():
            target = self._td_target(batch, torch.minimum(q1_all[b:], q2_all[b:]))
        critic_loss = self._critic_step(state, q1_all[:b], q2_all[:b], target)
        # train-mode statistics of this pass are not committed
        q1, q2 = state.critic(obs_n, state.actor(obs_n), train=True)
        actor_loss = self._actor_step(state, -torch.mean(torch.minimum(q1, q2)))
        return {"critic": critic_loss, "actor": actor_loss}
