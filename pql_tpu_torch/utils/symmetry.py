"""Two-agent observation, action and reward routing with mirror symmetry
(port of pql_tpu/utils/symmetry.py:35-184).

A two-agent (right/left) task describes itself with a ``MultiAgentSpec``:
the column ranges of each agent's view of the joint observation, the
action and shared-obs sizes, the named reward terms of each agent and of
both, and the signed permutations that reflect one agent's frame onto the
other's. ``SymmetryManager`` uses it to

- split a joint obs [E, D] into (right [E, d0], left [E, d1]);
- merge per-agent actions into the joint sim action [right ∥ left];
- sum each agent's reward terms and the shared ones.

With ``symmetric_envs`` and a per-env tracker (1 = the episode was sampled
mirrored), a mirrored env swaps the agents' roles and reflects each view
into the canonical frame, and the action merge undoes it. Every operation
is a fixed-shape gather or ``where`` on the tensors' device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def ranges_to_indices(ranges) -> np.ndarray:
    """[(start, end), ...] column ranges → flat int32 index vector."""
    idx: list[int] = []
    for start, end in ranges:
        idx.extend(range(int(start), int(end)))
    return np.asarray(idx, dtype=np.int32)


def slice_tensor(x: torch.Tensor, ranges) -> torch.Tensor:
    """The given column ranges of the last axis."""
    return x[..., torch.from_numpy(ranges_to_indices(ranges)).long().to(x.device)]


@dataclass(frozen=True)
class MultiAgentSpec:
    """Static description of a two-agent (right/left) task (the reference's
    ``cfg.task.multi`` block); the ``mirror_*`` signed permutations (None =
    identity) reflect a per-agent view across the symmetry plane."""

    single_agent_obs_idx: tuple  # ((ranges right), (ranges left))
    single_agent_obs_dim: tuple  # (dim_right, dim_left)
    single_agent_action_dim: int
    shared_obs_dim: int
    right_reward_terms: tuple = ()
    left_reward_terms: tuple = ()
    shared_reward_terms: tuple = ()
    mirror_obs_perm: tuple | None = None
    mirror_obs_sign: tuple | None = None
    mirror_act_perm: tuple | None = None
    mirror_act_sign: tuple | None = None


@dataclass(frozen=True)
class EquivarianceSpec:
    """C2-representation data of a task for equivariant networks: per-hand
    obs signs, action signs, and optional permutations."""

    obs_signs: tuple  # ((right-hand signs...), (left-hand signs...))
    act_signs: tuple
    obs_perms: tuple | None = None
    act_perm: tuple | None = None


def _signed_perm(x: torch.Tensor, perm, sign) -> torch.Tensor:
    if perm is not None:
        x = x[..., torch.tensor(perm, dtype=torch.long, device=x.device)]
    if sign is not None:
        x = x * torch.tensor(sign, dtype=torch.float32, device=x.device)
    return x


class SymmetryManager:
    """Routes joint obs, actions and rewards between the sim and the two agents."""

    def __init__(self, spec: MultiAgentSpec, symmetric_envs: bool = False):
        self.spec = spec
        self.symmetric_envs = symmetric_envs
        self._idx_right = torch.from_numpy(ranges_to_indices(spec.single_agent_obs_idx[0])).long()
        self._idx_left = torch.from_numpy(ranges_to_indices(spec.single_agent_obs_idx[1])).long()
        if len(self._idx_right) != len(self._idx_left) and symmetric_envs:
            raise ValueError("symmetric envs require equal per-agent obs dims")

    def _mask(self, tracker: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return (tracker > 0.5).reshape((-1,) + (1,) * (like.dim() - 1))

    def get_multi_agent_obs(self, obs: torch.Tensor, tracker: torch.Tensor | None):
        """Joint obs [E, D] → (obs_right [E, d0], obs_left [E, d1])."""
        ob_r = obs[..., self._idx_right.to(obs.device)]
        ob_l = obs[..., self._idx_left.to(obs.device)]
        if not self.symmetric_envs or tracker is None:
            return ob_r, ob_l
        s, m = self.spec, self._mask(tracker, ob_r)
        ob_r_mirror = _signed_perm(ob_l, s.mirror_obs_perm, s.mirror_obs_sign)
        ob_l_mirror = _signed_perm(ob_r, s.mirror_obs_perm, s.mirror_obs_sign)
        return torch.where(m, ob_r_mirror, ob_r), torch.where(m, ob_l_mirror, ob_l)

    def get_execute_action(self, act_right: torch.Tensor, act_left: torch.Tensor,
                           tracker: torch.Tensor | None) -> torch.Tensor:
        """The joint sim action [E, 2a]: right block, then left block; a
        mirrored env's actions are un-reflected and swapped back."""
        if self.symmetric_envs and tracker is not None:
            s, m = self.spec, self._mask(tracker, act_right)
            unmirror_r = _signed_perm(act_left, s.mirror_act_perm, s.mirror_act_sign)
            unmirror_l = _signed_perm(act_right, s.mirror_act_perm, s.mirror_act_sign)
            act_right, act_left = torch.where(m, unmirror_r, act_right), torch.where(m, unmirror_l, act_left)
        return torch.cat([act_right, act_left], dim=-1)

    def get_multi_agent_rew(self, detailed_reward: dict, tracker: torch.Tensor | None):
        """(rew_right, rew_left): each agent's terms plus the shared ones,
        summed in the spec's order; a mirrored env swaps them."""
        s = self.spec

        def total(terms):
            parts = [detailed_reward[t] for t in terms] + [detailed_reward[t] for t in s.shared_reward_terms]
            if not parts:
                return torch.zeros_like(next(iter(detailed_reward.values())))
            return sum(parts[1:], parts[0])

        rew_r, rew_l = total(s.right_reward_terms), total(s.left_reward_terms)
        if self.symmetric_envs and tracker is not None:
            m = tracker > 0.5
            rew_r, rew_l = torch.where(m, rew_l, rew_r), torch.where(m, rew_r, rew_l)
        return rew_r, rew_l


def parse_multi_rew(detailed_reward: dict, spec: MultiAgentSpec):
    """The named-term reward split without mirroring."""
    return SymmetryManager(spec).get_multi_agent_rew(detailed_reward, None)
