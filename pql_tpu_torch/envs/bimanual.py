"""Two-agent (right/left) tasks (port of pql_tpu/envs/bimanual.py:41-171).

``BimanualReacher``: two planar 2-link arms, agent 0 the right and agent 1
the left, each reaching its own target, with a shared ``coordination``
bonus while both are near theirs. Each arm observes itself in its handed
local frame, so the mirror symmetry is a pure role swap. The contract the
two-agent agents read:

- joint obs [24] = right arm block (12) ∥ left arm block (12);
- joint action [4] = right torques (2) ∥ left torques (2);
- ``info['detailed_reward']``: reach and ctrl per arm and ``coordination``,
  split per agent by ``multi`` (a ``MultiAgentSpec``);
- ``get_symmetry``: the per-env mirrored-episode flag (``BimanualReacherSym``
  samples half its episodes mirrored; the plain task never does).

``draw_reset`` [E, 7]: the initial joint angles U(-0.1, 0.1) as [arm, joint],
two uniforms on [0, 1) (one per arm) and the mirrored flag (0 or 1; always 0
without ``symmetric``). The JAX ``init_state`` draws the target's radius
and angle with one key, so both come from the same uniform bits: here one
uniform per arm drives both.
"""

from __future__ import annotations

import math

import torch

from pql_tpu_torch.utils.symmetry import EquivarianceSpec, MultiAgentSpec

_ARM_OBS = 12  # cos q(2), sin q(2), qd(2), target(2), tip − target(2), other tip(2)
# the C2 reflection across y = 0 on each arm's local obs and its torques
_ARM_OBS_SIGNS = (1, 1, -1, -1, -1, -1, 1, -1, 1, -1, 1, -1)
_ARM_ACT_SIGNS = (-1, -1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


class BimanualReacher:
    obs_dim = 2 * _ARM_OBS
    action_dim = 4
    max_episode_length = 150

    dt = 0.02
    link1 = 0.1
    link2 = 0.11
    max_torque = 1.0
    damping = 0.99
    base_half_gap = 0.3  # arm bases at x = ±base_half_gap
    target_radius = (0.08, 0.19)

    multi = MultiAgentSpec(
        single_agent_obs_idx=(((0, _ARM_OBS),), ((_ARM_OBS, 2 * _ARM_OBS),)),
        single_agent_obs_dim=(_ARM_OBS, _ARM_OBS),
        single_agent_action_dim=2,
        shared_obs_dim=2 * _ARM_OBS,
        right_reward_terms=("reach_right", "ctrl_right"),
        left_reward_terms=("reach_left", "ctrl_left"),
        shared_reward_terms=("coordination",),
    )
    equivariance = EquivarianceSpec(obs_signs=(_ARM_OBS_SIGNS, _ARM_OBS_SIGNS), act_signs=_ARM_ACT_SIGNS)

    def __init__(self, symmetric: bool = False):
        self.symmetric = symmetric

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        q = torch.rand(num_envs, 4, generator=gen, device=gen.device) * 0.2 - 0.1
        u = torch.rand(num_envs, 2, generator=gen, device=gen.device)
        sym = torch.rand(num_envs, 1, generator=gen, device=gen.device) < 0.5
        if not self.symmetric:
            sym = torch.zeros_like(sym)
        return torch.cat([q, u, sym.float()], -1)

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        E = draw.shape[0]
        u = draw[:, 4:6, None]  # [E, arm, 1]
        lo, hi = self.target_radius
        radius = u * (hi - lo) + lo
        angle = u * (2.0 * math.pi) - math.pi
        return {
            "q": draw[:, :4].reshape(E, 2, 2),  # [E, arm, joint]
            "qd": torch.zeros(E, 2, 2, device=draw.device),
            "target": torch.cat([radius * torch.cos(angle), radius * torch.sin(angle)], -1),  # local frames
            "sym": draw[:, 6].clone(),
        }

    def get_symmetry(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        return state["sym"]

    def _tip_local(self, q: torch.Tensor) -> torch.Tensor:
        """Fingertips in their arms' local frames; q [..., 2]."""
        q0, q01 = q[..., 0], q[..., 0] + q[..., 1]
        x = self.link1 * torch.cos(q0) + self.link2 * torch.cos(q01)
        y = self.link1 * torch.sin(q0) + self.link2 * torch.sin(q01)
        return torch.stack([x, y], -1)

    def _other_tip_in_frame(self, tips: torch.Tensor) -> torch.Tensor:
        """Each arm's view of the other's tip in its own handed frame:
        x_a = −local_b_x − 2g, y_a = local_b_y; tips [E, arm, 2]."""
        other = tips.flip(1)
        return torch.stack([-other[..., 0] - 2.0 * self.base_half_gap, other[..., 1]], -1)

    def get_obs(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        q, qd, target = state["q"], state["qd"], state["target"]
        tips = self._tip_local(q)
        per_arm = torch.cat([torch.cos(q), torch.sin(q), qd, target, tips - target, self._other_tip_in_frame(tips)],
                            -1)  # [E, arm, 12]
        return per_arm.reshape(q.shape[0], -1)

    def dynamics(self, state: dict[str, torch.Tensor], action: torch.Tensor):
        E = action.shape[0]
        torque = self.max_torque * torch.clamp(action.reshape(E, 2, 2), -1.0, 1.0)
        qd = torch.clamp(state["qd"] * self.damping + self.dt * torque / 0.01, -10.0, 10.0)
        q = state["q"] + self.dt * qd

        dists = _norm(self._tip_local(q) - state["target"])  # [E, arm]
        near = torch.exp(-100.0 * torch.square(dists))
        ctrl = -0.1 * torch.sum(torch.square(torque / self.max_torque), -1)
        detailed = {
            "reach_right": -dists[:, 0] + 0.1 * near[:, 0],
            "reach_left": -dists[:, 1] + 0.1 * near[:, 1],
            "ctrl_right": ctrl[:, 0],
            "ctrl_left": ctrl[:, 1],
            "coordination": 0.5 * near[:, 0] * near[:, 1],
        }
        reward = sum(detailed.values())
        success = (dists[:, 0] < 0.05) & (dists[:, 1] < 0.05)
        next_state = {"q": q, "qd": qd, "target": state["target"], "sym": state["sym"]}
        terminated = torch.zeros(E, dtype=torch.bool, device=action.device)
        return next_state, reward, terminated, {"success": success.float(), "detailed_reward": detailed}


class BimanualReacherSym(BimanualReacher):
    """Half the episodes sampled mirrored (the symmetric-envs mode)."""

    def __init__(self):
        super().__init__(symmetric=True)
