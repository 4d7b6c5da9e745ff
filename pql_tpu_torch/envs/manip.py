"""Arm manipulation on the ported engine (port of pql_tpu/envs/manip.py:27-190).

FrankaCubeStack (the IGE task the reference runs at 8192 envs with a PPO
preset of its own, reward scale 0.1): a 7-hinge torque-controlled arm picks
cube A and stacks it on cube B. The engine has no closed-loop grasp, so a
grasp is the task's simplified mechanic: closing the gripper (action[7] > 0)
within ``grasp_range`` of cube A attaches it rigidly below the end effector;
opening releases it, and a released cube drops 0.02 per step to the table.
The reward is IGE's staged shaping: reach, grasp, lift, align, stack.

Batched as the port's ``Task`` protocol: ``draw_reset`` [E, 11] holds the
numbers the JAX ``init_state`` draws, in the order of its keys k1, k2, k3:
7 joint offsets U(-0.1, 0.1), cube A's x, y U(0.25, 0.45), cube B's x, y
U(-0.45, -0.25). On a card a control step (both substeps, the grasp
``where``s and the reward) is one captured CUDA graph (``GraphedTask``).
"""

from __future__ import annotations

import numpy as np
import torch

from pql_tpu_torch.envs.base import GraphedTask
from pql_tpu_torch.physics import Geom, HINGE, RigidBodyModel
from pql_tpu_torch.physics import scalar_algebra as sa
from pql_tpu_torch.physics.dynamics import _columns, _kin_s, _stack, physics_substeps

CUBE_A_HALF = 0.025
CUBE_B_HALF = 0.035
_TIP = (0.0, 0.0, 0.107)  # the end effector in the last link's frame


def franka_model(dt: float = 1.0 / 120.0) -> RigidBodyModel:
    """7-hinge serial arm anchored at the origin (Franka-like alternating
    yaw/pitch axes and link lengths); no free bodies."""
    link_len = [0.333, 0.316, 0.0825, 0.384, 0.0825, 0.088, 0.107]
    axes = [[0, 0, 1], [0, 1, 0], [0, 0, 1], [0, -1, 0], [0, 0, 1], [0, -1, 0], [0, 0, 1]]
    masses = [3.0, 3.0, 2.5, 2.5, 2.0, 1.5, 0.5]

    parent, joint_type, joint_axis, tree_pos = [], [], [], []
    mass, com, inertia = [], [], []
    up = np.array([0.0, 0.0, 1.0])
    for i in range(7):
        parent.append(i - 1)
        joint_type.append(HINGE)
        joint_axis.append(np.asarray(axes[i], np.float32))
        tree_pos.append((link_len[i - 1] if i > 0 else 0.0) * up)
        mass.append(masses[i])
        com.append(0.5 * link_len[i] * up)
        i_perp = masses[i] * link_len[i] ** 2 / 3.0
        inertia.append(i_perp * (np.eye(3) - np.outer(up, up)) + 1e-3 * np.eye(3))

    nv = 7
    return RigidBodyModel(
        nb=7,
        parent=tuple(parent),
        joint_type=tuple(joint_type),
        joint_axis=np.asarray(joint_axis, np.float32),
        tree_pos=np.asarray(tree_pos, np.float32),
        mass=np.asarray(mass, np.float32),
        com=np.asarray(com, np.float32),
        inertia=np.asarray(inertia, np.float32),
        damping=np.full(nv, 2.0, np.float32),
        armature=np.full(nv, 0.1, np.float32),
        actuated_dofs=tuple(range(7)),
        gear=np.array([87, 87, 87, 87, 12, 12, 12], np.float32),
        limit_lo=np.array([-2.9, -1.76, -2.9, -3.07, -2.9, -0.02, -2.9], np.float32),
        limit_hi=np.array([2.9, 1.76, 2.9, -0.07, 2.9, 3.75, 2.9], np.float32),
        limit_stiffness=60.0,
        geoms=(Geom(6, (0.0, 0.0, 0.107), 0.03),),
        dt=dt,
        contact_kp=0.0,
        contact_kd=0.0,
        friction_mu=0.0,
        contact_force_cap=0.0,
        max_dof_speed=10.0,
    )


class FrankaCubeStack(GraphedTask):
    """Stack cube A onto cube B. Action [8]: 7 joint torques, then the
    gripper (> 0 closes). Obs [27]: q, qd, the end effector, cube A, cube B,
    B − A, the grasped flag."""

    obs_dim = 7 + 7 + 3 + 3 + 3 + 3 + 1
    action_dim = 8
    max_episode_length = 300
    substeps = 2

    table_z = 0.0
    grasp_range = 0.05
    stack_tol = 0.02
    lift_height = 0.15
    # the elbow-up pose: these joints are set after the random offsets
    pose = ((1, -0.5), (3, -2.0), (5, 1.8))

    def __init__(self):
        super().__init__()
        self.model = franka_model()

    def _make_consts(self, device: torch.device):
        return None  # every constant of the step is a Python float

    def _ee_pos(self, q: torch.Tensor) -> torch.Tensor:
        """[E, 3] end effector: the last link's origin plus its rotation of ``_TIP``."""
        R_wb, p_wb, _, _ = _kin_s(self.model, _columns(q))
        return _stack(sa.v3_add(p_wb[6], sa.m33_vec(R_wb[6], list(_TIP))), q[:, 0])

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        u = torch.rand(num_envs, 11, generator=gen, device=gen.device)
        lo = torch.tensor([-0.1] * 7 + [0.25] * 2 + [-0.45] * 2, device=gen.device)
        return u * 0.2 + lo

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        E = draw.shape[0]
        q = draw[:, :7].clone()  # neutral_q is all zeros for a hinge chain
        for j, v in self.pose:
            q[:, j] = v
        z = lambda h: torch.full((E, 1), self.table_z + h, device=draw.device)  # noqa: E731
        return {
            "q": q,
            "qd": torch.zeros(E, self.model.nv, device=draw.device),
            "cube_a": torch.cat([draw[:, 7:9], z(CUBE_A_HALF)], -1),
            "cube_b": torch.cat([draw[:, 9:11], z(CUBE_B_HALF)], -1),
            "grasped": torch.zeros(E, device=draw.device),
        }

    def get_obs(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        ee = self._ee_pos(state["q"])
        return torch.cat([state["q"], state["qd"], ee, state["cube_a"], state["cube_b"],
                          state["cube_b"] - state["cube_a"], state["grasped"][:, None]], -1)

    def control_step(self, state, action):
        arm_action, grip = action[:, :7], action[:, 7]
        q, qd = physics_substeps(self.model, state["q"], state["qd"], arm_action, self.substeps, contact_fn=None)
        ee = self._ee_pos(q)
        cube_a0, cube_b = state["cube_a"], state["cube_b"]

        # grasp and release
        near_a = torch.linalg.vector_norm(ee - cube_a0, dim=-1) < self.grasp_range
        closed = grip > 0.0
        grasped = torch.where(state["grasped"] > 0.5, closed.float(), (near_a & closed).float())
        # an attached cube follows the end effector; a released one falls to the table
        held = torch.cat([ee[:, :2], ee[:, 2:] - CUBE_A_HALF], -1)
        dropped = torch.cat([cube_a0[:, :2], torch.clamp_min(cube_a0[:, 2:] - 0.02, self.table_z + CUBE_A_HALF)], -1)
        cube_a = torch.where(grasped[:, None] > 0.5, held, dropped)

        # staged shaping
        d_reach = torch.linalg.vector_norm(ee - cube_a0, dim=-1)
        stack_target = torch.cat([cube_b[:, :2], cube_b[:, 2:] + (CUBE_B_HALF + CUBE_A_HALF)], -1)
        d_align = torch.linalg.vector_norm(cube_a - stack_target, dim=-1)
        lifted = cube_a[:, 2] > self.table_z + self.lift_height
        is_grasped = grasped > 0.5
        stacked = (d_align < self.stack_tol) & ~is_grasped
        zero = torch.zeros_like(d_reach)
        reward = (
            (1.0 - torch.tanh(10.0 * d_reach))
            + torch.where(is_grasped, 0.5, zero)
            + torch.where(is_grasped & lifted, 0.5, zero)
            + torch.where(is_grasped, 1.0 - torch.tanh(5.0 * d_align), zero)
            + torch.where(stacked, 16.0, zero)
            - 0.0001 * torch.sum(torch.square(arm_action), -1)
        )
        bad = ~torch.isfinite(q).all(-1)
        next_state = {"q": q, "qd": qd, "cube_a": cube_a, "cube_b": cube_b, "grasped": grasped}
        return next_state, reward, stacked | bad, {"success": stacked.float()}
