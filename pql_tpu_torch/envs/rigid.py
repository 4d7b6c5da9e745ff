"""Rigid-body locomotion tasks on the ported engine (port of
pql_tpu/envs/rigid.py): Ant, Humanoid, Anymal.

Ant is the workhorse benchmark of the reference (IsaacGymEnvs 'Ant' at
4096 envs) — free-base torso, 4 legs × (hip yaw hinge + knee pitch hinge),
8 actuators, anchored ground contact (static friction + stable per-pair
gains, pql_tpu_torch.physics.contact) — with IGE-style observation/reward
shaping (forward progress + alive bonus − control cost, terminate on
fall). Humanoid and Anymal share the machinery.

Batched as the port's ``Task`` protocol (pql_tpu_torch.envs.base): every
state leaf is [E, ...]. ``draw_reset`` returns the random numbers the JAX
``init_state`` draws for each env; ``init_state`` maps them to
{"q", "qd", "contact"[, "cmd"]}. On a CUDA device a task's control step
(all substeps plus the reward) is one captured CUDA graph per (E, device)
(``envs/base.py::GraphedTask``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pql_tpu_torch.envs.base import GraphedTask
from pql_tpu_torch.physics import FREE, Geom, HINGE, RigidBodyModel
from pql_tpu_torch.physics.contact import SpherePairs, derive_pair, ground_anchored_v, ground_pairs, point_eff_mass
from pql_tpu_torch.physics.dynamics import physics_substeps
from pql_tpu_torch.physics.spatial import quat_rotate


@dataclass(frozen=True)
class _DeviceConsts:
    """A locomotion task's tensor constants on one device."""

    init_q: torch.Tensor  # [nq] the initial pose before the random hinge offsets
    ground: SpherePairs
    ez: torch.Tensor  # [3] world up
    ex: torch.Tensor  # [3] world forward
    cmd_scale: torch.Tensor  # [3] command ranges (Anymal's; zeros for the others)


class _RigidTask(GraphedTask):
    """What Ant, Humanoid and Anymal share: anchored ground contact for every
    geom, the reset draw and the per-device constants."""

    substeps = 4  # 240 Hz physics, 60 Hz control
    init_noise = 0.1  # half-width of the uniform hinge offsets at reset
    cmd_scale = (0.0, 0.0, 0.0)

    def __init__(self, model: RigidBodyModel):
        super().__init__()
        self.model = model
        m = model
        # anchored-contact gains: per-geom stable penalty pairs vs the ground
        self._pp_ground = [
            derive_pair(
                m, point_eff_mass(m, g.body, g.offset) if g.m_eff is None else g.m_eff
            )
            for g in m.geoms
        ]
        self.n_contact_pairs = len(m.geoms)

    def _init_q(self) -> np.ndarray:
        """[nq] float32 pose that ``init_state`` adds the hinge offsets to."""
        raise NotImplementedError

    def _make_consts(self, device: torch.device) -> _DeviceConsts:
        t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
        return _DeviceConsts(
            init_q=t(self._init_q()),
            ground=ground_pairs(self.model, self._pp_ground, device),
            ez=t([0.0, 0.0, 1.0]),
            ex=t([1.0, 0.0, 0.0]),
            cmd_scale=t(self.cmd_scale),
        )

    # ------------------------------------------------------------ resets

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """[E, nh + nv]: hinge offsets U(-init_noise, init_noise) for the nh
        hinge coordinates, then N(0, 1) per dof (× 0.01 in init_state)."""
        m = self.model
        u = torch.rand(num_envs, m.nq - 7, generator=gen, device=gen.device)
        n = torch.randn(num_envs, m.nv, generator=gen, device=gen.device)
        return torch.cat([u * (2.0 * self.init_noise) - self.init_noise, n], -1)

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        m, c = self.model, self._on(draw.device)
        E, nh = draw.shape[0], m.nq - 7
        q = torch.cat([c.init_q[:7].expand(E, 7), c.init_q[7:] + draw[:, :nh]], -1)
        qd = 0.01 * draw[:, nh : nh + m.nv]
        contact = torch.zeros(E, 4 * self.n_contact_pairs, device=draw.device)
        return {"q": q, "qd": qd, "contact": contact}

    # -------------------------------------------------------------- step

    def _substeps(self, state, action, c: _DeviceConsts):
        """All substeps of one control step → (q', qd', contact')."""

        def contact_fn(m, R_wb, p_wb, v, cs):
            cs_new = list(cs)
            f, _ = ground_anchored_v(m, R_wb, p_wb, v, cs, cs_new, 0, c.ground)
            return f, cs_new

        return physics_substeps(
            self.model, state["q"], state["qd"], action, self.substeps,
            contact_fn=contact_fn, contact_state=state["contact"],
        )


def ant_model(dt: float = 1.0 / 240.0) -> RigidBodyModel:
    """Quadruped: torso (free) + 4 × (thigh, shin). 9 bodies, nv = 14."""
    leg_angles = [np.pi / 4, 3 * np.pi / 4, 5 * np.pi / 4, 7 * np.pi / 4]
    torso_r = 0.25
    thigh_len, shin_len = 0.2, 0.4
    m_torso, m_thigh, m_shin = 10.0, 1.5, 1.0

    parent = [-1]
    joint_type = [FREE]
    joint_axis = [np.zeros(3)]
    tree_pos = [np.zeros(3)]
    mass = [m_torso]
    com = [np.zeros(3)]
    inertia = [0.4 * m_torso * torso_r**2 * np.eye(3)]
    geoms = [Geom(0, (0.0, 0.0, 0.0), torso_r)]

    def rod_inertia(m, length, axis_dir):
        """Thin-rod inertia about the joint end, axis along axis_dir."""
        i_perp = m * length**2 / 3.0
        eye = np.eye(3)
        d = axis_dir / np.linalg.norm(axis_dir)
        return i_perp * (eye - np.outer(d, d)) + 1e-4 * eye

    for k, phi in enumerate(leg_angles):
        d = np.array([np.cos(phi), np.sin(phi), 0.0])
        t = np.array([-np.sin(phi), np.cos(phi), 0.0])  # knee axis (tangent)
        thigh, shin = 1 + 2 * k, 2 + 2 * k
        # thigh: hip yaw hinge about z at the torso rim
        parent.append(0)
        joint_type.append(HINGE)
        joint_axis.append(np.array([0.0, 0.0, 1.0]))
        tree_pos.append(torso_r * d)
        mass.append(m_thigh)
        com.append(0.5 * thigh_len * d)
        inertia.append(rod_inertia(m_thigh, thigh_len, d))
        # shin: knee pitch hinge about the tangent; +angle bends the foot down
        parent.append(thigh)
        joint_type.append(HINGE)
        joint_axis.append(t)
        tree_pos.append(thigh_len * d)
        mass.append(m_shin)
        com.append(0.5 * shin_len * d)
        inertia.append(rod_inertia(m_shin, shin_len, d))
        # m_eff: apparent foot mass for the perpendicular (contact-relevant)
        # rotation mode — 1/(1/m + |ρ|²/i_perp) with i_perp = m·l²/3; the
        # generic worst-direction point_eff_mass degenerates on thin rods
        # (λ_min is the regularized about-axis inertia, whose rotation
        # never moves an on-axis contact point)
        geoms.append(Geom(shin, tuple(shin_len * d), 0.08, m_eff=0.5))  # foot

    nv = 6 + 8
    limit_lo = np.full(nv, -np.inf, np.float32)
    limit_hi = np.full(nv, np.inf, np.float32)
    for k in range(4):
        hip_dof, knee_dof = 6 + 2 * k, 7 + 2 * k
        limit_lo[hip_dof], limit_hi[hip_dof] = -0.7, 0.7
        limit_lo[knee_dof], limit_hi[knee_dof] = 0.35, 1.6

    damping = np.zeros(nv, np.float32)
    damping[6:] = 1.0
    armature = np.zeros(nv, np.float32)
    armature[6:] = 0.05

    return RigidBodyModel(
        nb=9,
        parent=tuple(parent),
        joint_type=tuple(joint_type),
        joint_axis=np.asarray(joint_axis, np.float32),
        tree_pos=np.asarray(tree_pos, np.float32),
        mass=np.asarray(mass, np.float32),
        com=np.asarray(com, np.float32),
        inertia=np.asarray(inertia, np.float32),
        damping=damping,
        armature=armature,
        actuated_dofs=tuple(range(6, 14)),
        gear=np.full(8, 15.0, np.float32),
        limit_lo=limit_lo,
        limit_hi=limit_hi,
        limit_stiffness=40.0,
        geoms=tuple(geoms),
        dt=dt,
        contact_kp=2.0e4,
        contact_kd=120.0,
        friction_mu=1.0,
        contact_force_cap=2000.0,
        max_dof_speed=60.0,
    )


class Ant(_RigidTask):
    """Forward-locomotion quadruped (IGE 'Ant' analog).

    Reward composition mirrors IsaacGymEnvs ant.py compute_ant_reward:
    progress (forward velocity) + alive 0.5 + heading alignment (0.5,
    scaled below a 0.8 projection) + upright bonus (0.1 above 0.93)
    − action cost 0.005·Σa² − electricity 0.05·Σ|a·q̇|/20 − death penalty."""

    obs_dim = 34  # 1 height + 4 quat + 3 lin vel + 3 ang vel + 3 up + 8 q + 8 qd + 4 feet
    action_dim = 8
    max_episode_length = 1000

    alive_bonus = 0.5
    ctrl_cost = 0.005
    heading_weight = 0.5
    up_weight = 0.1
    energy_cost = 0.05
    termination_height = 0.22
    init_height = 0.42
    init_knee = 1.0

    def __init__(self):
        super().__init__(ant_model())

    def _init_q(self):
        q = self.model.neutral_q()
        q[2] = self.init_height
        # hinge q layout: [7 + 2k] hip, [8 + 2k] knee
        q[8::2] = self.init_knee
        return q

    def get_obs(self, state):
        q, qd = state["q"], state["qd"]
        base_quat = q[:, 3:7]
        up = quat_rotate(base_quat, self._on(q.device).ez)
        lin_vel_world = quat_rotate(base_quat, qd[:, 3:6])
        # feet flags from the CARRIED anchored-contact engaged bits (pair
        # layout: 4 scalars/pair, flag at +3; geom 0 is the torso)
        feet_contact = state["contact"][:, 4 + 3 :: 4]
        return torch.cat(
            [
                q[:, 2:3],  # height
                base_quat,  # orientation
                lin_vel_world,  # world lin vel
                qd[:, :3],  # body ang vel
                up,  # up-projection vector
                q[:, 7:],  # 8 joint angles
                qd[:, 6:],  # 8 joint velocities
                feet_contact,  # 4
            ],
            -1,
        )

    def control_step(self, state, action):
        m, c = self.model, self._on(action.device)
        x_before = state["q"][:, 0]
        q, qd, contact = self._substeps(state, action, c)

        dt_ctrl = m.dt * self.substeps
        forward_vel = (q[:, 0] - x_before) / dt_ctrl
        up_proj = quat_rotate(q[:, 3:7], c.ez)[:, 2]
        # heading/up bonuses + electricity cost per IGE ant.py
        heading_proj = quat_rotate(q[:, 3:7], c.ex)[:, 0]
        heading_reward = self.heading_weight * torch.clamp(heading_proj / 0.8, 0.0, 1.0)
        up_reward = torch.where(up_proj > 0.93, self.up_weight, 0.0)
        electricity = self.energy_cost * torch.sum(
            torch.abs(torch.clamp(action, -1.0, 1.0) * qd[:, 6:]), -1
        ) / 20.0  # IGE scales dof velocities into ~[-1,1]; 20 rad/s here
        reward = (
            forward_vel
            + self.alive_bonus
            + heading_reward
            + up_reward
            - self.ctrl_cost * torch.sum(torch.square(action), -1)
            - electricity
        )
        fell = (q[:, 2] < self.termination_height) | (up_proj < 0.3)
        bad = ~torch.isfinite(q).all(-1)
        terminated = fell | bad
        reward = torch.where(terminated, reward - 1.0, reward)
        return {"q": q, "qd": qd, "contact": contact}, reward, terminated, {}


def humanoid_model(dt: float = 1.0 / 240.0) -> RigidBodyModel:
    """Biped: torso (free) + 2 legs × (hip pitch, knee pitch) + 2 arms ×
    (shoulder pitch, elbow pitch). 9 bodies, nv = 14, 8 actuators —
    the structural analog of IGE 'Humanoid' (21 DOF) at the fidelity of
    the in-repo engine."""
    torso_h = 0.28
    m_torso = 35.0
    thigh_len, shin_len = 0.35, 0.35
    arm_len, fore_len = 0.25, 0.25
    m_thigh, m_shin, m_arm, m_fore = 4.5, 2.5, 1.5, 1.0

    parent = [-1]
    joint_type = [FREE]
    joint_axis = [np.zeros(3)]
    tree_pos = [np.zeros(3)]
    mass = [m_torso]
    com = [np.zeros(3)]
    inertia = [np.diag([m_torso * 0.05, m_torso * 0.05, m_torso * 0.02])]
    geoms = [Geom(0, (0.0, 0.0, 0.0), torso_h * 0.5), Geom(0, (0.0, 0.0, 0.25), 0.11)]

    def rod_inertia(m, length, axis_dir):
        i_perp = m * length**2 / 3.0
        eye = np.eye(3)
        d = axis_dir / np.linalg.norm(axis_dir)
        return i_perp * (eye - np.outer(d, d)) + 1e-4 * eye

    down = np.array([0.0, 0.0, -1.0])
    pitch = np.array([0.0, 1.0, 0.0])
    # legs at hips (±y), arms at shoulders (±y, higher)
    for side, y in (("r", -0.1), ("l", 0.1)):
        thigh = len(parent)
        parent.append(0)
        joint_type.append(HINGE)
        joint_axis.append(pitch)
        tree_pos.append(np.array([0.0, y, -torso_h]))
        mass.append(m_thigh)
        com.append(0.5 * thigh_len * down)
        inertia.append(rod_inertia(m_thigh, thigh_len, down))
        # explicit m_eff: perpendicular-mode apparent mass (see ant_model)
        geoms.append(Geom(thigh, (0.0, 0.0, -thigh_len), 0.05, m_eff=2.5))
        shin = len(parent)
        parent.append(thigh)
        joint_type.append(HINGE)
        joint_axis.append(pitch)
        tree_pos.append(thigh_len * down)
        mass.append(m_shin)
        com.append(0.5 * shin_len * down)
        inertia.append(rod_inertia(m_shin, shin_len, down))
        geoms.append(Geom(shin, (0.0, 0.0, -shin_len), 0.06, m_eff=1.4))  # foot
    for side, y in (("r", -0.2), ("l", 0.2)):
        arm = len(parent)
        parent.append(0)
        joint_type.append(HINGE)
        joint_axis.append(pitch)
        tree_pos.append(np.array([0.0, y, 0.22]))
        mass.append(m_arm)
        com.append(0.5 * arm_len * down)
        inertia.append(rod_inertia(m_arm, arm_len, down))
        fore = len(parent)
        parent.append(arm)
        joint_type.append(HINGE)
        joint_axis.append(pitch)
        tree_pos.append(arm_len * down)
        mass.append(m_fore)
        com.append(0.5 * fore_len * down)
        inertia.append(rod_inertia(m_fore, fore_len, down))

    nv = 6 + 8
    limit_lo = np.full(nv, -np.inf, np.float32)
    limit_hi = np.full(nv, np.inf, np.float32)
    # hips, knees, shoulders, elbows
    for dof, (lo, hi) in zip(
        range(6, 14),
        [(-1.2, 1.2), (0.0, 2.4)] * 2 + [(-2.0, 2.0), (0.0, 2.4)] * 2,
    ):
        limit_lo[dof], limit_hi[dof] = lo, hi
    damping = np.zeros(nv, np.float32)
    damping[6:] = 2.0
    armature = np.zeros(nv, np.float32)
    armature[6:] = 0.05

    return RigidBodyModel(
        nb=len(parent),
        parent=tuple(parent),
        joint_type=tuple(joint_type),
        joint_axis=np.asarray(joint_axis, np.float32),
        tree_pos=np.asarray(tree_pos, np.float32),
        mass=np.asarray(mass, np.float32),
        com=np.asarray(com, np.float32),
        inertia=np.asarray(inertia, np.float32),
        damping=damping,
        armature=armature,
        actuated_dofs=tuple(range(6, 14)),
        gear=np.array([120, 100, 120, 100, 40, 30, 40, 30], np.float32),
        limit_lo=limit_lo,
        limit_hi=limit_hi,
        limit_stiffness=40.0,
        geoms=tuple(geoms),
        dt=dt,
        contact_kp=1.2e4,
        contact_kd=150.0,
        friction_mu=1.0,
        contact_force_cap=2000.0,
        max_dof_speed=30.0,
    )


class Humanoid(_RigidTask):
    """Forward-locomotion biped (IGE 'Humanoid' analog: forward progress
    + alive bonus − control cost, terminate on fall)."""

    obs_dim = 1 + 4 + 3 + 3 + 3 + 8 + 8 + 2  # = 32
    action_dim = 8
    max_episode_length = 1000
    init_noise = 0.05

    alive_bonus = 2.0
    ctrl_cost = 0.01
    termination_height = 0.7
    init_height = 1.05

    def __init__(self):
        super().__init__(humanoid_model())

    def _init_q(self):
        q = self.model.neutral_q()
        q[2] = self.init_height
        return q

    def get_obs(self, state):
        q, qd = state["q"], state["qd"]
        base_quat = q[:, 3:7]
        up = quat_rotate(base_quat, self._on(q.device).ez)
        lin_vel_world = quat_rotate(base_quat, qd[:, 3:6])
        # engaged bits of the carried anchored state for the foot geoms
        # (shin-end spheres, geom ids 3 and 5) — see Ant.get_obs
        feet = torch.stack([state["contact"][:, 4 * 3 + 3], state["contact"][:, 4 * 5 + 3]], -1)
        return torch.cat(
            [q[:, 2:3], base_quat, lin_vel_world, qd[:, :3], up, q[:, 7:], qd[:, 6:], feet], -1
        )

    def control_step(self, state, action):
        m, c = self.model, self._on(action.device)
        x_before = state["q"][:, 0]
        q, qd, contact = self._substeps(state, action, c)
        dt_ctrl = m.dt * self.substeps
        forward_vel = (q[:, 0] - x_before) / dt_ctrl
        up_proj = quat_rotate(q[:, 3:7], c.ez)[:, 2]
        reward = (
            forward_vel + self.alive_bonus - self.ctrl_cost * torch.sum(torch.square(action), -1)
        )
        fell = (q[:, 2] < self.termination_height) | (up_proj < 0.5)
        bad = ~torch.isfinite(q).all(-1)
        terminated = fell | bad
        reward = torch.where(terminated, reward - 1.0, reward)
        return {"q": q, "qd": qd, "contact": contact}, reward, terminated, {}


def anymal_model(dt: float = 1.0 / 240.0) -> RigidBodyModel:
    """Quadruped with 3 hinges per leg (hip abduction, hip flexion, knee)
    — the IGE 'Anymal' morphology. 13 bodies, nv = 18, 12 actuators."""
    body_len, body_wid = 0.53, 0.3
    m_base = 16.0
    hip_len, thigh_len, shin_len = 0.08, 0.25, 0.32
    m_hip, m_thigh, m_shin = 1.4, 1.1, 0.3

    parent = [-1]
    joint_type = [FREE]
    joint_axis = [np.zeros(3)]
    tree_pos = [np.zeros(3)]
    mass = [m_base]
    com = [np.zeros(3)]
    inertia = [np.diag([0.25, 0.7, 0.8])]
    geoms = [Geom(0, (0.0, 0.0, 0.0), 0.12)]

    def rod_inertia(m, length, axis_dir):
        i_perp = m * length**2 / 3.0
        eye = np.eye(3)
        d = axis_dir / np.linalg.norm(axis_dir)
        return i_perp * (eye - np.outer(d, d)) + 1e-4 * eye

    down = np.array([0.0, 0.0, -1.0])
    roll = np.array([1.0, 0.0, 0.0])
    pitch = np.array([0.0, 1.0, 0.0])
    for sx in (1.0, -1.0):
        for sy in (1.0, -1.0):
            hip = len(parent)
            parent.append(0)
            joint_type.append(HINGE)
            joint_axis.append(roll)  # abduction
            tree_pos.append(np.array([sx * body_len / 2, sy * body_wid / 2, 0.0]))
            mass.append(m_hip)
            out = np.array([0.0, sy, 0.0])
            com.append(0.5 * hip_len * out)
            inertia.append(rod_inertia(m_hip, hip_len, out))
            thigh = len(parent)
            parent.append(hip)
            joint_type.append(HINGE)
            joint_axis.append(pitch)  # hip flexion
            tree_pos.append(hip_len * out)
            mass.append(m_thigh)
            com.append(0.5 * thigh_len * down)
            inertia.append(rod_inertia(m_thigh, thigh_len, down))
            shin = len(parent)
            parent.append(thigh)
            joint_type.append(HINGE)
            joint_axis.append(pitch)  # knee
            tree_pos.append(thigh_len * down)
            mass.append(m_shin)
            com.append(0.5 * shin_len * down)
            inertia.append(rod_inertia(m_shin, shin_len, down))
            # explicit m_eff: perpendicular-mode apparent mass (see ant_model)
            geoms.append(Geom(shin, (0.0, 0.0, -shin_len), 0.03, m_eff=0.15))

    nv = 6 + 12
    limit_lo = np.full(nv, -np.inf, np.float32)
    limit_hi = np.full(nv, np.inf, np.float32)
    for leg in range(4):
        b = 6 + 3 * leg
        limit_lo[b], limit_hi[b] = -0.6, 0.6  # abduction
        limit_lo[b + 1], limit_hi[b + 1] = -1.2, 1.2  # flexion
        limit_lo[b + 2], limit_hi[b + 2] = -2.4, -0.2  # knee (bent back)
    damping = np.zeros(nv, np.float32)
    damping[6:] = 1.0
    armature = np.zeros(nv, np.float32)
    armature[6:] = 0.04

    return RigidBodyModel(
        nb=len(parent),
        parent=tuple(parent),
        joint_type=tuple(joint_type),
        joint_axis=np.asarray(joint_axis, np.float32),
        tree_pos=np.asarray(tree_pos, np.float32),
        mass=np.asarray(mass, np.float32),
        com=np.asarray(com, np.float32),
        inertia=np.asarray(inertia, np.float32),
        damping=damping,
        armature=armature,
        actuated_dofs=tuple(range(6, 18)),
        gear=np.full(12, 40.0, np.float32),
        limit_lo=limit_lo,
        limit_hi=limit_hi,
        limit_stiffness=40.0,
        geoms=tuple(geoms),
        dt=dt,
        contact_kp=8.0e3,
        contact_kd=120.0,
        friction_mu=1.0,
        contact_force_cap=1200.0,
        max_dof_speed=25.0,
    )


class Anymal(_RigidTask):
    """Commanded-velocity quadruped (IGE 'Anymal' analog): track a random
    base velocity command (v_x, v_y, yaw rate), the reward shape of the
    IsaacGymEnvs task; command kept in the state and exposed in the obs."""

    obs_dim = 1 + 4 + 3 + 3 + 3 + 12 + 12 + 3  # = 41
    action_dim = 12
    max_episode_length = 1000
    init_noise = 0.05

    ctrl_cost = 0.0025
    termination_height = 0.28
    init_height = 0.56
    init_knee = -1.2
    lin_vel_scale = 2.0
    ang_vel_scale = 1.0
    cmd_scale = (lin_vel_scale, 0.5, ang_vel_scale)

    def __init__(self):
        super().__init__(anymal_model())

    def _init_q(self):
        q = self.model.neutral_q()
        q[2] = self.init_height
        for leg in range(4):
            q[7 + 3 * leg + 1] = 0.6
            q[7 + 3 * leg + 2] = self.init_knee
        return q

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """[E, 12 + 18 + 3]: the hinge offsets and dof normals of
        ``_RigidTask.draw_reset``, then the command draw U(-1, 1)."""
        cmd = torch.rand(num_envs, 3, generator=gen, device=gen.device) * 2.0 - 1.0
        return torch.cat([super().draw_reset(gen, num_envs), cmd], -1)

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        state = super().init_state(draw[:, :-3])
        state["cmd"] = draw[:, -3:] * self._on(draw.device).cmd_scale
        return state

    def get_obs(self, state):
        q, qd = state["q"], state["qd"]
        base_quat = q[:, 3:7]
        up = quat_rotate(base_quat, self._on(q.device).ez)
        lin_vel_world = quat_rotate(base_quat, qd[:, 3:6])
        return torch.cat(
            [q[:, 2:3], base_quat, lin_vel_world, qd[:, :3], up, q[:, 7:], qd[:, 6:], state["cmd"]], -1
        )

    def control_step(self, state, action):
        c = self._on(action.device)
        q, qd, contact = self._substeps(state, action, c)
        lin_vel_world = quat_rotate(q[:, 3:7], qd[:, 3:6])
        cmd = state["cmd"]
        lin_err = torch.sum(torch.square(lin_vel_world[:, :2] - cmd[:, :2]), -1)
        yaw_err = torch.square(qd[:, 2] - cmd[:, 2])
        reward = (
            torch.exp(-lin_err / 0.25)
            + 0.5 * torch.exp(-yaw_err / 0.25)
            - self.ctrl_cost * torch.sum(torch.square(action), -1)
        )
        up_proj = quat_rotate(q[:, 3:7], c.ez)[:, 2]
        fell = (q[:, 2] < self.termination_height) | (up_proj < 0.3)
        bad = ~torch.isfinite(q).all(-1)
        terminated = fell | bad
        reward = torch.where(terminated, reward - 1.0, reward)
        return (
            {"q": q, "qd": qd, "cmd": cmd, "contact": contact},
            reward,
            terminated,
            {},
        )
