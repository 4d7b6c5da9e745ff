"""In-hand cube reorientation on the ported engine (port of
pql_tpu/envs/hand.py): AllegroHand and ShadowHand.

The analog of IsaacGymEnvs 'AllegroHand' (the reference's flagship
benchmark): a hand of 4 fingers × (1 abduction + 3 curl) position-driven
hinges, anchored at the palm rim, must turn a free cube to a target
orientation. Reward ∝ 1/(rot_dist + ε), a bonus and goal re-sampling at
rot_dist < threshold, termination when the cube falls out of the
workspace. Contacts are the anchored groups of
pql_tpu_torch.physics.contact: finger spheres vs the palm plane, finger
spheres vs the cube (box-frame anchors, equal and opposite wrenches), and
the cube's corners vs the palm plane (or, with ``palm = "bowl"``, vs a
spherical bowl). ShadowHand is the five-finger variant.

Batched as the port's ``Task`` protocol (pql_tpu_torch.envs.base). The
hand draws inside its dynamics (a new goal where the old one was reached),
so it has ``draw_step``: 3 uniforms per env per step, the numbers the JAX
``_rand_quat(rng)`` draws from the env's dynamics key. ``draw_reset``
returns the numbers the JAX ``init_state`` draws. On a CUDA device the
whole control step (8 substeps, reward, success, fall check, goal
re-sampling) is one launch of the hand-written kernel
``pql_tpu_torch/csrc/hand_step.cu``, one thread per env
(``pql_tpu_torch.ops.kernels.hand_control_step``); its substep and the
step's end are generated from this module's own algebra, traced once on
symbolic columns (``kernel_programs``, ``pql_tpu_torch.physics.codegen``).
The bowl palm, whose contact group has no per-pair scalar form, keeps the
captured CUDA graph per (E, device) (pql_tpu_torch.envs.base.GraphedTask).
The CPU runs the step eagerly.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from pql_tpu_torch.envs.base import GraphedTask
from pql_tpu_torch.ops import kernels
from pql_tpu_torch.physics import FREE, Geom, HINGE, RigidBodyModel, codegen
from pql_tpu_torch.physics import scalar_algebra as sa
from pql_tpu_torch.physics.contact import (
    PairParams,
    SpherePairs,
    add_fext_s,
    bowl_anchored_v,
    box_corners,
    box_ground_anchored_s,
    box_ground_anchored_v,
    derive_pair,
    ground_anchored_s,
    ground_anchored_v,
    ground_pairs,
    point_eff_mass,
    sphere_box_anchored_s,
    sphere_box_anchored_v,
    sphere_box_pairs,
)
from pql_tpu_torch.physics.dynamics import _step_parts, physics_substeps
from pql_tpu_torch.physics.spatial import quat_inv, quat_mul

CUBE_HALF = 0.035
N_FINGERS = 4
LINKS_PER_FINGER = 4
LINK_LEN = 0.05
FINGER_BASE_R = 0.11
FINGER_BASE_Z = 0.035


def hand_model(
    dt: float = 1.0 / 480.0,
    n_fingers: int = N_FINGERS,
    control_mode: str = "position",
) -> RigidBodyModel:
    """n_fingers × (1 abduction + 3 curl) hinges anchored at the palm rim
    + a free cube — the real Allegro DOF layout (4 DOF/finger, of which
    the proximal joint swings the finger sideways).

    Bodies 0..n_dof-1: finger links (parent chains anchored at the palm
    rim, pointing inward; link 0's hinge axis is the palm normal
    [abduction], links 1-3 curl about the rim tangent); last body: the
    cube. 4 fingers = the Allegro hand; 5 = the Shadow-hand analog.
    """
    parent, joint_type, joint_axis, tree_pos = [], [], [], []
    mass, com, inertia, geoms = [], [], [], []

    m_link = 0.06
    z = np.array([0.0, 0.0, 1.0])  # palm normal = abduction axis
    for f in range(n_fingers):
        phi = np.pi / 4 + f * 2 * np.pi / n_fingers  # rim anchors
        d = np.array([np.cos(phi), np.sin(phi), 0.0])  # outward
        t = np.array([-np.sin(phi), np.cos(phi), 0.0])  # curl axis
        for l in range(LINKS_PER_FINGER):  # noqa: E741
            body = f * LINKS_PER_FINGER + l
            parent.append(-1 if l == 0 else body - 1)
            joint_type.append(HINGE)
            joint_axis.append(z if l == 0 else t)
            tree_pos.append(
                np.array([*(FINGER_BASE_R * d[:2]), FINGER_BASE_Z])
                if l == 0
                else -LINK_LEN * d
            )
            mass.append(m_link)
            com.append(-0.5 * LINK_LEN * d)
            i_perp = m_link * LINK_LEN**2 / 3.0
            eye = np.eye(3)
            inertia.append(i_perp * (eye - np.outer(d, d)) + 1e-6 * eye)
            # m_eff: apparent mass of the finger chain at this link's tip
            # (link inertia + reflected motor armature through the chain)
            geoms.append(Geom(body, tuple(-LINK_LEN * d), 0.016, m_eff=0.1))

    # the cube (last body)
    m_cube = 0.1
    parent.append(-1)
    joint_type.append(FREE)
    joint_axis.append(np.zeros(3))
    tree_pos.append(np.zeros(3))
    mass.append(m_cube)
    com.append(np.zeros(3))
    inertia.append((m_cube / 6.0) * (2 * CUBE_HALF) ** 2 * np.eye(3))

    n_dof = n_fingers * LINKS_PER_FINGER
    nv = n_dof + 6
    limit_lo = np.full(nv, -np.inf, np.float32)
    limit_hi = np.full(nv, np.inf, np.float32)
    for dof in range(n_dof):
        if dof % LINKS_PER_FINGER == 0:
            limit_lo[dof], limit_hi[dof] = -0.47, 0.47  # abduction (Allegro joint-0 spec)
        else:
            # curl: hyperextension to -0.6 so a retracting finger lifts clear
            # of the cube (the regrasp half of finger gaiting)
            limit_lo[dof], limit_hi[dof] = -0.6, 1.6
    damping = np.zeros(nv, np.float32)
    damping[:n_dof] = 0.08
    # reflected motor inertia of the gearmotors: the apparent fingertip mass
    armature = np.zeros(nv, np.float32)
    armature[:n_dof] = 0.01

    return RigidBodyModel(
        nb=n_dof + 1,
        parent=tuple(parent),
        joint_type=tuple(joint_type),
        joint_axis=np.asarray(joint_axis, np.float32),
        tree_pos=np.asarray(tree_pos, np.float32),
        mass=np.asarray(mass, np.float32),
        com=np.asarray(com, np.float32),
        inertia=np.asarray(inertia, np.float32),
        damping=damping,
        armature=armature,
        actuated_dofs=tuple(range(n_dof)),
        gear=np.full(n_dof, 0.6, np.float32),
        limit_lo=limit_lo,
        limit_hi=limit_hi,
        limit_stiffness=5.0,
        geoms=tuple(geoms),
        dt=dt,
        contact_kp=3.0e3,
        contact_kd=20.0,
        friction_mu=1.2,
        contact_force_cap=80.0,
        max_dof_speed=30.0,
        # IGE AllegroHand drives joints in POSITION mode (stiffness 3.0,
        # damping 0.1): policies command target angles, the engine-side PD
        # holds them
        control_mode=control_mode,
        act_kp=3.0,
        act_kd=0.1,
    )


def _rand_quat_s(u1, u2, u3) -> list:
    """Shoemake's uniform unit quaternion [w, x, y, z] from three U[0, 1)
    columns."""
    a, b = torch.sqrt(1.0 - u1), torch.sqrt(u1)
    t2, t3 = (2 * math.pi) * u2, (2 * math.pi) * u3
    return [a * torch.sin(t2), a * torch.cos(t2), b * torch.sin(t3), b * torch.cos(t3)]


def _rand_quat(u: torch.Tensor) -> torch.Tensor:
    """Uniform random unit quaternions (Shoemake) from u [..., 3] ~ U[0, 1)."""
    return torch.stack(_rand_quat_s(*u.unbind(-1)), -1)


def rot_dist(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle of the relative rotation between unit quats [..., 4]."""
    qd = quat_mul(q1, quat_inv(q2))
    return 2.0 * torch.arcsin(torch.clamp(torch.linalg.vector_norm(qd[..., 1:], dim=-1), 0.0, 1.0))


@dataclass(frozen=True)
class _HandConsts:
    """The hand's tensor constants on one device."""

    finger_q0: torch.Tensor  # [n_dof] the finger pose before the random offsets
    cube_q0: torch.Tensor  # [3] the cube's initial position
    rest: torch.Tensor  # [3] the cube's rest position (fall check)
    ground: SpherePairs  # finger spheres vs the palm plane
    cube: SpherePairs  # finger spheres vs the cube
    corners: torch.Tensor  # [8, 3] the cube's corners in its frame


class AllegroHand(GraphedTask):
    """In-hand cube reorientation (IGE 'AllegroHand' analog)."""

    n_fingers = N_FINGERS
    n_dof = N_FINGERS * LINKS_PER_FINGER
    obs_dim = 16 + 16 + 3 + 4 + 3 + 3 + 4 + 4  # = 53
    action_dim = 16
    max_episode_length = 600
    substeps = 8  # 480 Hz physics, 60 Hz control
    finger_noise = 0.1  # half-width of the uniform finger offsets at reset

    # reward constants per IsaacGymEnvs AllegroHand (successTolerance 0.1,
    # reachGoalBonus 250, fallDistance 0.24, fallPenalty 0, rotEps 0.1,
    # actionPenaltyScale 0.0002)
    success_tolerance = 0.1
    reach_goal_bonus = 250.0
    fall_penalty = 0.0
    fall_dist = 0.24
    rot_eps = 0.1
    action_penalty = 0.0002

    control_mode = "position"

    # palm geometry: "flat" (the default) or "bowl", a shallow spherical
    # concavity that cradles the cube (experimental in the JAX package)
    palm = "flat"
    bowl_radius = 0.09

    def __init__(self):
        super().__init__()
        self.model = hand_model(n_fingers=self.n_fingers, control_mode=self.control_mode)
        self.cube = self.n_fingers * LINKS_PER_FINGER
        self.cube_q = self.model.q_start[self.cube]
        self.cube_v = self.model.v_start[self.cube]
        m = self.model
        # anchored-contact pair gains: finger-link spheres vs the palm,
        # finger spheres vs the cube (2 fingers typically share the
        # squeeze), cube corners vs the palm (4 share the weight)
        m_cube_face = point_eff_mass(m, self.cube, (CUBE_HALF, 0.0, 0.0))
        m_corner = point_eff_mass(m, self.cube, (CUBE_HALF, CUBE_HALF, CUBE_HALF))
        self._pp_ground = [
            derive_pair(m, point_eff_mass(m, g.body, g.offset) if g.m_eff is None else g.m_eff)
            for g in m.geoms
        ]
        # finger-cube pairs: full-stiffness springs, tangential damping ×0.25
        # (at the derived bound the cube's rotational mode chatters)
        pp_cube = [
            derive_pair(m, 1.0 / (1.0 / (0.1 if g.m_eff is None else g.m_eff) + 1.0 / m_cube_face), n_share=2)
            for g in m.geoms
        ]
        self._pp_cube = [
            PairParams(kp=p.kp, kd=p.kd, mu=p.mu, cap=p.cap, kpt=p.kpt, kdt=0.25 * p.kdt) for p in pp_cube
        ]
        self._pp_corner = derive_pair(m, m_corner, n_share=4)
        self.n_contact_pairs = 2 * len(m.geoms) + 8
        # bowl palm: centre height so the cube's rest pose (bottom corners on
        # the shell) sits as on the flat palm; gains with n_share=8, since
        # opposing corners' inward normals converge
        self._pp_bowl = derive_pair(m, m_corner, n_share=8)
        self._bowl_center = (0.0, 0.0, float(np.sqrt(self.bowl_radius**2 - 2.0 * CUBE_HALF**2)))

    def _make_consts(self, device: torch.device) -> _HandConsts:
        if device.type == "cuda" and self.palm == "flat":
            kernels.prebuild("hand_step", kernels.hand_step_header(self))  # the build overlaps the rest of the set-up
        is_abduct = np.arange(self.n_dof) % LINKS_PER_FINGER == 0
        t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
        return _HandConsts(
            finger_q0=t(np.where(is_abduct, 0.0, 0.2)),  # fingers slightly curled, abduction centred
            cube_q0=t([0.0, 0.0, CUBE_HALF + 0.002]),  # resting above the palm centre
            rest=t([0.0, 0.0, CUBE_HALF]),
            ground=ground_pairs(self.model, self._pp_ground, device),
            cube=sphere_box_pairs(self.model, self.cube, self._pp_cube, device),
            corners=box_corners([CUBE_HALF] * 3, device),
        )

    # ------------------------------------------------------------ draws

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """[E, n_dof + 6]: finger offsets U(-0.1, 0.1), then 3 + 3 uniforms
        U[0, 1) for the cube's and the target's random quaternions."""
        u = torch.rand(num_envs, self.n_dof + 6, generator=gen, device=gen.device)
        return torch.cat([u[:, : self.n_dof] * (2.0 * self.finger_noise) - self.finger_noise, u[:, self.n_dof :]], -1)

    def draw_step(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """[E, 3] uniforms U[0, 1): the quaternion of a new goal, taken where
        the current one is reached."""
        return torch.rand(num_envs, 3, generator=gen, device=gen.device)

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        c, E, n = self._on(draw.device), draw.shape[0], self.n_dof
        q = torch.cat(
            [c.finger_q0 + draw[:, :n], c.cube_q0.expand(E, 3), _rand_quat(draw[:, n : n + 3])], -1
        )
        return {
            "q": q,
            "qd": torch.zeros(E, self.model.nv, device=draw.device),
            "target": _rand_quat(draw[:, n + 3 : n + 6]),
            # anchored-contact state: anchor xyz + engaged per pair; engaged = 0
            # snaps the anchors on first touch
            "contact": torch.zeros(E, 4 * self.n_contact_pairs, device=draw.device),
        }

    # -------------------------------------------------------------- step

    def _cube_pose(self, q):
        return q[:, self.cube_q : self.cube_q + 3], q[:, self.cube_q + 3 : self.cube_q + 7]

    def get_obs(self, state):
        q, qd = state["q"], state["qd"]
        pos, quat = self._cube_pose(q)
        qdiff = quat_mul(quat, quat_inv(state["target"]))
        return torch.cat(
            [
                q[:, : self.n_dof],
                qd[:, : self.n_dof],
                pos,
                quat,
                qd[:, self.cube_v + 3 : self.cube_v + 6],  # cube lin vel (body)
                qd[:, self.cube_v : self.cube_v + 3],  # cube ang vel (body)
                state["target"],
                qdiff,
            ],
            -1,
        )

    def _contact_fn(self, c: _HandConsts):
        """The stateful contact function of one substep: finger spheres vs
        the palm, vs the cube, then the cube's corners vs the palm (plane or
        bowl), in that order of pair slots."""
        half = [CUBE_HALF] * 3

        def contact_fn(m, R_wb, p_wb, v, cs):
            cs_new = list(cs)
            f1, idx = ground_anchored_v(m, R_wb, p_wb, v, cs, cs_new, 0, c.ground)
            f2, idx = sphere_box_anchored_v(m, R_wb, p_wb, v, self.cube, half, cs, cs_new, idx, c.cube)
            if self.palm == "bowl":
                f3, _ = bowl_anchored_v(m, R_wb, p_wb, v, self.cube, c.corners, self._bowl_center,
                                        self.bowl_radius, cs, cs_new, idx, self._pp_bowl)
            else:
                f3, _ = box_ground_anchored_v(m, R_wb, p_wb, v, self.cube, c.corners, cs, cs_new, idx,
                                              self._pp_corner)
            return add_fext_s(f1, f2, f3), cs_new

        return contact_fn

    def control_step(self, state, action, draw):
        """One control step, eagerly; ``draw`` [E, 3] is the ``draw_step``
        draw for the goals re-sampled on success."""
        c = self._on(action.device)
        q, qd, contact = physics_substeps(
            self.model, state["q"], state["qd"], action, self.substeps,
            contact_fn=self._contact_fn(c), contact_state=state["contact"],
        )
        pos, quat = self._cube_pose(q)
        dist = rot_dist(quat, state["target"])
        success = dist < self.success_tolerance
        # IGE-style fall check: the cube strays from the palm workspace
        fallen = torch.linalg.vector_norm(pos - c.rest, dim=-1) > self.fall_dist
        reward = (
            torch.reciprocal(dist + self.rot_eps)
            - self.action_penalty * torch.sum(torch.square(action), -1)
            + torch.where(success, self.reach_goal_bonus, 0.0)
            + torch.where(fallen, self.fall_penalty, 0.0)
        )
        # goal re-sampling on success (IGE keeps the episode running)
        new_target = torch.where(success[:, None], _rand_quat(draw), state["target"])
        bad = ~torch.isfinite(q).all(-1)
        terminated = fallen | bad
        next_state = {"q": q, "qd": qd, "target": new_target, "contact": contact}
        return next_state, reward, terminated, {"success": success.float()}

    def dynamics(self, state, action, *draw):
        """``control_step``: eagerly on the CPU; on a CUDA device one launch
        of the fused step kernel, or, with the bowl palm, the captured graph."""
        if self.palm == "bowl":
            return super().dynamics(state, action, *draw)
        return kernels.hand_control_step(self, state, action, *draw)

    # ------------------------------------------------- the fused kernel's program

    def _contact_fn_s(self):
        """The flat palm's contact function of one substep in its per-pair
        form: the anchored loops with each pair's gains as Python floats, in
        ``_contact_fn``'s order of pair slots. The kernel's substep is traced
        from it (tests/test_torch_legacy_contact.py holds each loop to its
        vectorized group)."""
        if self.palm != "flat":
            raise ValueError(f"the per-pair contact function has the flat palm only, not {self.palm!r}")
        half = [CUBE_HALF] * 3

        def contact_fn(m, R_wb, p_wb, v, cs):
            cs_new = list(cs)
            f1, idx = ground_anchored_s(m, R_wb, p_wb, v, cs, cs_new, 0, self._pp_ground)
            f2, idx = sphere_box_anchored_s(m, R_wb, p_wb, v, self.cube, half, cs, cs_new, idx, self._pp_cube)
            f3, _ = box_ground_anchored_s(m, R_wb, p_wb, v, self.cube, half, cs, cs_new, idx, self._pp_corner)
            return add_fext_s(f1, f2, f3), cs_new

        return contact_fn

    def _finish_s(self, q, target, act, draw):
        """The end of ``control_step`` on columns (lists of [E] columns: the
        substeps' q, the target, the action and the ``draw_step`` draw):
        (target', reward, terminated, success as 0/1). The same ops as
        ``control_step``'s tail; its sums over a row (the norms, the action
        penalty) run left to right here."""
        cq = self.cube_q
        pos, quat = q[cq : cq + 3], q[cq + 3 : cq + 7]
        rel = sa.quat_mul_s(quat, [target[0]] + [-t for t in target[1:]])
        dist = 2.0 * torch.arcsin(torch.clamp(sa.v3_norm(rel[1:]), 0.0, 1.0))
        success = dist < self.success_tolerance
        fallen = sa.v3_norm(sa.v3_sub(pos, [0.0, 0.0, CUBE_HALF])) > self.fall_dist
        penalty = 0.0
        for a in act:
            penalty = sa.sadd(penalty, a**2)
        reward = (
            torch.reciprocal(dist + self.rot_eps)
            - self.action_penalty * penalty
            + torch.where(success, self.reach_goal_bonus, 0.0)
            + torch.where(fallen, self.fall_penalty, 0.0)
        )
        new_target = [torch.where(success, n, t) for n, t in zip(_rand_quat_s(*draw), target)]
        finite = functools.reduce(lambda a, b: a & b, [torch.isfinite(x) for x in q])
        return new_target, reward, fallen | ~finite, torch.where(success, 1.0, 0.0)

    @functools.cached_property
    def kernel_programs(self) -> dict[str, codegen.Program]:
        """The fused kernel's generated part, traced once per task: "substep"
        (q, qd, cs, act → q, qd, cs: ``_step_parts`` with the per-pair
        contacts) and "finish" (q, target, act, draw → target, reward,
        terminated, success: ``_finish_s``)."""
        m = self.model

        def substep(q, qd, cs, act):
            return dict(zip(("q", "qd", "cs"), _step_parts(m, q, qd, act, self._contact_fn_s(), contact_state=cs)))

        def finish(q, target, act, draw):
            out = self._finish_s(q, target, act, draw)
            return dict(target=out[0], reward=[out[1]], terminated=[out[2]], success=[out[3]])

        progs = {}
        for name, fn, sizes in (
            ("substep", substep, dict(q=m.nq, qd=m.nv, cs=4 * self.n_contact_pairs, act=m.nu)),
            ("finish", finish, dict(q=m.nq, target=4, act=m.nu, draw=3)),
        ):
            prog, out = codegen.trace(fn, sizes)
            for group, cols in out.items():
                prog.output(group, cols)
            progs[name] = prog
        return progs


class ShadowHand(AllegroHand):
    """Five-finger in-hand cube reorientation (IGE 'ShadowHand' analog; 20
    actuated curl DOF here vs the real hand's 20 of 24)."""

    n_fingers = 5
    n_dof = 5 * LINKS_PER_FINGER
    obs_dim = 20 + 20 + 3 + 4 + 3 + 3 + 4 + 4  # = 61
    action_dim = 20
