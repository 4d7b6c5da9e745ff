"""Rigid-body model description (copy of pql_tpu/physics/model.py).

A RigidBodyModel is a *static* articulated-tree spec (plain numpy /
python): parent indices, joint types, fixed tree transforms, link
inertias, actuator wiring and collision geometry. The physics reads its
values as Python floats, so they fold into the unrolled algebra; the
dynamic state (q, qd) lives in the env's state dict of [E, ...] tensors.

Supported joints: 'free' (6-DOF floating base, q = [pos(3), quat(4)],
qd = [ω_body(3), v_body(3)]) and 'hinge' (revolute, 1-DOF). That covers
the reference task families: locomotion (Ant/Humanoid/Anymal — free base +
hinge limbs) and dexterous hands (fixed base + hinge fingers + free cube).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FREE = "free"
HINGE = "hinge"


@dataclass(frozen=True)
class Geom:
    """Collision sphere attached to a body (the engine's contact primitive);
    boxes are supported as *targets* (sphere-vs-box tests).

    m_eff: optional apparent (point) mass of the body at this geom, used by
    the anchored contact model to derive stable per-pair gains. For links of
    an articulated chain the true apparent mass at the tip depends on the
    whole chain + armature and can't be read off the body mass; models that
    care set it explicitly (see pql_tpu_torch.physics.contact.point_eff_mass for
    the rigid-body default)."""

    body: int
    offset: tuple[float, float, float]
    radius: float
    m_eff: float | None = None


@dataclass(frozen=True)
class RigidBodyModel:
    nb: int  # number of bodies (excluding the world)
    parent: tuple[int, ...]  # parent body index, -1 = world
    joint_type: tuple[str, ...]  # per body: FREE | HINGE
    joint_axis: np.ndarray  # [nb, 3] hinge axes (unit, joint frame)
    tree_pos: np.ndarray  # [nb, 3] joint frame origin in parent frame
    mass: np.ndarray  # [nb]
    com: np.ndarray  # [nb, 3] body-frame com offset
    inertia: np.ndarray  # [nb, 3, 3] rotational inertia about com
    # dof-level parameters
    damping: np.ndarray  # [nv]
    armature: np.ndarray  # [nv]
    # actuators drive hinge dofs: gear scales the [-1,1] policy action
    actuated_dofs: tuple[int, ...]
    gear: np.ndarray  # [nu]
    # joint limits for hinge q (ignored for free)
    limit_lo: np.ndarray  # [nq_hinge-aligned] see q layout
    limit_hi: np.ndarray
    limit_stiffness: float
    geoms: tuple[Geom, ...] = field(default_factory=tuple)
    gravity: float = -9.81
    dt: float = 1.0 / 60.0
    contact_kp: float = 2.0e4
    contact_kd: float = 100.0
    friction_mu: float = 1.0
    # numerical-safety rails for the penalty formulation: cap any single
    # contact's normal force and every dof's speed (applied each substep)
    contact_force_cap: float = 1.0e4
    max_dof_speed: float = 100.0
    # anchored-contact model (contact.derive_pair): target damping ratio;
    # per-pair damping/friction gains are derived from point effective
    # masses and clamped to the explicit-integration stability bound
    contact_zeta: float = 1.0
    # actuation mode: "torque" (tau = gear * action, the locomotion
    # default) or "position" — a per-substep PD servo to a target angle,
    # IGE's joint-position drive (Isaac Gym DOF_MODE_POS with per-dof
    # stiffness/damping; the AllegroHand task trains with stiffness 3.0,
    # damping 0.1, effort ~0.7 N*m). Position actions in [-1, 1] map
    # linearly onto [limit_lo, limit_hi]; gear is the EFFORT CAP.
    control_mode: str = "torque"
    act_kp: float = 3.0
    act_kd: float = 0.1

    # -------- derived layout (computed in __post_init__-style helpers) ----

    @property
    def nq_per_joint(self) -> tuple[int, ...]:
        return tuple(7 if t == FREE else 1 for t in self.joint_type)

    @property
    def nv_per_joint(self) -> tuple[int, ...]:
        return tuple(6 if t == FREE else 1 for t in self.joint_type)

    @property
    def q_start(self) -> tuple[int, ...]:
        out, acc = [], 0
        for n in self.nq_per_joint:
            out.append(acc)
            acc += n
        return tuple(out)

    @property
    def v_start(self) -> tuple[int, ...]:
        out, acc = [], 0
        for n in self.nv_per_joint:
            out.append(acc)
            acc += n
        return tuple(out)

    @property
    def nq(self) -> int:
        return sum(self.nq_per_joint)

    @property
    def nv(self) -> int:
        return sum(self.nv_per_joint)

    @property
    def nu(self) -> int:
        return len(self.actuated_dofs)

    @property
    def q_of_dof(self) -> dict[int, int]:
        """v-index → q-index for HINGE dofs (used by the position servo)."""
        out = {}
        for i, t in enumerate(self.joint_type):
            if t == HINGE:
                out[self.v_start[i]] = self.q_start[i]
        return out

    def neutral_q(self) -> np.ndarray:
        """Identity pose: free joints at origin with unit quat, hinges at 0."""
        q = np.zeros(self.nq, np.float32)
        for i, t in enumerate(self.joint_type):
            if t == FREE:
                q[self.q_start[i] + 3] = 1.0  # quat w
        return q
