"""Anchored penalty contacts (port of the anchored pair groups of
pql_tpu/physics/contact.py): spheres vs the ground, spheres vs an oriented
box, box corners vs the ground plane and vs a spherical bowl.

Static friction + effective-mass-stable gains: per-PAIR penalty gains
derived from point effective masses (``derive_pair``), and a tangential
ANCHOR spring that provides true stiction up to the Coulomb cone, with the
anchor dragged along the cone surface when sliding. Anchors are carried in
the env state as a flat per-env array (4 scalars per pair: anchor xyz +
engaged flag), as [E] columns through the substeps
(dynamics.physics_substeps(contact_state=...)).

Each homogeneous pair GROUP is batched as [E, n] tensors (n pairs), with
the per-pair constants (body-frame offsets, radii, gains, box corners) as
[n] float32 tensors. Those constants are built once per device
(``ground_pairs``, ``sphere_box_pairs``, ``box_corners``): a numpy array
cannot multiply a CUDA tensor, a float64 one would promote every op it
touches, and a CUDA-graph capture allows no host-to-device copy. What the
JAX code reads as a Python float (a box's half extents, a gain shared by a
group, the bowl's centre and radius) stays one, so the structural 0/1
folding of ``scalar_algebra`` still removes launches.

The module also holds, as the JAX one does:

- the legacy viscous contacts (``ground_contacts``, ``box_ground_contacts``,
  ``sphere_box_contacts``): spring-damper normal force and smooth Coulomb
  friction without static friction. The matrix form takes the world poses
  and body velocities as [E, nb, 3, 3] / [E, nb, 3] / [E, nb, 6] tensors
  and returns [E, nb, 6] world wrenches about the world origin (plus the
  per-geom force magnitudes [E, n_geoms]); a box's half extents are a [3]
  tensor on the state's device. Geoms and corners unroll in Python, each
  pair's ops batched over the envs, and every body's wrench is a sum of its
  pairs' in the JAX loop's order, stacked once;
- their scalar twins (``*_contacts_s``) on the lists of [E] columns of
  ``scalar_algebra``, with the half extents, the ground normal and the
  gains as Python floats;
- the per-pair anchored loops (``ground_anchored_s``,
  ``sphere_box_anchored_s``, ``box_ground_anchored_s``): one pair at a time,
  each with a ``PairParams`` of Python floats, the reference the vectorized
  groups are held against and the contact model of the contact lab
  (``pql_tpu_torch.contact_lab``).

No contact function here copies from the host or writes into a view, so
each can be captured in a CUDA graph (the functions that make the
constants above copy, once per device, before a capture). Where a world-rooted link makes a sphere's
height a Python float (a hinge about the vertical at a fixed anchor), the
depth is broadcast to an [E] column before the torch ops that need one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pql_tpu_torch.physics import scalar_algebra as sa
from pql_tpu_torch.physics.model import RigidBodyModel


def _zero_fext(nb):
    return [[0.0] * 6 for _ in range(nb)]


# =====================================================================
# Legacy viscous contacts, matrix form: spring-damper normal force with
# smooth Coulomb friction, no static friction. Batched over a leading env
# dimension; the pairs unroll in Python as in the JAX module.
# =====================================================================


def _rot_const(R, o):
    """R @ o for R [..., 3, 3] and a body-frame point ``o`` of 3 floats."""
    return R[..., :, 0] * o[0] + R[..., :, 1] * o[1] + R[..., :, 2] * o[2]


def _cross_const(w, o):
    """w × o for w [..., 3] and 3 floats ``o``."""
    w0, w1, w2 = w.unbind(-1)
    return torch.stack([w1 * o[2] - w2 * o[1], w2 * o[0] - w0 * o[2], w0 * o[1] - w1 * o[0]], -1)


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def _point_state(R_wb, p_wb, v_body, body, offset):
    """World position and velocity [E, 3] of a body-frame point (3 floats)."""
    R = R_wb[..., body, :, :]
    pos = p_wb[..., body, :] + _rot_const(R, offset)
    omega, vlin = v_body[..., body, :3], v_body[..., body, 3:]
    vel = _mv(R, vlin + _cross_const(omega, offset))
    return pos, vel


def _up_like(x):
    """The ground normal [0, 0, 1] shaped like x [..., 3], made on x's device."""
    return torch.nn.functional.pad(torch.ones_like(x[..., :1]), (2, 0))


def _contact_force(depth, normal, vel, kp, kd, mu, cap=1.0e4):
    """Spring-damper normal force + smooth Coulomb friction.

    depth [E] > 0 means penetration; normal, vel [E, 3]. Returns the
    world-frame force [E, 3]; the normal force is capped at `cap` so deep
    penetrations from fast impacts cannot inject unbounded energy."""
    active = depth > 0.0
    vn = (vel * normal).sum(-1)
    fn_mag = torch.clamp(kp * depth - kd * vn, 0.0, cap) * active
    vt = vel - vn[..., None] * normal
    vt_norm = torch.linalg.vector_norm(vt, dim=-1) + 1e-6
    ft = (-torch.minimum(mu * fn_mag, 2.0 * kd * vt_norm))[..., None] * vt / vt_norm[..., None]
    return fn_mag[..., None] * normal + ft


def _add_body(acc, body, wrench):
    """acc[body] += wrench, the first term taken as it is (no add to zero)."""
    acc[body] = wrench if acc[body] is None else acc[body] + wrench


def _stack_bodies(acc, p_wb):
    """Per-body [E, 6] wrenches (None = none) → [E, nb, 6]."""
    zero = p_wb.new_zeros(p_wb.shape[:-2] + (6,))
    return torch.stack([zero if a is None else a for a in acc], -2)


def _stack_mags(mags, p_wb):
    return torch.stack(mags, -1) if mags else p_wb.new_zeros(p_wb.shape[:-2] + (0,))


def _model_gains(model):
    return model.contact_kp, model.contact_kd, model.friction_mu, model.contact_force_cap


def ground_contacts(model: RigidBodyModel, R_wb, p_wb, v_body):
    """Sphere-vs-plane(z=0) penalty forces. Returns ([E, nb, 6] f_ext_world,
    per-geom contact force magnitudes [E, n_geoms])."""
    acc, mags = [None] * model.nb, []
    for g in model.geoms:
        pos, vel = _point_state(R_wb, p_wb, v_body, g.body, [float(c) for c in g.offset])
        depth = g.radius - pos[..., 2]
        force = _contact_force(depth, _up_like(pos), vel, *_model_gains(model))
        torque = torch.linalg.cross(pos, force, dim=-1)
        _add_body(acc, g.body, torch.cat([torque, force], -1))
        mags.append(torch.linalg.vector_norm(force, dim=-1))
    return _stack_bodies(acc, p_wb), _stack_mags(mags, p_wb)


def _corner_signs_like(half):
    """[8, 3] corner signs in ``_CORNER_SIGNS`` order (x slowest), made on
    ``half``'s device without a copy from the host."""
    c = torch.arange(8, device=half.device)
    bits = torch.stack([(c >> 2) & 1, (c >> 1) & 1, c & 1], -1)
    return (2 * bits - 1).to(half.dtype)


def box_ground_contacts(model: RigidBodyModel, R_wb, p_wb, v_body, box_body: int, half_extents: torch.Tensor):
    """Oriented box (attached at `box_body` origin, half extents [3]) vs the
    ground plane: its 8 corners act as point contacts. Returns [E, nb, 6]
    world forces."""
    acc = [None] * model.nb
    Rb, pb = R_wb[..., box_body, :, :], p_wb[..., box_body, :]
    corners = _corner_signs_like(half_extents) * half_extents
    omega, vlin = v_body[..., box_body, :3], v_body[..., box_body, 3:]
    for c in range(8):
        local = corners[c]
        pos = pb + _mv(Rb, local)
        vel = _mv(Rb, vlin + torch.linalg.cross(omega, local.expand_as(omega), dim=-1))
        force = _contact_force(-pos[..., 2], _up_like(pos), vel, *_model_gains(model))
        torque = torch.linalg.cross(pos, force, dim=-1)
        _add_body(acc, box_body, torch.cat([torque, force], -1))
    return _stack_bodies(acc, p_wb)


def sphere_box_contacts(model: RigidBodyModel, R_wb, p_wb, v_body, box_body: int, half_extents: torch.Tensor):
    """Every model sphere vs an oriented box attached to `box_body` (at its
    body origin, half extents [3]). Equal-and-opposite forces applied to
    both bodies (momentum-conserving). Returns ([E, nb, 6] f_ext_world,
    [E, n_geoms] magnitudes, 0 for the box's own geoms)."""
    acc, mags = [None] * model.nb, []
    Rb, pb = R_wb[..., box_body, :, :], p_wb[..., box_body, :]
    RbT = Rb.transpose(-1, -2)
    for g in model.geoms:
        if g.body == box_body:
            mags.append(torch.zeros_like(pb[..., 0]))
            continue
        pos, vel = _point_state(R_wb, p_wb, v_body, g.body, [float(c) for c in g.offset])
        # sphere center in box frame
        local = _mv(RbT, pos - pb)
        closest = torch.clamp(local, -half_extents, half_extents)
        delta = local - closest
        dist = torch.linalg.vector_norm(delta, dim=-1) + 1e-9
        inside = (torch.abs(local) < half_extents).all(-1)
        # outside: normal from closest point to center; inside: push out along
        # the shallowest face (the largest |local|/extent axis, first on ties)
        n_out = delta / dist[..., None]
        ax = torch.argmax(torch.abs(local) / half_extents, -1)
        n_in = torch.sign(local.gather(-1, ax[..., None])) * (ax[..., None] == torch.arange(3, device=ax.device))
        normal_local = torch.where(inside[..., None], n_in, n_out)
        depth = torch.where(inside, g.radius + torch.amin(half_extents - torch.abs(closest), -1), g.radius - dist)
        normal = _mv(Rb, normal_local)

        box_point_vel = _mv(Rb, v_body[..., box_body, 3:]
                            + torch.linalg.cross(v_body[..., box_body, :3], local, dim=-1))
        rel_vel = vel - box_point_vel
        force = _contact_force(depth, normal, rel_vel, *_model_gains(model))
        torque = torch.linalg.cross(pos, force, dim=-1)
        _add_body(acc, g.body, torch.cat([torque, force], -1))
        _add_body(acc, box_body, torch.cat([-torque, -force], -1))
        mags.append(torch.linalg.vector_norm(force, dim=-1))
    return _stack_bodies(acc, p_wb), _stack_mags(mags, p_wb)


# =====================================================================
# Legacy viscous contacts, scalar form (scalar_algebra lists of [E]
# columns and Python floats): the same semantics, used as contact
# closures of dynamics.physics_step / physics_substeps.
# =====================================================================


def _first_tensor(*trees):
    """The first tensor in nested lists (the [E] reference for broadcasting
    a Python float where a torch op needs a tensor)."""
    for t in trees:
        if isinstance(t, torch.Tensor):
            return t
        if isinstance(t, (list, tuple)):
            found = _first_tensor(*t)
            if found is not None:
                return found
    return None


def _col(x, ref):
    """x as an [E] column: a Python float becomes one shaped like ``ref``."""
    return x if isinstance(x, torch.Tensor) else torch.full_like(ref, x)


def _point_state_s(R_wb, p_wb, v, body, offset):
    """World position/velocity (v3 lists) of a body-frame point (floats)."""
    R = R_wb[body]
    pos = sa.v3_add(p_wb[body], sa.m33_vec(R, offset))
    omega, vlin = v[body][:3], v[body][3:]
    vel = sa.m33_vec(R, sa.v3_add(vlin, sa.v3_cross(omega, offset)))
    return pos, vel


def _contact_force_s(depth, normal, vel, kp, kd, mu, cap, ref):
    """Scalar twin of _contact_force (normal: v3 list; ``ref`` an [E] tensor
    for a depth that is a Python float)."""
    depth = _col(depth, ref)
    active = depth > 0.0
    vn = sa.v3_dot(vel, normal)
    fn_mag = torch.clamp(sa.ssub(sa.smul(kp, depth), sa.smul(kd, vn)), 0.0, cap) * active
    vt = sa.v3_sub(vel, sa.v3_scale(normal, vn))
    vt_norm = sa.v3_norm(vt) + 1e-6
    ft = sa.v3_scale(vt, -torch.minimum(mu * fn_mag, 2.0 * kd * vt_norm) / vt_norm)
    return sa.v3_add(sa.v3_scale(normal, fn_mag), ft)


def _add_wrench(f_ext, body, pos, force):
    """f_ext[body] += [pos × force; force]; returns the torque."""
    torque = sa.v3_cross(pos, force)
    f_ext[body] = sa.sv6_add(f_ext[body], torque + force)
    return torque


def ground_contacts_s(model, R_wb, p_wb, v):
    """Scalar twin of ground_contacts → (per-body 6-lists, per-geom mags)."""
    f_ext = _zero_fext(model.nb)
    mags = []
    up = [0.0, 0.0, 1.0]
    ref = _first_tensor(p_wb, R_wb, v)
    for g in model.geoms:
        pos, vel = _point_state_s(R_wb, p_wb, v, g.body, [float(c) for c in g.offset])
        depth = g.radius - pos[2]
        force = _contact_force_s(depth, up, vel, *_model_gains(model), ref)
        _add_wrench(f_ext, g.body, pos, force)
        mags.append(sa.v3_norm(force))
    return f_ext, mags


def box_ground_contacts_s(model, R_wb, p_wb, v, box_body, half):
    """Scalar twin of box_ground_contacts (half: 3 python floats)."""
    f_ext = _zero_fext(model.nb)
    Rb, pb = R_wb[box_body], p_wb[box_body]
    omega, vlin = v[box_body][:3], v[box_body][3:]
    up = [0.0, 0.0, 1.0]
    ref = _first_tensor(pb, Rb, v[box_body])
    for sx, sy, sz in _CORNER_SIGNS:
        local = [sx * half[0], sy * half[1], sz * half[2]]
        pos = sa.v3_add(pb, sa.m33_vec(Rb, local))
        vel = sa.m33_vec(Rb, sa.v3_add(vlin, sa.v3_cross(omega, local)))
        force = _contact_force_s(sa.sneg(pos[2]), up, vel, *_model_gains(model), ref)
        _add_wrench(f_ext, box_body, pos, force)
    return f_ext


def _sphere_in_box_s(local, half, radius):
    """The box-frame normal (v3) and depth of a sphere of ``radius`` whose
    centre sits at ``local`` ([E] columns) in a box of half extents ``half``
    (floats): outside, from the closest point to the centre; inside, out
    through the face of the largest |local|/extent (first on ties,
    one_hot(argmax)), at the shallowest face's depth."""
    closest = [torch.clamp(local[k], -half[k], half[k]) for k in range(3)]
    delta = sa.v3_sub(local, closest)
    dist = sa.v3_norm(delta) + 1e-9
    abs_local = [torch.abs(x) for x in local]
    inside = (abs_local[0] < half[0]) & (abs_local[1] < half[1]) & (abs_local[2] < half[2])
    n_out = sa.v3_scale(delta, sa.srecip(dist))
    r0, r1, r2 = (abs_local[k] / half[k] for k in range(3))
    pick0 = (r0 >= r1) & (r0 >= r2)
    pick1 = ~pick0 & (r1 >= r2)
    pick2 = ~pick0 & ~pick1
    n_in = [torch.sign(local[k]) * pick for k, pick in enumerate((pick0, pick1, pick2))]
    normal_local = [torch.where(inside, n_in[k], n_out[k]) for k in range(3)]
    pen = torch.minimum(
        torch.minimum(half[0] - torch.abs(closest[0]), half[1] - torch.abs(closest[1])),
        half[2] - torch.abs(closest[2]),
    )
    depth = torch.where(inside, radius + pen, radius - dist)
    return normal_local, depth


def _add_box_reaction(f_ext, box_body, torque, force):
    """f_ext[box] += [−torque; −force] (the equal and opposite wrench)."""
    f_ext[box_body] = sa.sv6_add(f_ext[box_body], [sa.sneg(x) for x in torque] + [sa.sneg(x) for x in force])


def sphere_box_contacts_s(model, R_wb, p_wb, v, box_body, half):
    """Scalar twin of sphere_box_contacts: every model sphere vs an
    oriented box at box_body's origin (half: 3 floats); equal-and-opposite
    wrenches. The box's own geoms get a magnitude of 0.0."""
    f_ext = _zero_fext(model.nb)
    Rb, pb = R_wb[box_body], p_wb[box_body]
    ref = _first_tensor(pb, Rb, v[box_body])
    mags = []
    for g in model.geoms:
        if g.body == box_body:
            mags.append(0.0)
            continue
        pos, vel = _point_state_s(R_wb, p_wb, v, g.body, [float(c) for c in g.offset])
        local = [_col(x, ref) for x in sa.m33_T_vec(Rb, sa.v3_sub(pos, pb))]
        normal_local, depth = _sphere_in_box_s(local, half, g.radius)
        normal = sa.m33_vec(Rb, normal_local)
        box_pt_vel = sa.m33_vec(Rb, sa.v3_add(v[box_body][3:], sa.v3_cross(v[box_body][:3], local)))
        rel_vel = sa.v3_sub(vel, box_pt_vel)
        force = _contact_force_s(depth, normal, rel_vel, *_model_gains(model), ref)
        torque = _add_wrench(f_ext, g.body, pos, force)
        _add_box_reaction(f_ext, box_body, torque, force)
        mags.append(sa.v3_norm(force))
    return f_ext, mags


@dataclass(frozen=True)
class PairParams:
    """Per contact-pair penalty gains: python floats for one pair, or
    [n] float32 tensors for a stacked group (``stack_pair_params``)."""

    kp: float  # normal spring
    kd: float  # normal damping
    mu: float  # Coulomb friction coefficient
    cap: float  # normal force cap
    kpt: float  # tangential anchor spring
    kdt: float  # tangential damping (also the slip catch slope)


def point_eff_mass(model: RigidBodyModel, body: int, point_body) -> float:
    """Apparent mass of rigid `body` at a body-frame point (worst
    direction): 1/m_eff = 1/m + |ρ|²/λ_min(I). Conservative for
    articulated links (joints add mobility) — Geom.m_eff overrides."""
    m = float(model.mass[body])
    rho = np.asarray(point_body, float) - np.asarray(model.com[body], float)
    lam = float(np.linalg.eigvalsh(np.asarray(model.inertia[body], float))[0])
    return 1.0 / (1.0 / m + float(rho @ rho) / max(lam, 1e-12))


def derive_pair(
    model: RigidBodyModel,
    m_eff: float,
    n_share: int = 1,
    mu: float | None = None,
    kp: float | None = None,
) -> PairParams:
    """Stable penalty gains for a contact pair of effective mass m_eff
    shared by ~n_share simultaneous contacts on the same body.

    Explicit (symplectic-Euler) stability at substep dt: springs need
    ω·dt ≲ 1 and viscous terms need c·dt/m < 2. The normal spring keeps
    the model's kp (clamped to the spring bound); damping and friction
    gains are derived per pair and clamped to the viscous bound. The
    anchor spring gives stiction compliance µ·fn/kpt (sub-mm at these
    scales) instead of the unbounded creep of a viscous-only model."""
    dt = model.dt
    m_s = max(m_eff / max(n_share, 1), 1e-9)
    kp_v = float(model.contact_kp if kp is None else kp)
    kp_v = min(kp_v, 0.9 * m_s / dt**2)  # ω·dt ≤ ~0.95
    kpt = min(kp_v, 0.8 * m_s / dt**2)
    visc_bound = 0.7 * m_s / dt  # < 2·m/dt with margin for force coupling
    kd = min(2.0 * model.contact_zeta * float(np.sqrt(kp_v * m_s)), visc_bound)
    kdt = visc_bound
    return PairParams(
        kp=kp_v,
        kd=kd,
        mu=float(model.friction_mu if mu is None else mu),
        cap=float(model.contact_force_cap),
        kpt=kpt,
        kdt=kdt,
    )


def _clip(x, lo: float, hi):
    """jnp.clip(x, lo, hi) for a float ``lo`` and a float or tensor ``hi``."""
    x = torch.clamp_min(x, lo)
    return torch.clamp_max(x, hi) if isinstance(hi, float) else torch.minimum(x, hi)


def _anchored_force_s(depth, normal, vel, dx, engaged, pp: PairParams):
    """Anchored contact force in a single frame (world or box-local).

    depth > 0 penetrating; vel = relative velocity of the tracked point;
    dx = tracked point − anchor; engaged = 0/1 was-in-contact flag.
    Returns (force v3, dx_t' v3 so that anchor' = point − dx_t', engaged').
    """
    active = torch.where(depth > 0.0, 1.0, 0.0)
    vn = sa.v3_dot(vel, normal)
    fn = _clip(pp.kp * depth - pp.kd * vn, 0.0, pp.cap) * active
    vt = sa.v3_sub(vel, sa.v3_scale(normal, vn))
    dxn = sa.v3_dot(dx, normal)
    dxt = sa.v3_sub(dx, sa.v3_scale(normal, dxn))
    eng = active * engaged
    damp = [pp.kdt * vt[k] * active for k in range(3)]
    ft_raw = [-(pp.kpt * dxt[k] * eng + damp[k]) for k in range(3)]
    ftn = sa.v3_norm(ft_raw) + 1e-9
    scale = torch.clamp_max(pp.mu * fn / ftn, 1.0)
    ft = [ft_raw[k] * scale for k in range(3)]
    # anchor update: sliding (scale<1) drags the anchor to the cone
    # surface (spring alone would reproduce the clamped force next step);
    # first touch snaps the anchor to the point; inactive follows it.
    slid = [
        torch.where(scale < 1.0, -(ft[k] + damp[k]) / pp.kpt, dxt[k])
        for k in range(3)
    ]
    dxt_new = [slid[k] * eng for k in range(3)]
    force = [sa.sadd(sa.smul(fn, normal[k]), ft[k]) for k in range(3)]
    return force, dxt_new, active


def _cs_unpack(cs, idx):
    """4 scalars per pair from the flat contact-state list."""
    b = 4 * idx
    return [cs[b], cs[b + 1], cs[b + 2]], cs[b + 3]


def _cs_pack(out, idx, anchor, engaged):
    b = 4 * idx
    out[b], out[b + 1], out[b + 2] = anchor[0], anchor[1], anchor[2]
    out[b + 3] = engaged


# =====================================================================
# Per-pair anchored loops: one pair at a time on [E] columns, each with a
# PairParams of Python floats (as derive_pair returns it). The reference
# that the pair-vectorized groups below are held against, and the
# contact model of the contact lab.
# =====================================================================


def ground_anchored_s(model, R_wb, p_wb, v, cs, cs_new, base_idx, pps):
    """Sphere-vs-ground with tangential anchors (world frame). Reads pairs
    [base_idx, base_idx+len(geoms)) of the flat contact state `cs` ([E]
    columns), writes updates into `cs_new` (a mutable list). Returns
    (per-body 6-lists f_ext, next free pair index)."""
    f_ext = _zero_fext(model.nb)
    up = [0.0, 0.0, 1.0]
    for j, (g, pp) in enumerate(zip(model.geoms, pps)):
        pos, vel = _point_state_s(R_wb, p_wb, v, g.body, [float(c) for c in g.offset])
        anchor, engaged = _cs_unpack(cs, base_idx + j)
        depth = _col(g.radius - pos[2], engaged)
        dx = sa.v3_sub(pos, anchor)
        force, dxt_new, eng_new = _anchored_force_s(depth, up, vel, dx, engaged, pp)
        _add_wrench(f_ext, g.body, pos, force)
        _cs_pack(cs_new, base_idx + j, sa.v3_sub(pos, dxt_new), eng_new)
    return f_ext, base_idx + len(model.geoms)


def sphere_box_anchored_s(model, R_wb, p_wb, v, box_body, half, cs, cs_new, base_idx, pps):
    """Every model sphere vs an oriented box at `box_body` (half: 3 floats),
    with anchors stored in the BOX frame (so stick is correct while the box
    rotates: the in-hand reorientation case). Equal-and-opposite wrenches.
    ``pps[j]`` is geom j's PairParams; the box's own geoms keep their slots
    untouched."""
    f_ext = _zero_fext(model.nb)
    Rb, pb = R_wb[box_body], p_wb[box_body]
    vlin_box = v[box_body][3:]
    omega_box = v[box_body][:3]
    for j, (g, pp) in enumerate(zip(model.geoms, pps)):
        if g.body == box_body:
            continue
        pos, vel = _point_state_s(R_wb, p_wb, v, g.body, [float(c) for c in g.offset])
        anchor, engaged = _cs_unpack(cs, base_idx + j)  # box-frame anchor
        local = [_col(x, engaged) for x in sa.m33_T_vec(Rb, sa.v3_sub(pos, pb))]
        normal_local, depth = _sphere_in_box_s(local, half, g.radius)

        # relative velocity of the sphere centre w.r.t. the box surface
        # point, expressed in the box frame
        box_pt_vel = sa.m33_vec(Rb, sa.v3_add(vlin_box, sa.v3_cross(omega_box, local)))
        rel_vel_local = sa.m33_T_vec(Rb, sa.v3_sub(vel, box_pt_vel))

        dx = sa.v3_sub(local, anchor)
        force_l, dxt_new, eng_new = _anchored_force_s(depth, normal_local, rel_vel_local, dx, engaged, pp)
        force = sa.m33_vec(Rb, force_l)
        torque = _add_wrench(f_ext, g.body, pos, force)
        _add_box_reaction(f_ext, box_body, torque, force)
        _cs_pack(cs_new, base_idx + j, sa.v3_sub(local, dxt_new), eng_new)
    return f_ext, base_idx + len(model.geoms)


def box_ground_anchored_s(model, R_wb, p_wb, v, box_body, half, cs, cs_new, base_idx, pp):
    """Oriented-box corners (half: 3 floats) vs the ground plane with
    per-corner anchors (world frame). One PairParams shared by the 8
    corners."""
    f_ext = _zero_fext(model.nb)
    Rb, pb = R_wb[box_body], p_wb[box_body]
    omega, vlin = v[box_body][:3], v[box_body][3:]
    up = [0.0, 0.0, 1.0]
    for j, (sx, sy, sz) in enumerate(_CORNER_SIGNS):
        local = [sx * half[0], sy * half[1], sz * half[2]]
        pos = sa.v3_add(pb, sa.m33_vec(Rb, local))
        vel = sa.m33_vec(Rb, sa.v3_add(vlin, sa.v3_cross(omega, local)))
        anchor, engaged = _cs_unpack(cs, base_idx + j)
        dx = sa.v3_sub(pos, anchor)
        force, dxt_new, eng_new = _anchored_force_s(_col(sa.sneg(pos[2]), engaged), up, vel, dx, engaged, pp)
        _add_wrench(f_ext, box_body, pos, force)
        _cs_pack(cs_new, base_idx + j, sa.v3_sub(pos, dxt_new), eng_new)
    return f_ext, base_idx + 8


# =====================================================================
# Pair-vectorized group: every homogeneous pair group as [E, n] math.
# The scalar-algebra helpers are shape-polymorphic, so the same
# `_anchored_force_s` core runs on v3s whose components are [E, n]
# tensors; per-pair gains are [n] tensors inside a PairParams.
# =====================================================================


def stack_pair_params(pps, device) -> PairParams:
    """Stack per-pair PairParams into one PairParams of [n] float32 tensors."""
    f = lambda name: torch.tensor([getattr(p, name) for p in pps], dtype=torch.float32, device=device)  # noqa: E731
    return PairParams(
        kp=f("kp"), kd=f("kd"), mu=f("mu"), cap=f("cap"), kpt=f("kpt"), kdt=f("kdt")
    )


@dataclass(frozen=True)
class SpherePairs:
    """The constants of one sphere pair group (spheres vs the ground, or vs
    a box) on one device."""

    idxs: tuple[int, ...]  # geom index of each pair: its slot after the group's base index
    bodies: tuple[int, ...]  # body of each geom
    offsets: torch.Tensor  # [n, 3] body-frame sphere centres
    radius: torch.Tensor  # [n]
    pp: PairParams  # [n] gains


def _sphere_pairs(model: RigidBodyModel, idxs, pps, device) -> SpherePairs:
    geoms = [model.geoms[j] for j in idxs]
    return SpherePairs(
        idxs=tuple(idxs),
        bodies=tuple(g.body for g in geoms),
        offsets=torch.tensor(np.asarray([g.offset for g in geoms], np.float32), device=device),
        radius=torch.tensor(np.asarray([g.radius for g in geoms], np.float32), device=device),
        pp=stack_pair_params(pps, device),
    )


def ground_pairs(model: RigidBodyModel, pps, device) -> SpherePairs:
    """Every sphere geom of ``model`` against the ground, with per-pair
    gains ``pps`` (a list of PairParams), as float32 tensors on ``device``."""
    return _sphere_pairs(model, range(len(model.geoms)), pps, device)


def sphere_box_pairs(model: RigidBodyModel, box_body: int, pps, device) -> SpherePairs:
    """Every sphere geom not on ``box_body`` against that box, with the
    gains ``pps[j]`` of geom j, as float32 tensors on ``device``."""
    idxs = [j for j, g in enumerate(model.geoms) if g.body != box_body]
    return _sphere_pairs(model, idxs, [pps[j] for j in idxs], device)


_CORNER_SIGNS = [
    (sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)
]


def box_corners(half, device) -> torch.Tensor:
    """[8, 3] float32 box-frame corners (``_CORNER_SIGNS`` × ``half``) of a
    box of half extents ``half``: the constants of the box-ground and bowl
    groups."""
    signs = np.asarray(_CORNER_SIGNS, np.float32)
    return torch.tensor(signs * np.asarray(half, np.float32), device=device)


def add_fext_s(*fs):
    """Elementwise sum of per-body 6-list force sets."""
    out = fs[0]
    for g in fs[1:]:
        out = [sa.sv6_add(a, b) for a, b in zip(out, g)]
    return out


def _stackn(xs, ref):
    """Stack [E] scalars into an [E, n] tensor, broadcasting python-float
    constants against a reference [E] scalar."""
    return torch.stack([torch.full_like(ref, x) if isinstance(x, (int, float)) else x for x in xs], -1)


def _per_pair(xs):
    """[E] scalars (or python floats) → [E, 1], to broadcast against a group's [n] constants."""
    return [x if isinstance(x, float) else x[:, None] for x in xs]


def _gather_points(R_wb, p_wb, v, bodies, offsets, ref):
    """World position/velocity of body-frame points, as v3s of [E, n] tensors.

    offsets: [n, 3] constants; ref: an [E] tensor (python-float entries of a
    world-rooted link's pose are broadcast against it)."""
    R = [[_stackn([R_wb[b][r][c] for b in bodies], ref) for c in range(3)] for r in range(3)]
    p = [_stackn([p_wb[b][k] for b in bodies], ref) for k in range(3)]
    w = [_stackn([v[b][k] for b in bodies], ref) for k in range(3)]
    vl = [_stackn([v[b][3 + k] for b in bodies], ref) for k in range(3)]
    off = [offsets[:, k] for k in range(3)]
    pos = sa.v3_add(p, sa.m33_vec(R, off))
    vel = sa.m33_vec(R, sa.v3_add(vl, sa.v3_cross(w, off)))
    return pos, vel


def _gather_anchors(cs, base_idx, idxs, ref):
    """Anchor v3 + engaged flag as [E, n] tensors from the flat contact state."""
    anchor = [
        _stackn([cs[4 * (base_idx + j) + k] for j in idxs], ref) for k in range(3)
    ]
    engaged = _stackn([cs[4 * (base_idx + j) + 3] for j in idxs], ref)
    return anchor, engaged


def _scatter_anchors(cs_new, base_idx, idxs, anchor, engaged):
    for jj, j in enumerate(idxs):
        _cs_pack(
            cs_new,
            base_idx + j,
            [anchor[0][..., jj], anchor[1][..., jj], anchor[2][..., jj]],
            engaged[..., jj],
        )


def _scatter_wrenches(f_ext, bodies, pos, force):
    """f_ext[body] += [pos x force; force] per pair (distinct bodies)."""
    torque = sa.v3_cross(pos, force)
    for jj, b in enumerate(bodies):
        f_ext[b] = sa.sv6_add(
            f_ext[b],
            [torque[0][..., jj], torque[1][..., jj], torque[2][..., jj],
             force[0][..., jj], force[1][..., jj], force[2][..., jj]],
        )
    return torque


def _add_box_wrench(f_ext, box_body, torque, force, sign=1.0):
    """f_ext[box] += sign · Σ over the group's pairs of [torque; force]."""
    total = [t.sum(-1) for t in torque] + [f.sum(-1) for f in force]
    f_ext[box_body] = sa.sv6_add(f_ext[box_body], total if sign > 0 else [-x for x in total])


def ground_anchored_v(model, R_wb, p_wb, v, cs, cs_new, base_idx, pairs: SpherePairs):
    """All sphere geoms vs the ground (world-frame anchors). Reads pairs
    [base_idx, base_idx + n) of the flat contact state ``cs``, writes the
    updates into ``cs_new`` (a mutable list). Returns (per-body 6-lists
    f_ext, next free pair index)."""
    ref = cs[4 * base_idx]
    pos, vel = _gather_points(R_wb, p_wb, v, pairs.bodies, pairs.offsets, ref)
    anchor, engaged = _gather_anchors(cs, base_idx, pairs.idxs, ref)
    depth = pairs.radius - pos[2]
    dx = sa.v3_sub(pos, anchor)
    force, dxt_new, eng_new = _anchored_force_s(
        depth, [0.0, 0.0, 1.0], vel, dx, engaged, pairs.pp
    )
    f_ext = _zero_fext(model.nb)
    _scatter_wrenches(f_ext, pairs.bodies, pos, force)
    _scatter_anchors(cs_new, base_idx, pairs.idxs, sa.v3_sub(pos, dxt_new), eng_new)
    return f_ext, base_idx + len(pairs.idxs)


def sphere_box_anchored_v(model, R_wb, p_wb, v, box_body, half, cs, cs_new, base_idx, pairs: SpherePairs):
    """Spheres vs one oriented box at ``box_body`` (half extents ``half``,
    python floats), with anchors stored in the BOX frame (so stick is right
    while the box rotates: the in-hand reorientation case) and equal and
    opposite wrenches on the box. A sphere centre inside the box pushes out
    along the axis of the face it is nearest to, relative to the half
    extents. Returns (f_ext, base_idx + number of geoms)."""
    ref = cs[4 * (base_idx + pairs.idxs[0])]
    pos, vel = _gather_points(R_wb, p_wb, v, pairs.bodies, pairs.offsets, ref)
    Rb = [_per_pair(row) for row in R_wb[box_body]]
    pb = _per_pair(p_wb[box_body])
    vlin_box, omega_box = _per_pair(v[box_body][3:]), _per_pair(v[box_body][:3])
    local = sa.m33_T_vec(Rb, sa.v3_sub(pos, pb))
    closest = [torch.clamp(local[k], -half[k], half[k]) for k in range(3)]
    delta = sa.v3_sub(local, closest)
    dist = sa.v3_norm(delta) + 1e-9
    abs_local = [torch.abs(x) for x in local]
    inside = (abs_local[0] < half[0]) & (abs_local[1] < half[1]) & (abs_local[2] < half[2])
    n_out = sa.v3_scale(delta, sa.srecip(dist))
    r0, r1, r2 = (abs_local[k] / half[k] for k in range(3))
    pick0 = (r0 >= r1) & (r0 >= r2)
    pick1 = ~pick0 & (r1 >= r2)
    pick2 = ~pick0 & ~pick1
    n_in = [torch.sign(local[k]) * pick for k, pick in enumerate((pick0, pick1, pick2))]
    normal_local = [torch.where(inside, n_in[k], n_out[k]) for k in range(3)]
    pen = torch.minimum(
        torch.minimum(half[0] - torch.abs(closest[0]), half[1] - torch.abs(closest[1])),
        half[2] - torch.abs(closest[2]),
    )
    depth = torch.where(inside, pairs.radius + pen, pairs.radius - dist)

    # relative velocity of the sphere centre w.r.t. the box surface point,
    # in the box frame
    box_pt_vel = sa.m33_vec(Rb, sa.v3_add(vlin_box, sa.v3_cross(omega_box, local)))
    rel_vel_local = sa.m33_T_vec(Rb, sa.v3_sub(vel, box_pt_vel))

    anchor, engaged = _gather_anchors(cs, base_idx, pairs.idxs, ref)
    dx = sa.v3_sub(local, anchor)
    force_l, dxt_new, eng_new = _anchored_force_s(
        depth, normal_local, rel_vel_local, dx, engaged, pairs.pp
    )
    force = sa.m33_vec(Rb, force_l)
    f_ext = _zero_fext(model.nb)
    torque = _scatter_wrenches(f_ext, pairs.bodies, pos, force)
    _add_box_wrench(f_ext, box_body, torque, force, sign=-1.0)
    _scatter_anchors(cs_new, base_idx, pairs.idxs, sa.v3_sub(local, dxt_new), eng_new)
    return f_ext, base_idx + len(model.geoms)


def _box_corner_points(R_wb, p_wb, v, box_body, corners):
    """World position/velocity of the 8 box corners, as v3s of [E, 8] tensors."""
    Rb = [_per_pair(row) for row in R_wb[box_body]]
    pb = _per_pair(p_wb[box_body])
    omega, vlin = _per_pair(v[box_body][:3]), _per_pair(v[box_body][3:])
    local = [corners[:, k] for k in range(3)]
    pos = sa.v3_add(pb, sa.m33_vec(Rb, local))
    vel = sa.m33_vec(Rb, sa.v3_add(vlin, sa.v3_cross(omega, local)))
    return pos, vel


def _box_corner_contacts(model, box_body, pos, vel, depth, normal, cs, cs_new, base_idx, pp):
    """The anchored corner contacts of a box group (world-frame anchors), the
    summed wrench on the box, and the 8 pair updates."""
    ref = cs[4 * base_idx]
    anchor, engaged = _gather_anchors(cs, base_idx, range(8), ref)
    dx = sa.v3_sub(pos, anchor)
    force, dxt_new, eng_new = _anchored_force_s(depth, normal, vel, dx, engaged, pp)
    f_ext = _zero_fext(model.nb)
    _add_box_wrench(f_ext, box_body, sa.v3_cross(pos, force), force)
    _scatter_anchors(cs_new, base_idx, range(8), sa.v3_sub(pos, dxt_new), eng_new)
    return f_ext, base_idx + 8


def box_ground_anchored_v(model, R_wb, p_wb, v, box_body, corners, cs, cs_new, base_idx, pp: PairParams):
    """The 8 corners of the box at ``box_body`` (``corners``: [8, 3] from
    ``box_corners``) vs the ground plane, per-corner world-frame anchors.
    One PairParams of python floats is shared by the corners."""
    pos, vel = _box_corner_points(R_wb, p_wb, v, box_body, corners)
    return _box_corner_contacts(model, box_body, pos, vel, -pos[2], [0.0, 0.0, 1.0], cs, cs_new, base_idx, pp)


def bowl_anchored_v(model, R_wb, p_wb, v, box_body, corners, center, radius, cs, cs_new, base_idx,
                    pp: PairParams):
    """The box corners vs the INSIDE of a spherical bowl (the cradled palm:
    fingertips can roll the cube instead of re-gripping it on a plane).
    ``center`` [3] and ``radius`` are python floats; a corner at distance d
    from the centre penetrates the shell by d − radius, with the normal
    pointing back to the centre. Inside the rim (where the shell meets z = 0)
    the shell is the support, outside it the plane. Same pair layout as
    ``box_ground_anchored_v`` (8 pairs)."""
    pos, vel = _box_corner_points(R_wb, p_wb, v, box_body, corners)
    rel = [sa.ssub(pos[k], float(center[k])) for k in range(3)]
    d = sa.v3_norm(rel) + 1e-9
    depth_bowl = d - float(radius)
    n_bowl = sa.v3_scale(rel, -torch.reciprocal(d))
    r_rim2 = float(radius) ** 2 - float(center[2]) ** 2
    in_rim = (pos[0] * pos[0] + pos[1] * pos[1]) < r_rim2
    depth = torch.where(in_rim, depth_bowl, -pos[2])
    normal = [
        torch.where(in_rim, n_bowl[0], 0.0),
        torch.where(in_rim, n_bowl[1], 0.0),
        torch.where(in_rim, n_bowl[2], 1.0),
    ]
    return _box_corner_contacts(model, box_body, pos, vel, depth, normal, cs, cs_new, base_idx, pp)
