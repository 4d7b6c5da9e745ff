"""Anchored sphere-vs-ground contacts (port of the anchored ground group of
pql_tpu/physics/contact.py).

Static friction + effective-mass-stable gains: per-PAIR penalty gains
derived from point effective masses (``derive_pair``), and a tangential
ANCHOR spring that provides true stiction up to the Coulomb cone, with the
anchor dragged along the cone surface when sliding. Anchors are carried in
the env state as a flat per-env array (4 scalars per pair: anchor xyz +
engaged flag), as [E] columns through the substeps
(dynamics.physics_substeps(contact_state=...)).

All sphere geoms of a model are one pair GROUP, batched as [E, n] tensors
(n pairs), with the per-pair constants (body-frame offsets, radii, gains)
as [n] float32 tensors. Those constants are built once per device by
``ground_pairs``: a numpy array cannot multiply a CUDA tensor, a float64
one would promote every op it touches, and a CUDA-graph capture allows no
host-to-device copy. The per-pair scalar loops, the legacy viscous
contacts and the sphere-box, box-ground and bowl groups of the JAX module
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pql_tpu_torch.physics import scalar_algebra as sa
from pql_tpu_torch.physics.model import RigidBodyModel


def _zero_fext(nb):
    return [[0.0] * 6 for _ in range(nb)]


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
class GroundPairs:
    """The constants of the sphere-vs-ground group on one device."""

    bodies: tuple[int, ...]  # body of each geom
    offsets: torch.Tensor  # [n, 3] body-frame sphere centres
    radius: torch.Tensor  # [n]
    pp: PairParams  # [n] gains


def ground_pairs(model: RigidBodyModel, pps, device) -> GroundPairs:
    """Every sphere geom of ``model`` against the ground, with per-pair
    gains ``pps`` (a list of PairParams), as float32 tensors on ``device``."""
    geoms = model.geoms
    return GroundPairs(
        bodies=tuple(g.body for g in geoms),
        offsets=torch.tensor(np.asarray([g.offset for g in geoms], np.float32), device=device),
        radius=torch.tensor(np.asarray([g.radius for g in geoms], np.float32), device=device),
        pp=stack_pair_params(pps, device),
    )


def _stackn(xs, ref):
    """Stack [E] scalars into an [E, n] tensor, broadcasting python-float
    constants against a reference [E] scalar."""
    return torch.stack([torch.full_like(ref, x) if isinstance(x, (int, float)) else x for x in xs], -1)


def _gather_points(R_wb, p_wb, v, bodies, offsets):
    """World position/velocity of body-frame points, as v3s of [E, n] tensors.

    offsets: [n, 3] constants."""
    ref = p_wb[bodies[0]][2]
    R = [[_stackn([R_wb[b][r][c] for b in bodies], ref) for c in range(3)] for r in range(3)]
    p = [_stackn([p_wb[b][k] for b in bodies], ref) for k in range(3)]
    w = [_stackn([v[b][k] for b in bodies], ref) for k in range(3)]
    vl = [_stackn([v[b][3 + k] for b in bodies], ref) for k in range(3)]
    off = [offsets[:, k] for k in range(3)]
    pos = sa.v3_add(p, sa.m33_vec(R, off))
    vel = sa.m33_vec(R, sa.v3_add(vl, sa.v3_cross(w, off)))
    return pos, vel, ref


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


def ground_anchored_v(model, R_wb, p_wb, v, cs, cs_new, base_idx, pairs: GroundPairs):
    """All sphere geoms vs the ground (world-frame anchors). Reads pairs
    [base_idx, base_idx + n) of the flat contact state ``cs``, writes the
    updates into ``cs_new`` (a mutable list). Returns (per-body 6-lists
    f_ext, next free pair index)."""
    n = len(pairs.bodies)
    pos, vel, ref = _gather_points(R_wb, p_wb, v, pairs.bodies, pairs.offsets)
    anchor, engaged = _gather_anchors(cs, base_idx, range(n), ref)
    depth = pairs.radius - pos[2]
    dx = sa.v3_sub(pos, anchor)
    force, dxt_new, eng_new = _anchored_force_s(
        depth, [0.0, 0.0, 1.0], vel, dx, engaged, pairs.pp
    )
    f_ext = _zero_fext(model.nb)
    _scatter_wrenches(f_ext, pairs.bodies, pos, force)
    _scatter_anchors(cs_new, base_idx, range(n), sa.v3_sub(pos, dxt_new), eng_new)
    return f_ext, base_idx + n
