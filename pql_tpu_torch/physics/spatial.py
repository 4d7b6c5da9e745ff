"""Spatial (6-D) vector algebra and quaternion utilities (port of
pql_tpu/physics/spatial.py).

Conventions follow Featherstone's Rigid Body Dynamics Algorithms: motion
vectors are [ω; v] in body coordinates, forces are [n; f]; a Plücker
transform ^B X_A is parameterized by the rotation E (A-coords → B-coords)
and the origin of B expressed in A coords, r.

The JAX functions work on one env and are vmapped; these take any leading
batch dimensions: vectors are [..., 3] (quaternions [..., 4], spatial
vectors [..., 6]) and matrices [..., 3, 3] / [..., 6, 6]. Operands
broadcast against each other, so a constant [3] vector can meet an
[E, 3] batch. The matrix form is the engine's readable reference; the
hot path is ``scalar_algebra``.
"""

from __future__ import annotations

import torch


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def skew(v):
    """3×3 cross-product matrix: skew(v) @ u == v × u."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


# ----------------------------------------------------------------- quats
# quaternions are (w, x, y, z), unit norm, rotating body → world


def quat_identity(device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        -1,
    )


def quat_rotate(q, v):
    """Rotate v by q (body → world)."""
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + q[..., :1] * t + _cross(qv, t)


def quat_inv(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_to_mat(q):
    """Rotation matrix R with R @ v_body = v_world."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_integrate(q, omega_body, dt):
    """q̇ = ½ q ⊗ [0, ω_body]; renormalized semi-implicit update."""
    dq = 0.5 * quat_mul(q, torch.cat([torch.zeros_like(omega_body[..., :1]), omega_body], -1))
    q = q + dt * dq
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_from_axis_angle(axis, angle):
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], -1)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def axis_angle_to_mat(axis, angle):
    """Rodrigues rotation matrix (axis assumed unit); angle [...]."""
    K = skew(axis)
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None, None]
    return _eye3(K) + s * K + (1.0 - c) * (K @ K)


# ---------------------------------------------------------- 6×6 transforms


def _block(tl, tr, bl, br):
    return torch.cat([torch.cat([tl, tr], -1), torch.cat([bl, br], -1)], -2)


def xmat(E, r):
    """Motion transform ^B X_A as 6×6: [ω;v] ↦ [Eω; E(v − r×ω)]."""
    Y = -E @ skew(r)
    return _block(E.expand_as(Y), torch.zeros_like(Y), Y, E.expand_as(Y))


def xmat_force(E, r):
    """Force transform ^B X*_A: [n;f] ↦ [E(n − r×f); Ef]. Equals
    xmat(E, r)^{-T}."""
    Y = -E @ skew(r)
    return _block(E.expand_as(Y), Y, torch.zeros_like(Y), E.expand_as(Y))


def xmat_inv(E, r):
    """^A X_B given ^B X_A params (E, r)."""
    return xmat(E.transpose(-1, -2), -(E @ r[..., None])[..., 0])


def crm(v):
    """Spatial motion cross product matrix: crm(v) @ u = v ×ₘ u."""
    sw, sv = skew(v[..., :3]), skew(v[..., 3:])
    return _block(sw, torch.zeros_like(sw), sv, sw)


def crf(v):
    """Spatial force cross product: crf(v) @ f = v ×* f = -crm(v)^T f."""
    return -crm(v).transpose(-1, -2)


def spatial_inertia(mass, com, inertia_com):
    """6×6 spatial inertia about the body frame origin: mass, com offset c
    (body frame), rotational inertia about the com (3×3)."""
    C = skew(com)
    I_bar = inertia_com + mass * (C @ C.transpose(-1, -2))
    mC = mass * C
    return _block(I_bar, mC, mC.transpose(-1, -2), (mass * _eye3(C)).expand_as(mC))
