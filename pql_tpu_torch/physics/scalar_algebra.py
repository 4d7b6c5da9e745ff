"""Scalar-unrolled spatial algebra on per-env [E] tensors (port of
pql_tpu/physics/scalar_algebra.py).

Every small matrix or vector of the engine is a nested Python LIST whose
entries are [E] tensors (one value per env) or Python floats (constants of
the model). The algebra unrolls at call time into elementwise ops on [E]
tensors, so no [E, 6, 6] intermediate is ever built.

Structure conventions (Featherstone, matching pql_tpu_torch.physics.spatial):
- v3: [x, y, z] — 3 scalars
- quat: [w, x, y, z]
- m33: 3×3 nested list, row major
- sv6: [ω0,ω1,ω2, v0,v1,v2] — spatial motion/force vector, 6 scalars
- m66: 6×6 nested list
- A Plücker motion transform ^B X_A is kept FACTORED as (E: m33, r: v3)
  (rotation A→B coords, origin offset in A coords) and applied via its
  block structure — never materialized as 6×6.

Python float literals (0.0) serve as exact zeros. Every helper routes
scalar arithmetic through ``smul``/``sadd``/``ssub``, which fold
structural zeros and unit factors while the algebra unrolls: a product
with a Python 0.0 or 1.0 issues no op at all. Eagerly every op is one
kernel launch, so the folding removes launches here as it removed jaxpr
equations in the JAX package.
"""

from __future__ import annotations

import math

import torch


def _z(x) -> bool:
    """Structural zero (exact python float 0.0)."""
    return isinstance(x, float) and x == 0.0


def _one(x) -> bool:
    return isinstance(x, float) and x == 1.0


def smul(a, b):
    """a·b with structural folding: 0·x → 0.0, 1·x → x."""
    if _z(a) or _z(b):
        return 0.0
    if _one(a):
        return b
    if _one(b):
        return a
    return a * b


def sadd(a, b):
    if _z(a):
        return b
    if _z(b):
        return a
    return a + b


def ssub(a, b):
    if _z(b):
        return a
    if _z(a):
        return -b
    return a - b


def sneg(a):
    return 0.0 if _z(a) else -a


def ssqrt(x):
    """sqrt of a tensor or of a python float (which stays a float)."""
    return math.sqrt(x) if isinstance(x, float) else torch.sqrt(x)


def srecip(x):
    """1/x in one op (``1.0 / tensor`` is a reciprocal and a multiply)."""
    return 1.0 / x if isinstance(x, float) else torch.reciprocal(x)


# ------------------------------------------------------------- 3-vectors

def v3_add(a, b):
    return [sadd(a[0], b[0]), sadd(a[1], b[1]), sadd(a[2], b[2])]


def v3_sub(a, b):
    return [ssub(a[0], b[0]), ssub(a[1], b[1]), ssub(a[2], b[2])]


def v3_scale(a, s):
    return [smul(a[0], s), smul(a[1], s), smul(a[2], s)]


def v3_dot(a, b):
    return sadd(sadd(smul(a[0], b[0]), smul(a[1], b[1])), smul(a[2], b[2]))


def v3_cross(a, b):
    return [
        ssub(smul(a[1], b[2]), smul(a[2], b[1])),
        ssub(smul(a[2], b[0]), smul(a[0], b[2])),
        ssub(smul(a[0], b[1]), smul(a[1], b[0])),
    ]


def v3_norm(a, eps=0.0):
    return ssqrt(sadd(v3_dot(a, a), eps))


def v3_zero():
    return [0.0, 0.0, 0.0]


# ------------------------------------------------------------ 3×3 blocks

def m33_vec(M, v):
    return [v3_dot(M[0], v), v3_dot(M[1], v), v3_dot(M[2], v)]


def m33_T_vec(M, v):
    """Mᵀ v without forming the transpose."""
    return [
        sadd(sadd(smul(M[0][0], v[0]), smul(M[1][0], v[1])), smul(M[2][0], v[2])),
        sadd(sadd(smul(M[0][1], v[0]), smul(M[1][1], v[1])), smul(M[2][1], v[2])),
        sadd(sadd(smul(M[0][2], v[0]), smul(M[1][2], v[1])), smul(M[2][2], v[2])),
    ]


def m33_mul(A, B):
    return [
        [
            sadd(
                sadd(smul(A[i][0], B[0][j]), smul(A[i][1], B[1][j])),
                smul(A[i][2], B[2][j]),
            )
            for j in range(3)
        ]
        for i in range(3)
    ]


def m33_T(A):
    return [[A[j][i] for j in range(3)] for i in range(3)]


def m33_add(A, B):
    return [[sadd(A[i][j], B[i][j]) for j in range(3)] for i in range(3)]


def m33_scale(A, s):
    return [[smul(A[i][j], s) for j in range(3)] for i in range(3)]


def m33_eye():
    return [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]


def m33_skew(v):
    return [
        [0.0, sneg(v[2]), v[1]],
        [v[2], 0.0, sneg(v[0])],
        [sneg(v[1]), v[0], 0.0],
    ]


def quat_to_m33(q):
    w, x, y, z = q
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]


def quat_mul_s(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return [
        ssub(ssub(ssub(smul(w1, w2), smul(x1, x2)), smul(y1, y2)), smul(z1, z2)),
        ssub(sadd(sadd(smul(w1, x2), smul(x1, w2)), smul(y1, z2)), smul(z1, y2)),
        sadd(sadd(ssub(smul(w1, y2), smul(x1, z2)), smul(y1, w2)), smul(z1, x2)),
        sadd(ssub(sadd(smul(w1, z2), smul(x1, y2)), smul(y1, x2)), smul(z1, w2)),
    ]


def quat_integrate_s(q, omega, dt):
    """Renormalized q ← q + dt·½ q⊗[0,ω] (spatial.quat_integrate)."""
    dq = quat_mul_s(q, [0.0, omega[0], omega[1], omega[2]])
    qn = [q[i] + dt * 0.5 * dq[i] for i in range(4)]
    inv = srecip(ssqrt(qn[0] ** 2 + qn[1] ** 2 + qn[2] ** 2 + qn[3] ** 2))
    return [c * inv for c in qn]


def axis_angle_to_m33(axis, angle):
    """Rodrigues for a CONSTANT (python float) unit axis, per-env angle."""
    s, c = torch.sin(angle), torch.cos(angle)
    one_minus_c = 1.0 - c
    K = m33_skew(axis)
    KK = m33_mul(K, K)
    E = m33_eye()
    return [
        [
            sadd(sadd(E[i][j], smul(s, K[i][j])), smul(one_minus_c, KK[i][j]))
            for j in range(3)
        ]
        for i in range(3)
    ]


# --------------------------------------------------- factored X transforms
# X = (E, r): motion map [ω;v] ↦ [Eω; E(v − r×ω)]  (spatial.xmat)

def x_motion(X, sv):
    E, r = X
    w = sv[:3]
    v = sv[3:]
    Ew = m33_vec(E, w)
    Evr = m33_vec(E, v3_sub(v, v3_cross(r, w)))
    return Ew + Evr


def x_motion_T(X, sv):
    """Xᵀ sv (used for force accumulation f_parent += Xupᵀ f_child:
    xmat(E,r)ᵀ [a;b] = [Eᵀa + r×(Eᵀb); Eᵀb])."""
    E, r = X
    a, b = sv[:3], sv[3:]
    Etb = m33_T_vec(E, b)
    Eta = m33_T_vec(E, a)
    return v3_add(Eta, v3_cross(r, Etb)) + Etb


def x_force_inv_T(R_w, p_w, f_world):
    """^i X*_0 applied to a world spatial force [n;f] about the world
    origin, for a body at world pose (R_w, p_w):
    n_body = Rᵀ(n − p×f), f_body = Rᵀ f  (spatial.xmat_force with E=Rᵀ, r=p)."""
    n, f = f_world[:3], f_world[3:]
    return m33_T_vec(R_w, v3_sub(n, v3_cross(p_w, f))) + m33_T_vec(R_w, f)


def crm_motion(v, u):
    """Spatial motion cross product v ×ₘ u (spatial.crm)."""
    w, vl = v[:3], v[3:]
    uw, ul = u[:3], u[3:]
    return v3_cross(w, uw) + v3_add(v3_cross(vl, uw), v3_cross(w, ul))


def crf_force(v, f):
    """Spatial force cross product v ×* f = -crm(v)ᵀ f (spatial.crf)."""
    w, vl = v[:3], v[3:]
    n, fl = f[:3], f[3:]
    return v3_add(v3_cross(w, n), v3_cross(vl, fl)) + v3_cross(w, fl)


# ------------------------------------------------------------ 6×6 inertia

def sv6_add(a, b):
    return [sadd(a[i], b[i]) for i in range(6)]


def sv6_sub(a, b):
    return [ssub(a[i], b[i]) for i in range(6)]


def sv6_zero():
    return [0.0] * 6


def m66_vec(M, v):
    """M v with structural-zero folding."""
    out = []
    for i in range(6):
        acc = 0.0
        for j in range(6):
            acc = sadd(acc, smul(M[i][j], v[j]))
        out.append(acc)
    return out


def m66_add(A, B):
    return [[sadd(A[i][j], B[i][j]) for j in range(6)] for i in range(6)]


def spatial_inertia_s(mass, com, inertia_com):
    """6×6 spatial inertia about the body origin (spatial.spatial_inertia).
    mass/com/inertia are CONSTANTS (python floats / nested lists) — the
    whole block is python floats."""
    C = m33_skew(list(com))
    CCt = m33_mul(C, m33_T(C))
    I_bar = [[inertia_com[i][j] + mass * CCt[i][j] for j in range(3)] for i in range(3)]
    mC = m33_scale(C, mass)
    mCt = m33_T(mC)
    out = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            out[i][j] = I_bar[i][j]
            out[i][3 + j] = mC[i][j]
            out[3 + i][j] = mCt[i][j]
    out[3][3] = out[4][4] = out[5][5] = mass
    return out


def x_T_I_x(X, Ic):
    """Xᵀ Ic X for a factored motion transform X=(E,r) and 6×6 inertia Ic —
    the CRBA composite-inertia propagation (dynamics.mass_matrix), done in
    3×3 blocks so the structural zeros of X never generate ops:

    X = [[E, 0], [Y, E]] with Y = -E·skew(r); Ic = [[A, B], [C, D]] →
    XᵀIcX = [[Eᵀ(AE+BY) + Yᵀ(CE+DY), Eᵀ·B·E + Yᵀ·D·E],
             [Eᵀ(CE+DY),              Eᵀ·D·E           ]]

    Ic is SYMMETRIC (spatial inertia: A=Aᵀ, D=Dᵀ, C=Bᵀ) and stays so
    through CRBA accumulation, hence XᵀIcX is symmetric: the bottom-left
    block is TRᵀ for free, and TL/BR need only their upper triangles.
    """
    E, r = X
    Y = m33_scale(m33_mul(E, m33_skew(r)), -1.0)
    A = [row[:3] for row in Ic[:3]]
    B = [row[3:] for row in Ic[:3]]
    C = [row[:3] for row in Ic[3:]]
    D = [row[3:] for row in Ic[3:]]
    Et = m33_T(E)
    Yt = m33_T(Y)
    AE_BY = m33_add(m33_mul(A, E), m33_mul(B, Y))
    CE_DY = m33_add(m33_mul(C, E), m33_mul(D, Y))
    BE = m33_mul(B, E)
    DE = m33_mul(D, E)

    def mulpair_sym(P, U, Q, V):
        """P·U + Q·V, result known symmetric: compute upper, mirror."""
        out = [[0.0] * 3 for _ in range(3)]
        for i in range(3):
            for j in range(i, 3):
                colU = [U[0][j], U[1][j], U[2][j]]
                s = v3_dot(P[i], colU)
                if Q is not None:
                    colV = [V[0][j], V[1][j], V[2][j]]
                    s = sadd(s, v3_dot(Q[i], colV))
                out[i][j] = s
                out[j][i] = s
        return out

    TL = mulpair_sym(Et, AE_BY, Yt, CE_DY)
    TR = m33_add(m33_mul(Et, BE), m33_mul(Yt, DE))
    BR = mulpair_sym(Et, DE, None, None)
    out = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            out[i][j] = TL[i][j]
            out[i][3 + j] = TR[i][j]
            out[3 + i][j] = TR[j][i]  # BL = TRᵀ by symmetry
            out[3 + i][3 + j] = BR[i][j]
    return out
