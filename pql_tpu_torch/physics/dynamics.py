"""Articulated rigid-body forward dynamics, CRBA + RNEA (port of
pql_tpu/physics/dynamics.py).

nv is small (Ant: 14), so the joint-space approach — mass matrix via the
Composite Rigid Body Algorithm, bias forces via the Recursive Newton-Euler
Algorithm, one dense solve — is both simple and fast: body loops unroll
in Python.

Conventions per Featherstone (see pql_tpu_torch.physics.spatial). Gravity
enters RNEA through a fictitious base acceleration; contacts enter as
world-frame spatial forces per body (see pql_tpu_torch.physics.contact).

Two forms, as in the JAX package:

- the matrix form (``fwd_kinematics`` … ``spd_solve``), batched over a
  leading env dimension with [E, 6, 6] tensors: the readable reference the
  tests hold the scalar form against;
- the scalar hot path (``_kin_s`` … ``fd_step``): every small matrix or
  vector is a nested list of [E] tensors and Python-float constants
  (pql_tpu_torch.physics.scalar_algebra). Where the JAX package indexes a
  per-env vector under ``vmap`` (``q[i]``, ``action[k]``), the scalar
  functions take a LIST of [E] columns; the stacked-array entry points
  (``physics_step``, ``physics_substeps``, ``fd_step``) take [E, n]
  tensors, split them into columns once and stack once on exit.

No function here syncs with the host, so a control step can be captured
in a CUDA graph (pql_tpu_torch.envs.rigid).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pql_tpu_torch.physics import scalar_algebra as sa
from pql_tpu_torch.physics import spatial as sp
from pql_tpu_torch.physics.model import FREE, HINGE, RigidBodyModel


def _const(x, like: torch.Tensor) -> torch.Tensor:
    """A model constant (numpy) as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def _mv(M, x):
    """Batched matrix-vector product M @ x over leading dimensions."""
    return (M @ x[..., None])[..., 0]


def _columns(x: torch.Tensor) -> list[torch.Tensor]:
    """[E, n] → n contiguous [E] columns (one transposing copy)."""
    return list(x.t().contiguous().unbind(0))


def _stack(cols, ref: torch.Tensor) -> torch.Tensor:
    """[E] columns (python floats broadcast against ``ref``) → [E, n]."""
    return torch.stack([c if isinstance(c, torch.Tensor) else torch.full_like(ref, c) for c in cols], -1)


def fwd_kinematics(model: RigidBodyModel, q: torch.Tensor):
    """World poses + joint transforms for q [E, nq].

    Returns (R_wb [E,nb,3,3], p_wb [E,nb,3], Xup: list of [E,6,6] ^i X_parent,
    S: list of [6, nv_i] motion subspaces).
    """
    R_wb, p_wb, Xup, S = [], [], [], []
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device)
    for i in range(model.nb):
        qs = model.q_start[i]
        par = model.parent[i]
        if model.joint_type[i] == FREE:
            pos = q[..., qs : qs + 3]
            quat = q[..., qs + 3 : qs + 7]
            R = sp.quat_to_mat(quat)
            R_wb.append(R)
            p_wb.append(pos)
            Xup.append(sp.xmat(R.transpose(-1, -2), pos))  # parent is world
            S.append(torch.eye(6, dtype=q.dtype, device=q.device))
        else:
            theta = q[..., qs]
            axis = _const(model.joint_axis[i], q)
            Rj = sp.axis_angle_to_mat(axis, theta)  # child→parent rotation
            tp = _const(model.tree_pos[i], q)
            Rp = R_wb[par] if par >= 0 else eye3
            pp = p_wb[par] if par >= 0 else torch.zeros_like(tp)
            R = Rp @ Rj
            p = pp + _mv(Rp, tp)
            R_wb.append(R)
            p_wb.append(p.expand(q.shape[:-1] + (3,)))
            # ^i X_parent = rot(Rj^T) · xlt(tree_pos)
            Xup.append(sp.xmat(Rj.transpose(-1, -2), tp))
            S.append(torch.cat([axis, torch.zeros_like(axis)])[:, None])
    return torch.stack(R_wb, -3), torch.stack(p_wb, -2), Xup, S


def body_velocities(model: RigidBodyModel, Xup, S, qd):
    """Body-frame spatial velocities v_i = ^i X_p v_p + S_i q̇_i ([E, 6] each)."""
    v = []
    for i in range(model.nb):
        vs, nvi = model.v_start[i], model.nv_per_joint[i]
        vj = _mv(S[i], qd[..., vs : vs + nvi])
        par = model.parent[i]
        v.append(vj if par < 0 else _mv(Xup[i], v[par]) + vj)
    return v


def _inertias(model: RigidBodyModel, like: torch.Tensor):
    return [
        sp.spatial_inertia(
            float(model.mass[i]), _const(model.com[i], like), _const(model.inertia[i], like)
        )
        for i in range(model.nb)
    ]


def mass_matrix(model: RigidBodyModel, Xup, S):
    """CRBA; armature added on the diagonal. Returns [E, nv, nv]."""
    like = Xup[0]
    Ic = _inertias(model, like)
    for i in reversed(range(model.nb)):
        par = model.parent[i]
        if par >= 0:
            Ic[par] = Ic[par] + Xup[i].transpose(-1, -2) @ Ic[i] @ Xup[i]

    M = like.new_zeros(like.shape[:-2] + (model.nv, model.nv))
    for i in range(model.nb):
        vi, nvi = model.v_start[i], model.nv_per_joint[i]
        F = Ic[i] @ S[i]  # [E, 6, nvi]
        M[..., vi : vi + nvi, vi : vi + nvi] = S[i].T @ F
        j = i
        while model.parent[j] >= 0:
            F = Xup[j].transpose(-1, -2) @ F
            j = model.parent[j]
            vj, nvj = model.v_start[j], model.nv_per_joint[j]
            blk = S[j].T @ F  # [E, nvj, nvi]
            M[..., vj : vj + nvj, vi : vi + nvi] = blk
            M[..., vi : vi + nvi, vj : vj + nvj] = blk.transpose(-1, -2)
    return M + torch.diag(_const(model.armature, like))


def bias_forces(model: RigidBodyModel, Xup, S, v, qd, f_ext_world, R_wb, p_wb):
    """RNEA with q̈ = 0: Coriolis/centrifugal + gravity − external forces,
    plus joint damping. f_ext_world: [E, nb, 6] spatial forces about the
    world origin, world coords. Returns [E, nv]."""
    # gravity as fictitious base acceleration (RBDA §5.3)
    a_base = _const([0.0, 0.0, 0.0, 0.0, 0.0, -model.gravity], qd)
    Ic = _inertias(model, qd)
    a, f = [], []
    for i in range(model.nb):
        vs, nvi = model.v_start[i], model.nv_per_joint[i]
        vj = _mv(S[i], qd[..., vs : vs + nvi])
        par = model.parent[i]
        a_par = _mv(Xup[i], a_base if par < 0 else a[par])
        a.append(a_par + _mv(sp.crm(v[i]), vj))
        fi = _mv(Ic[i], a[i]) + _mv(sp.crf(v[i]), _mv(Ic[i], v[i]))
        # external force: world-origin coords → body coords via ^i X*_0
        fi = fi - _mv(sp.xmat_force(R_wb[..., i, :, :].transpose(-1, -2), p_wb[..., i, :]), f_ext_world[..., i, :])
        f.append(fi)

    C = qd.new_zeros(qd.shape)
    for i in reversed(range(model.nb)):
        vs, nvi = model.v_start[i], model.nv_per_joint[i]
        C[..., vs : vs + nvi] = _mv(S[i].T, f[i])
        par = model.parent[i]
        if par >= 0:
            f[par] = f[par] + _mv(Xup[i].transpose(-1, -2), f[i])

    # joint damping + hinge limit springs in joint space
    return C + _const(model.damping, qd) * qd


def _limit_torque(model: RigidBodyModel, q: torch.Tensor) -> torch.Tensor:
    """Soft joint-limit restoring torque for hinge dofs ([E, nv])."""
    tau = q.new_zeros(q.shape[:-1] + (model.nv,))
    for i in range(model.nb):
        if model.joint_type[i] != HINGE:
            continue
        qs, vs = model.q_start[i], model.v_start[i]
        lo = float(model.limit_lo[vs])
        hi = float(model.limit_hi[vs])
        over = torch.clamp_min(q[..., qs] - hi, 0.0) + torch.clamp_max(q[..., qs] - lo, 0.0)
        tau[..., vs] = -model.limit_stiffness * over
    return tau


def actuation(model: RigidBodyModel, action, q=None, qd=None):
    """Map [-1,1]^nu policy actions [E, nu] to joint torques [E, nv].

    Matrix-path reference for the scalar ``_tau_s``: torque mode scales
    by gear; position mode (IGE DOF_MODE_POS) runs the PD servo with
    gear as the effort cap (pass q, qd)."""
    tau = action.new_zeros(action.shape[:-1] + (model.nv,))
    if model.control_mode == "position":
        for k, dof in enumerate(model.actuated_dofs):
            lo, hi = float(model.limit_lo[dof]), float(model.limit_hi[dof])
            mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
            target = mid + half * torch.clamp(action[..., k], -1.0, 1.0)
            pd = model.act_kp * (target - q[..., model.q_of_dof[dof]]) - model.act_kd * qd[..., dof]
            g = float(model.gear[k])
            tau[..., dof] = torch.clamp(pd, -g, g)
        return tau
    for k, dof in enumerate(model.actuated_dofs):
        tau[..., dof] = float(model.gear[k]) * torch.clamp(action[..., k], -1.0, 1.0)
    return tau


def spd_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b for SPD M [..., n, n] via an unrolled Cholesky
    factorization (the JAX package's form; M is SPD by construction: CRBA
    mass matrix + armature diagonal)."""
    n = M.shape[-1]
    # Cholesky: L (lower) with M = L Lᵀ, unrolled over static indices
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        s = M[..., i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp_min(s, 1e-12))
        inv = 1.0 / L[i][i]
        for j in range(i + 1, n):
            s = M[..., j, i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution Lᵀ x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


# =====================================================================
# Scalar-unrolled hot path
#
# Every small matrix/vector is a nested Python list of per-env [E]
# tensors and Python-float constants (pql_tpu_torch.physics.scalar_algebra),
# so no [E,3,3]/[E,6,6] intermediate is built, and kinematics are
# computed ONCE per substep for both contacts and dynamics.
# =====================================================================


def _kin_s(model: RigidBodyModel, q):
    """Scalar kinematics from q columns. Returns (R_wb, p_wb, Xup, S_axis):
    per-body rotation m33 / position v3 lists, factored transforms (E, r),
    and the hinge axis (python floats) or None for a free joint."""
    R_wb, p_wb, Xup, S_axis = [], [], [], []
    for i in range(model.nb):
        qs, par = model.q_start[i], model.parent[i]
        if model.joint_type[i] == FREE:
            pos = [q[qs], q[qs + 1], q[qs + 2]]
            quat = [q[qs + 3], q[qs + 4], q[qs + 5], q[qs + 6]]
            R = sa.quat_to_m33(quat)
            R_wb.append(R)
            p_wb.append(pos)
            Xup.append((sa.m33_T(R), pos))  # parent is world
            S_axis.append(None)
        else:
            theta = q[qs]
            axis = [float(a) for a in model.joint_axis[i]]
            Rj = sa.axis_angle_to_m33(axis, theta)
            tp = [float(c) for c in model.tree_pos[i]]
            Rp = R_wb[par] if par >= 0 else sa.m33_eye()
            pp = p_wb[par] if par >= 0 else sa.v3_zero()
            R_wb.append(sa.m33_mul(Rp, Rj))
            p_wb.append(sa.v3_add(pp, sa.m33_vec(Rp, tp)))
            Xup.append((sa.m33_T(Rj), tp))
            S_axis.append(axis)
    return R_wb, p_wb, Xup, S_axis


def _vel_s(model: RigidBodyModel, Xup, S_axis, qd):
    """Body-frame spatial velocities as 6-lists (body_velocities)."""
    v = []
    for i in range(model.nb):
        vs, par = model.v_start[i], model.parent[i]
        if S_axis[i] is None:
            vj = [qd[vs + k] for k in range(6)]
        else:
            a, w = S_axis[i], qd[vs]
            vj = [sa.smul(a[0], w), sa.smul(a[1], w), sa.smul(a[2], w), 0.0, 0.0, 0.0]
        v.append(vj if par < 0 else sa.sv6_add(sa.x_motion(Xup[i], v[par]), vj))
    return v


def _const_inertias(model: RigidBodyModel):
    """Per-body 6×6 spatial inertias as nested PYTHON FLOAT lists."""
    return [
        sa.spatial_inertia_s(
            float(model.mass[i]),
            [float(c) for c in model.com[i]],
            [[float(model.inertia[i][r][c]) for c in range(3)] for r in range(3)],
        )
        for i in range(model.nb)
    ]


def _mass_matrix_s(model: RigidBodyModel, Xup, S_axis):
    """CRBA on scalars; armature on the diagonal (mass_matrix)."""
    Ic = _const_inertias(model)
    for i in reversed(range(model.nb)):
        par = model.parent[i]
        if par >= 0:
            Ic[par] = sa.m66_add(Ic[par], sa.x_T_I_x(Xup[i], Ic[i]))
    nv = model.nv
    M = [[0.0] * nv for _ in range(nv)]
    for i in range(model.nb):
        vi = model.v_start[i]
        if S_axis[i] is None:
            # S = identity: F = Ic columns; M block = Ic itself
            F = [[Ic[i][r][c] for r in range(6)] for c in range(6)]
            for r in range(6):
                for c in range(6):
                    M[vi + r][vi + c] = Ic[i][r][c]
        else:
            a = S_axis[i]
            col = sa.m66_vec(Ic[i], [a[0], a[1], a[2], 0.0, 0.0, 0.0])
            F = [col]
            M[vi][vi] = sa.v3_dot(a, col[:3])
        j = i
        while model.parent[j] >= 0:
            F = [sa.x_motion_T(Xup[j], col) for col in F]
            j = model.parent[j]
            vj = model.v_start[j]
            if S_axis[j] is None:
                for c, col in enumerate(F):
                    for r in range(6):
                        M[vj + r][vi + c] = col[r]
                        M[vi + c][vj + r] = col[r]
            else:
                aj = S_axis[j]
                for c, col in enumerate(F):
                    val = sa.v3_dot(aj, col[:3])
                    M[vj][vi + c] = val
                    M[vi + c][vj] = val
    for d in range(nv):
        M[d][d] = M[d][d] + float(model.armature[d])
    return M


def _bias_forces_s(model, Xup, S_axis, v, qd, f_ext_s, R_wb, p_wb):
    """RNEA with q̈=0 on scalars (bias_forces). f_ext_s: per-body 6-lists
    of world-frame spatial forces about the world origin, or None."""
    Ic = _const_inertias(model)
    a_base = [0.0, 0.0, 0.0, 0.0, 0.0, -model.gravity]
    a, f = [], []
    for i in range(model.nb):
        vs, par = model.v_start[i], model.parent[i]
        if S_axis[i] is None:
            vj = [qd[vs + k] for k in range(6)]
        else:
            ax, w = S_axis[i], qd[vs]
            vj = [sa.smul(ax[0], w), sa.smul(ax[1], w), sa.smul(ax[2], w), 0.0, 0.0, 0.0]
        a_par = sa.x_motion(Xup[i], a_base if par < 0 else a[par])
        a.append(sa.sv6_add(a_par, sa.crm_motion(v[i], vj)))
        Iv = sa.m66_vec(Ic[i], v[i])
        Ia = sa.m66_vec(Ic[i], a[i])
        fi = sa.sv6_add(Ia, sa.crf_force(v[i], Iv))
        if f_ext_s is not None:
            fi = sa.sv6_sub(fi, sa.x_force_inv_T(R_wb[i], p_wb[i], f_ext_s[i]))
        f.append(fi)

    C = [0.0] * model.nv
    for i in reversed(range(model.nb)):
        vs, par = model.v_start[i], model.parent[i]
        if S_axis[i] is None:
            for k in range(6):
                C[vs + k] = f[i][k]
        else:
            ax = S_axis[i]
            C[vs] = sa.v3_dot(ax, f[i][:3])
        if par >= 0:
            f[par] = sa.sv6_add(f[par], sa.x_motion_T(Xup[i], f[i]))
    for d in range(model.nv):
        C[d] = sa.sadd(C[d], sa.smul(float(model.damping[d]), qd[d]))
    return C


def _tau_s(model: RigidBodyModel, q, action, qd=None):
    """Actuation + soft hinge-limit torques (actuation, _limit_torque);
    ``action`` is a list of nu [E] columns.

    control_mode="torque": tau = gear * action (locomotion default).
    control_mode="position": per-substep PD servo — IGE's joint-position
    drive: target = limit midpoint + action * half range,
    tau = clip(kp*(target - q) - kd*qd, ±gear), on the current (q, qd) of
    every substep."""
    tau = [0.0] * model.nv
    if model.control_mode == "position":
        for k, dof in enumerate(model.actuated_dofs):
            lo, hi = float(model.limit_lo[dof]), float(model.limit_hi[dof])
            mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
            # actuated dofs are hinges, whose q slot is model.q_of_dof
            qs = model.q_of_dof[dof]
            target = mid + half * torch.clamp(action[k], -1.0, 1.0)
            pd = model.act_kp * (target - q[qs]) - model.act_kd * (
                qd[dof] if qd is not None else 0.0
            )
            tau[dof] = torch.clamp(pd, -float(model.gear[k]), float(model.gear[k]))
    else:
        for k, dof in enumerate(model.actuated_dofs):
            tau[dof] = float(model.gear[k]) * torch.clamp(action[k], -1.0, 1.0)
    for i in range(model.nb):
        if model.joint_type[i] != HINGE:
            continue
        qs, vs = model.q_start[i], model.v_start[i]
        lo, hi = float(model.limit_lo[vs]), float(model.limit_hi[vs])
        over = torch.clamp_min(q[qs] - hi, 0.0) + torch.clamp_max(q[qs] - lo, 0.0)
        tau[vs] = tau[vs] - model.limit_stiffness * over
    return tau


def _ssqrt(x):
    """sqrt(max(x, 1e-12)) keeping python-float constants constant."""
    if isinstance(x, (int, float)):
        return math.sqrt(max(float(x), 1e-12))
    return torch.sqrt(torch.clamp_min(x, 1e-12))


def _spd_solve_s(M, b):
    """Unrolled Cholesky solve on nested scalar lists (see spd_solve).

    Arithmetic routes through the fold-aware scalar ops, so the solve
    auto-sparsifies: structurally-zero M entries (python 0.0) produce zero
    L entries and no ops, and all-constant blocks fold to python floats."""
    n = len(b)
    L = [[0.0] * n for _ in range(n)]
    inv_d = [0.0] * n
    for i in range(n):
        s = M[i][i]
        for k in range(i):
            s = sa.ssub(s, sa.smul(L[i][k], L[i][k]))
        L[i][i] = _ssqrt(s)
        inv_d[i] = sa.srecip(L[i][i])
        for j in range(i + 1, n):
            s = M[j][i]
            for k in range(i):
                s = sa.ssub(s, sa.smul(L[j][k], L[i][k]))
            L[j][i] = sa.smul(s, inv_d[i])
    y = [0.0] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = sa.ssub(s, sa.smul(L[i][k], y[k]))
        y[i] = sa.smul(s, inv_d[i])
    x = [0.0] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = sa.ssub(s, sa.smul(L[k][i], x[k]))
        x[i] = sa.smul(s, inv_d[i])
    return x


def _integrate_parts(model: RigidBodyModel, q, qd, qdd):
    """Semi-implicit Euler on scalars → (q' list[nq], qd' list[nv])."""
    cap = model.max_dof_speed
    qd_new = [
        torch.clamp(qd[d] + model.dt * qdd[d], -cap, cap) for d in range(model.nv)
    ]
    q_out = [None] * model.nq
    for i in range(model.nb):
        qs, vs = model.q_start[i], model.v_start[i]
        if model.joint_type[i] == FREE:
            quat = [q[qs + 3], q[qs + 4], q[qs + 5], q[qs + 6]]
            Rb = sa.quat_to_m33(quat)
            omega = [qd_new[vs], qd_new[vs + 1], qd_new[vs + 2]]
            vlin = [qd_new[vs + 3], qd_new[vs + 4], qd_new[vs + 5]]
            dp = sa.m33_vec(Rb, vlin)
            for k in range(3):
                q_out[qs + k] = q[qs + k] + model.dt * dp[k]
            qn = sa.quat_integrate_s(quat, omega, model.dt)
            for k in range(4):
                q_out[qs + 3 + k] = qn[k]
        else:
            q_out[qs] = q[qs] + model.dt * qd_new[vs]
    return q_out, qd_new


def _step_parts(model: RigidBodyModel, q, qd, action, contact_fn=None, f_ext_s=None,
                contact_state=None):
    """One scalar substep on per-dof column LISTS q [nq], qd [nv], action
    [nu] → (q' list, qd' list[, contact_state']). Kinematics computed once
    for contacts + dynamics. With contact_state (flat column list),
    contact_fn is stateful: contact_fn(m, R, p, v, cs) → (f_ext, cs')."""
    R_wb, p_wb, Xup, S_axis = _kin_s(model, q)
    v = _vel_s(model, Xup, S_axis, qd)
    cs_new = None
    if contact_fn is not None:
        if contact_state is not None:
            f_ext_s, cs_new = contact_fn(model, R_wb, p_wb, v, contact_state)
        else:
            f_ext_s = contact_fn(model, R_wb, p_wb, v)
    M = _mass_matrix_s(model, Xup, S_axis)
    C = _bias_forces_s(model, Xup, S_axis, v, qd, f_ext_s, R_wb, p_wb)
    tau = _tau_s(model, q, action, qd)
    qdd = _spd_solve_s(M, [sa.ssub(tau[d], C[d]) for d in range(model.nv)])
    q2, qd2 = _integrate_parts(model, q, qd, qdd)
    if contact_state is not None:
        return q2, qd2, cs_new
    return q2, qd2


def physics_step(model: RigidBodyModel, q, qd, action, contact_fn=None):
    """One substep on the scalar hot path for q [E, nq], qd [E, nv],
    action [E, nu], computing kinematics ONCE for both contacts and
    dynamics.

    contact_fn(model, R_wb, p_wb, v) → per-body 6-lists of world-frame
    spatial forces; None = free flight. Returns (q', qd') as [E, n] tensors.
    """
    q2, qd2 = _step_parts(model, _columns(q), _columns(qd), _columns(action), contact_fn)
    return _stack(q2, q[:, 0]), _stack(qd2, q[:, 0])


def physics_substeps(model: RigidBodyModel, q, qd, action, substeps: int, contact_fn=None,
                     contact_state=None):
    """``substeps`` scalar substeps (a Python loop; ``lax.scan`` in the JAX
    package) with PER-DOF [E] COLUMNS as the carry: q, qd, action and the
    contact state are split into columns once on entry, and stacked once
    on exit.

    contact_state: optional [E, nc] anchored-contact state (see
    pql_tpu_torch.physics.contact) — carried as columns through the
    substeps. With it, contact_fn must be the stateful form and the return
    is (q', qd', contact_state')."""
    q_l, qd_l, act = _columns(q), _columns(qd), _columns(action)
    ref = q_l[0]
    if contact_state is None:
        for _ in range(substeps):
            q_l, qd_l = _step_parts(model, q_l, qd_l, act, contact_fn)
        return _stack(q_l, ref), _stack(qd_l, ref)

    cs_l = _columns(contact_state)
    for _ in range(substeps):
        q_l, qd_l, cs_l = _step_parts(model, q_l, qd_l, act, contact_fn, contact_state=cs_l)
    return _stack(q_l, ref), _stack(qd_l, ref), _stack(cs_l, ref)


def _fd_core(model: RigidBodyModel, q, qd, action, f_ext_s):
    """Scalar forward-dynamics step given external forces as 6-lists
    (stacked-array interface for fd_step)."""
    q2, qd2 = _step_parts(
        model, _columns(q), _columns(qd), _columns(action), contact_fn=None, f_ext_s=f_ext_s
    )
    return _stack(q2, q[:, 0]), _stack(qd2, q[:, 0])


def fd_step(model: RigidBodyModel, q, qd, action, f_ext_world):
    """One semi-implicit Euler step of forward dynamics.

    f_ext_world: [E, nb, 6] world-frame spatial contact forces (zeros if
    none). Returns (q', qd', aux) where aux carries kinematics for
    observation construction (R_wb [E,nb,3,3], p_wb [E,nb,3], body
    spatial velocities v_body [E,nb,6]). Runs on the scalar-unrolled core;
    the matrix functions above remain the reference (tests assert they
    agree)."""
    f_ext_s = [[f_ext_world[:, i, j] for j in range(6)] for i in range(model.nb)]
    R_wb, p_wb, Xup, S_axis = _kin_s(model, _columns(q))
    v = _vel_s(model, Xup, S_axis, _columns(qd))
    q_new, qd_new = _fd_core(model, q, qd, action, f_ext_s)
    ref = q[:, 0]
    aux = {
        "R_wb": torch.stack([torch.stack([_stack(r, ref) for r in R], -2) for R in R_wb], -3),
        "p_wb": torch.stack([_stack(p, ref) for p in p_wb], -2),
        "v_body": torch.stack([_stack(x, ref) for x in v], -2),
    }
    return q_new, qd_new, aux
