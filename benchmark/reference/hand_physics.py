"""A plain engine of the AllegroHand's control step, written from the
constants in the configuration's ``physics`` section, to judge the hand's
physics: the 16 position-driven hinges (4 fingers of an abduction hinge and
three curl hinges, rooted at the palm rim), the free cube, and the anchored
penalty contacts of the finger spheres with the palm and the cube and of
the cube's corners with the palm.

Its formulation is its own: world-frame kinematics of each finger, the
finger's joint-space mass matrix from the links' Jacobians, the velocity
products by a world-frame recursion with no joint acceleration, Newton and
Euler for the cube in its body frame, and each contact pair group as one
tensor over its pairs. What it shares with the task is the model it
defines: the contact law, the gains' rules, the servo, the limits and the
semi-implicit Euler step with its speed cap.

State layout, as the task keeps it: ``q`` [E, 23] (16 hinge angles, the
cube's position and unit quaternion w, x, y, z), ``qd`` [E, 22] (16 hinge
rates, the cube's body-frame angular and linear velocity), ``contact``
[E, 160] (40 pairs of an anchor and an engaged flag: finger spheres vs the
palm, finger spheres vs the cube, anchored in the cube's frame, the cube's
corners vs the palm).

``tf32`` runs it in float32 with every matrix product's operands rounded
to TF32 (10 mantissa bits), the precision below the configuration's fp32;
the reference proper runs in float64.
"""

from __future__ import annotations

import math

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value, halves away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def dot(a, b):
    return (a * b).sum(-1)


def pair_gains(phys: dict, m_eff: float, n_share: int) -> dict:
    """The gains of a contact pair of apparent mass ``m_eff`` shared by
    ``n_share`` contacts: the normal spring at the model's stiffness below
    the explicit step's spring bound, damping at the target ratio below the
    viscous bound, the tangential anchor spring below the spring bound."""
    dt = phys["dt"]
    m_s = max(m_eff / max(n_share, 1), 1e-9)
    kp = min(phys["contact_kp"], 0.9 * m_s / dt**2)
    visc = 0.7 * m_s / dt
    return dict(kp=kp, kd=min(2.0 * phys["contact_zeta"] * math.sqrt(kp * m_s), visc), mu=phys["friction_mu"],
                cap=phys["contact_force_cap"], kpt=min(kp, 0.8 * m_s / dt**2), kdt=visc)


class HandEngine:
    """The hand's control step over a batch of envs (any leading size)."""

    def __init__(self, phys: dict, device, tf32: bool = False):
        self.p, self.tf32 = phys, tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        self.device = device
        F, L = phys["n_fingers"], phys["links_per_finger"]
        self.F, self.L, self.n = F, L, F * L
        t = lambda x: torch.tensor(x, dtype=self.dtype, device=device)  # noqa: E731
        phi = [math.pi / 4 + f * 2 * math.pi / F for f in range(F)]
        out = [[math.cos(a), math.sin(a), 0.0] for a in phi]  # outward along the rim anchor
        tangent = [[-math.sin(a), math.cos(a), 0.0] for a in phi]  # the curl axis
        ln = phys["link_len"]
        self.base = t([[phys["finger_base_r"] * d[0], phys["finger_base_r"] * d[1], phys["finger_base_z"]]
                       for d in out])  # [F, 3]: each finger's first hinge
        self.axis = t([[[0.0, 0.0, 1.0]] + [tangent[f]] * (L - 1) for f in range(F)])  # [F, L, 3], link frames
        self.link = t([[-ln * c for c in d] for d in out])  # [F, 3]: a link, joint to joint (= to its sphere)
        self.com = t([[-0.5 * ln * c for c in d] for d in out])  # [F, 3]
        m = phys["link_mass"]
        i_perp = m * ln**2 / 3.0
        eye = torch.eye(3, dtype=self.dtype, device=device)
        dd = torch.stack([torch.outer(d, d) for d in t(out)])
        self.inertia = i_perp * (eye - dd) + phys["link_inertia_floor"] * eye  # [F, 3, 3] about the com
        lo = [phys["abduction_limit"][0] if k % L == 0 else phys["curl_limit"][0] for k in range(self.n)]
        hi = [phys["abduction_limit"][1] if k % L == 0 else phys["curl_limit"][1] for k in range(self.n)]
        self.lo, self.hi = t(lo).view(F, L), t(hi).view(F, L)
        self.gravity = t([0.0, 0.0, phys["gravity"]])
        h, mc = phys["cube_half"], phys["cube_mass"]
        self.cube_inertia = (mc / 6.0) * (2 * h) ** 2 * eye
        self.cube_inertia_inv = torch.linalg.inv(self.cube_inertia)
        lam = (mc / 6.0) * (2 * h) ** 2  # the cube's smallest principal inertia
        m_face = 1.0 / (1.0 / mc + h * h / lam)
        m_corner = 1.0 / (1.0 / mc + 3 * h * h / lam)
        ms = phys["sphere_m_eff"]
        self.g_ground = pair_gains(phys, ms, 1)
        self.g_cube = pair_gains(phys, 1.0 / (1.0 / ms + 1.0 / m_face), phys["finger_cube_share"])
        self.g_cube["kdt"] *= phys["finger_cube_kdt_scale"]
        self.g_corner = pair_gains(phys, m_corner, phys["corner_share"])
        self.corners = t([[sx * h, sy * h, sz * h] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                          for sz in (-1.0, 1.0)])  # [8, 3], x slowest

    # ------------------------------------------------------------ algebra

    def mm(self, a, b):
        """A matrix product; in the control, of TF32 operands."""
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def mv(self, m, v):
        return self.mm(m, v.unsqueeze(-1)).squeeze(-1)

    def rotation(self, axis, angle):
        """Rodrigues: rotation by ``angle`` [...] about the unit ``axis`` [..., 3]."""
        x, y, z = axis.unbind(-1)
        zero = torch.zeros_like(x)
        k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).view(axis.shape[:-1] + (3, 3))
        s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None, None]
        eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
        return eye + s * k + (1.0 - c) * self.mm(k, k)

    @staticmethod
    def quat_matrix(q):
        w, x, y, z = q.unbind(-1)
        return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1
                           ).view(q.shape[:-1] + (3, 3))

    @staticmethod
    def quat_mul(a, b):
        w1, x1, y1, z1 = a.unbind(-1)
        w2, x2, y2, z2 = b.unbind(-1)
        return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)

    # ------------------------------------------------------------ contacts

    @staticmethod
    def anchored(depth, normal, vel, dx, engaged, g):
        """The anchored penalty law of one pair group: a capped spring and
        damper along the normal while the pair penetrates; tangentially an
        anchor spring (from the first touch on) plus damping, held inside
        the Coulomb cone, the anchor dragged to the cone when it slides.
        Returns (force, the point's offset from its new anchor, engaged)."""
        active = (depth > 0).to(depth.dtype)
        vn = dot(vel, normal)
        fn = torch.clamp(g["kp"] * depth - g["kd"] * vn, min=0.0, max=g["cap"]) * active
        vt = vel - normal * vn[..., None]
        dxt = dx - normal * dot(dx, normal)[..., None]
        eng = (active * engaged)[..., None]
        damp = g["kdt"] * vt * active[..., None]
        ft_raw = -(g["kpt"] * dxt * eng + damp)
        scale = torch.clamp(g["mu"] * fn / (torch.linalg.vector_norm(ft_raw, dim=-1) + 1e-9), max=1.0)[..., None]
        ft = ft_raw * scale
        offset = torch.where(scale < 1.0, -(ft + damp) / g["kpt"], dxt) * eng
        return fn[..., None] * normal + ft, offset, active

    def sphere_in_cube(self, local):
        """The cube-frame normal and depth of a finger sphere whose centre
        is at ``local``: outside, from the closest surface point; inside, out
        through the face of the largest |local| (the first on a tie), at the
        shallowest face's depth."""
        h, r = self.p["cube_half"], self.p["sphere_radius"]
        closest = torch.clamp(local, -h, h)
        delta = local - closest
        dist = torch.linalg.vector_norm(delta, dim=-1) + 1e-9
        inside = (local.abs() < h).all(-1)
        a = local.abs() / h
        pick0 = (a[..., 0] >= a[..., 1]) & (a[..., 0] >= a[..., 2])
        pick1 = ~pick0 & (a[..., 1] >= a[..., 2])
        pick = torch.stack([pick0, pick1, ~pick0 & ~pick1], -1).to(local.dtype)
        n_in = torch.sign(local) * pick
        normal = torch.where(inside[..., None], n_in, delta / dist[..., None])
        depth = torch.where(inside, r + (h - closest.abs()).amin(-1), r - dist)
        return normal, depth

    # ---------------------------------------------------------------- step

    def substep(self, q, qd, act, cs, contacts: bool = True):
        E, F, L, p = q.shape[0], self.F, self.L, self.p
        theta, rate = q[:, :self.n].view(E, F, L), qd[:, :self.n].view(E, F, L)
        pos, quat = q[:, self.n:self.n + 3], q[:, self.n + 3:self.n + 7]
        omega, vel = qd[:, self.n:self.n + 3], qd[:, self.n + 3:self.n + 6]

        # finger kinematics, world frame; link l turns about a_l at its joint j_l
        R, joint, axis = [], [], []
        for l in range(L):  # noqa: E741
            turn = self.rotation(self.axis[:, l], theta[..., l])  # [E, F, 3, 3]
            if l == 0:
                R.append(turn)
                joint.append(self.base.expand(E, F, 3))
                axis.append(self.axis[:, 0].expand(E, F, 3))
            else:
                R.append(self.mm(R[l - 1], turn))
                joint.append(joint[l - 1] + self.mv(R[l - 1], self.link.expand(E, F, 3)))
                axis.append(self.mv(R[l - 1], self.axis[:, l].expand(E, F, 3)))
        tip = [joint[l] + self.mv(R[l], self.link.expand(E, F, 3)) for l in range(L)]
        com = [joint[l] + self.mv(R[l], self.com.expand(E, F, 3)) for l in range(L)]
        # angular velocity, and the angular and joint accelerations with no joint acceleration
        w, acc_ang, acc_j = [], [], []
        for l in range(L):  # noqa: E741
            spin = axis[l] * rate[..., l, None]
            if l == 0:
                w.append(spin)
                acc_ang.append(torch.zeros_like(spin))
                acc_j.append(torch.zeros_like(spin))
            else:
                r = joint[l] - joint[l - 1]
                w.append(w[l - 1] + spin)
                acc_ang.append(acc_ang[l - 1] + cross(w[l - 1], spin))
                acc_j.append(acc_j[l - 1] + cross(acc_ang[l - 1], r) + cross(w[l - 1], cross(w[l - 1], r)))
        a = torch.stack(axis, 2)  # [E, F, L(joint), 3]
        js = torch.stack(joint, 2)
        lower = torch.tril(torch.ones(L, L, dtype=q.dtype, device=q.device))  # [link, joint]: joint j moves link l >= j

        def jac(x):
            """[E, F, L(link), 3, L(joint)]: the linear Jacobian of the point x[.., l, :] on link l."""
            lin = cross(a[:, :, None, :, :], x[:, :, :, None, :] - js[:, :, None, :, :])  # [E, F, l, j, 3]
            return (lin * lower[None, None, :, :, None]).transpose(-1, -2)

        tips = torch.stack(tip, 2)
        jt = jac(tips)
        tip_vel = self.mv(jt, rate[:, :, None, :].expand(E, F, L, L))

        # the cube
        Rb = self.quat_matrix(quat)
        cube_force = self.gravity * p["cube_mass"]
        cube_force = cube_force.expand(E, 3)
        cube_torque = torch.zeros_like(cube_force)
        tip_force = torch.zeros_like(tips)
        cs_new = cs
        if contacts:
            cs4 = cs.view(E, -1, 4)
            n = self.n
            up = torch.zeros_like(tips)
            up[..., 2] = 1.0
            # finger spheres vs the palm plane, world anchors
            f, off, on = self.anchored(p["sphere_radius"] - tips[..., 2], up, tip_vel,
                                       tips - cs4[:, :n, :3].view(E, F, L, 3), cs4[:, :n, 3].view(E, F, L),
                                       self.g_ground)
            ground = torch.cat([(tips - off).reshape(E, n, 3), on.reshape(E, n, 1)], -1)
            tip_force = tip_force + f
            # finger spheres vs the cube, anchors in the cube's frame
            Rb_f = Rb[:, None, None]
            rel = tips - pos[:, None, None, :]
            local = self.mv(Rb_f.transpose(-1, -2), rel)
            normal, depth = self.sphere_in_cube(local)
            surface_vel = self.mv(Rb_f, vel[:, None, None, :] + cross(omega[:, None, None, :], local))
            rel_vel = self.mv(Rb_f.transpose(-1, -2), tip_vel - surface_vel)
            f_l, off, on = self.anchored(depth, normal, rel_vel, local - cs4[:, n:2 * n, :3].view(E, F, L, 3),
                                         cs4[:, n:2 * n, 3].view(E, F, L), self.g_cube)
            f = self.mv(Rb_f, f_l)
            touch = torch.cat([(local - off).reshape(E, n, 3), on.reshape(E, n, 1)], -1)
            tip_force = tip_force + f
            cube_force = cube_force - f.sum((1, 2))
            cube_torque = cube_torque - cross(rel, f).sum((1, 2))
            # the cube's corners vs the palm plane, world anchors
            c_rel = self.mv(Rb[:, None], self.corners.expand(E, 8, 3))
            c_pos = pos[:, None, :] + c_rel
            c_vel = self.mv(Rb[:, None], vel[:, None, :] + cross(omega[:, None, :], self.corners.expand(E, 8, 3)))
            up8 = torch.zeros_like(c_pos)
            up8[..., 2] = 1.0
            f, off, on = self.anchored(-c_pos[..., 2], up8, c_vel, c_pos - cs4[:, 2 * n:, :3], cs4[:, 2 * n:, 3],
                                       self.g_corner)
            corner = torch.cat([c_pos - off, on[..., None]], -1)
            cube_force = cube_force + f.sum(1)
            cube_torque = cube_torque + cross(c_rel, f).sum(1)
            cs_new = torch.cat([ground, touch, corner], 1).reshape(E, -1)

        # the fingers: M(θ) θ̈ = τ − bias, link by link from the Jacobians
        coms = torch.stack(com, 2)
        jc = jac(coms)  # [E, F, l, 3, j]
        jw = (a[:, :, None, :, :] * lower[None, None, :, :, None]).transpose(-1, -2)  # [E, F, l, 3, j]
        Rl = torch.stack(R, 2)
        Iw = self.mm(self.mm(Rl, self.inertia[None, :, None]), Rl.transpose(-1, -2))
        m = p["link_mass"]
        M = (m * self.mm(jc.transpose(-1, -2), jc) + self.mm(self.mm(jw.transpose(-1, -2), Iw), jw)).sum(2)
        M = M + p["armature"] * torch.eye(L, dtype=q.dtype, device=q.device)
        ws, aw = torch.stack(w, 2), torch.stack(acc_ang, 2)
        r_c = coms - js
        acc_c = torch.stack(acc_j, 2) + cross(aw, r_c) + cross(ws, cross(ws, r_c))
        wrench_ang = self.mv(Iw, aw) + cross(ws, self.mv(Iw, ws))
        bias = (self.mv(jc.transpose(-1, -2), m * (acc_c - self.gravity))
                + self.mv(jw.transpose(-1, -2), wrench_ang)).sum(2)
        bias = bias - self.mv(jt.transpose(-1, -2), tip_force).sum(2) + p["damping"] * rate
        act4 = act.view(E, F, L)
        mid, half = 0.5 * (self.lo + self.hi), 0.5 * (self.hi - self.lo)
        servo = p["act_kp"] * (mid + half * torch.clamp(act4, -1.0, 1.0) - theta) - p["act_kd"] * rate
        tau = torch.clamp(servo, -p["gear"], p["gear"])
        tau = tau - p["limit_stiffness"] * (torch.clamp(theta - self.hi, min=0.0) + torch.clamp(theta - self.lo, max=0.0))
        theta_dd = torch.linalg.solve(M, tau - bias)

        # the cube: Newton and Euler in its body frame
        f_b = self.mv(Rb.transpose(-1, -2), cube_force)
        t_b = self.mv(Rb.transpose(-1, -2), cube_torque)
        vel_d = f_b / p["cube_mass"] - cross(omega, vel)
        omega_d = self.mv(self.cube_inertia_inv, t_b - cross(omega, self.mv(self.cube_inertia, omega)))

        # semi-implicit Euler with the speed cap
        cap, dt = p["max_dof_speed"], p["dt"]
        rate2 = torch.clamp(rate + dt * theta_dd, -cap, cap).reshape(E, self.n)
        omega2 = torch.clamp(omega + dt * omega_d, -cap, cap)
        vel2 = torch.clamp(vel + dt * vel_d, -cap, cap)
        pos2 = pos + dt * self.mv(Rb, vel2)
        spin = self.quat_mul(quat, torch.cat([torch.zeros_like(omega2[:, :1]), omega2], -1))
        quat2 = quat + 0.5 * dt * spin
        quat2 = quat2 / torch.linalg.vector_norm(quat2, dim=-1, keepdim=True)
        q2 = torch.cat([q[:, :self.n] + dt * rate2, pos2, quat2], -1)
        return q2, torch.cat([rate2, omega2, vel2], -1), cs_new

    def control_step(self, q, qd, action, contact, contacts: bool = True):
        """The task's ``substeps`` substeps with one action; the inputs in
        the engine's precision."""
        for _ in range(self.p["substeps"]):
            q, qd, contact = self.substep(q, qd, action, contact, contacts)
        return q, qd, contact
