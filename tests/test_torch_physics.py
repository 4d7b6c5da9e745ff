"""The ported rigid-body engine (pql_tpu_torch.physics) against the JAX package, on the CPU.

States: E = 8 envs of each rigid task (Ant, Humanoid, Anymal) from the JAX
``init_state``, rolled out for ``ROLL`` control steps under uniform actions
drawn with numpy (seed 0) through the JAX engine's ``physics_substeps``
(jitted once per task, the costly part of this file). The last state of
the rollout is the test state: some feet are engaged and some are not, and
of the engaged ones some stick (anchor x, y unchanged over the next control
step) and some slide (``test_rollout_state_engages_sticks_and_slides``). At
those states no contact sits within rounding of the ``depth > 0`` or
``scale < 1`` branch thresholds, so both sides take the same branches; a
flip would show as an error far above the tolerances.

The scalar functions of both packages run on the same per-env columns: the
JAX ones on lists of [E] arrays (they are elementwise, so no ``vmap`` is
needed, except for the contact group, which stacks per pair), the port's
on lists of [E] tensors. Each function gets the same inputs on both sides
where its own inputs would carry an upstream difference (``_bias_forces_s``
gets the JAX contact forces, ``_spd_solve_s`` the JAX M and b).

Tolerances (fp32 on both sides; the two frameworks order some sums
differently and torch may contract a multiply-add into an FMA):
- ``_kin_s``, ``_vel_s``, ``_mass_matrix_s``, ``_bias_forces_s``,
  ``_tau_s`` and ``_spd_solve_s``: rtol 1e-5 with an atol of 1e-6 times
  the largest magnitude of the compared quantity (entries that cancel to
  near zero keep only absolute accuracy);
- ``ground_anchored_v``'s forces and torques: rtol 1e-5, atol
  ``kp_max · 4 · 2⁻²³``. The normal force is kp · depth, and depth is the
  difference of a radius and a position of order 1 m, known to a few ulps
  (2⁻²³ m each), so the stiffest spring turns 4 ulps of position into that
  much force (≈ 0.01 N for Ant's kp = 2e4, against forces of ~100 N);
  torques are those forces times lever arms under 1 m. The new anchors
  and engaged flags: as the first group;
- one control step (``physics_substeps`` with contact state, 4 substeps):
  rtol 1e-4 with atol 1e-5 on q and the contact state, atol 1e-4 on qd.
  Contact accelerations reach ~10⁴ m/s², so a substep's velocity
  increment dt·q̈ is tens of m/s before the terms cancel, and fp32
  rounding of such sums (6e-8 relative) leaves ~1e-5 m/s per substep in
  qd; the largest qd differences seen at these states are 2-4e-5.
- the port's matrix form against its scalar form: as the first group,
  except qd after a step, where the JAX package's own matrix-vs-scalar
  test allows atol 5e-3 (tests/test_scalar_physics.py): the two forms sum
  the CRBA and RNEA terms in different orders.
``point_eff_mass`` and ``derive_pair`` are numpy and Python floats on both
sides and must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pql_tpu.envs.rigid as jrigid
import pql_tpu_torch.envs.rigid as trigid
from pql_tpu.physics import contact as jc
from pql_tpu.physics import dynamics as jd
from pql_tpu.physics import spatial as jsp
from pql_tpu_torch.physics import contact as tc
from pql_tpu_torch.physics import dynamics as td
from pql_tpu_torch.physics import spatial as tsp

TASKS = ("Ant", "Humanoid", "Anymal")
E = 8
ROLL = 30  # control steps before the test state
STEP_TOL = {"q": dict(rtol=1e-4, atol=1e-5), "qd": dict(rtol=1e-4, atol=1e-4), "contact": dict(rtol=1e-4, atol=1e-5)}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(x):
    """Nested lists of [E] arrays / tensors / python floats → numpy [..., E]."""
    if isinstance(x, (list, tuple)):
        return np.stack([_arr(y) for y in x])
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (int, float)):
        return np.full(E, x, np.float32)
    return np.asarray(x)


def _close(got, want, what, rtol=1e-5, atol_rel=1e-6):
    got, want = _arr(got), _arr(want)
    assert got.shape == want.shape, what
    atol = atol_rel * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _cols(a):
    """[E, n] numpy → (JAX columns, port columns)."""
    return [jnp.asarray(a[:, i]) for i in range(a.shape[1])], [torch.from_numpy(a[:, i].copy()) for i in range(a.shape[1])]


def _like(nested, to):
    """Map every array leaf of a nested list (python floats kept) with ``to``."""
    if isinstance(nested, (list, tuple)):
        return [_like(x, to) for x in nested]
    return nested if isinstance(nested, float) else to(nested)


def _to_torch(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=TASKS)
def case(request):
    """One task's models, the rollout's last state and action, and the JAX
    control step from it."""
    jt, pt = getattr(jrigid, request.param)(), getattr(trigid, request.param)()
    m = jt.model
    step = jax.jit(jax.vmap(lambda q, qd, a, cs: jd.physics_substeps(
        m, q, qd, a, jt.substeps, contact_fn=jt._contact_fn, contact_state=cs)))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i))(jnp.arange(E))
    s = jax.vmap(jt.init_state)(keys)
    q, qd, cs = s["q"], s["qd"], s["contact"]
    rng = np.random.RandomState(0)
    for _ in range(ROLL):
        q, qd, cs = step(q, qd, jnp.asarray(rng.uniform(-1, 1, (E, jt.action_dim)).astype(np.float32)), cs)
    action = rng.uniform(-1, 1, (E, jt.action_dim)).astype(np.float32)
    out = step(q, qd, jnp.asarray(action), cs)
    return dict(
        name=request.param, jt=jt, pt=pt, m=m, pm=pt.model,
        q=np.array(q), qd=np.array(qd), cs=np.array(cs), action=action,
        out=tuple(np.array(x) for x in out),
    )


@pytest.mark.parametrize("name", TASKS)
def test_models_and_pair_gains_match_exactly(name):
    jt, pt = getattr(jrigid, name)(), getattr(trigid, name)()
    jm, pm = jt.model, pt.model
    for f in jm.__dataclass_fields__:
        a, b = getattr(jm, f), getattr(pm, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f)
        elif f == "geoms":
            assert [(g.body, g.offset, g.radius, g.m_eff) for g in b] == [
                (g.body, g.offset, g.radius, g.m_eff) for g in a
            ]
        else:
            assert a == b, f
    for g in jm.geoms:
        assert tc.point_eff_mass(pm, g.body, g.offset) == jc.point_eff_mass(jm, g.body, g.offset)
        for m_eff in (tc.point_eff_mass(pm, g.body, g.offset), 0.15, 2.5):
            for n_share in (1, 3):
                want = jc.derive_pair(jm, m_eff, n_share=n_share)
                assert tc.derive_pair(pm, m_eff, n_share=n_share).__dict__ == want.__dict__
    assert [p.__dict__ for p in pt._pp_ground] == [p.__dict__ for p in jt._pp_ground]


def test_spatial_matches_jax():
    """Every function of spatial.py on a batch of 8 random inputs: the port's
    batched form against the JAX function vmapped (rtol 1e-5, as the first
    tolerance group)."""
    rng = np.random.RandomState(0)
    q = rng.normal(size=(E, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v3, w3, v6 = (rng.normal(size=(E, n)).astype(np.float32) for n in (3, 3, 6))
    ang = rng.uniform(-3, 3, E).astype(np.float32)
    axis = np.asarray([0.6, 0.0, 0.8], np.float32)
    mass, com, inertia = 1.5, v3[0], np.diag([0.2, 0.3, 0.4]).astype(np.float32)
    E3 = np.array(jax.vmap(jsp.quat_to_mat)(jnp.asarray(q)))
    t = torch.from_numpy
    cases = [
        ("skew", lambda: jax.vmap(jsp.skew)(v3), lambda: tsp.skew(t(v3))),
        ("quat_mul", lambda: jax.vmap(jsp.quat_mul)(q, q[::-1]), lambda: tsp.quat_mul(t(q), t(q[::-1].copy()))),
        ("quat_rotate", lambda: jax.vmap(jsp.quat_rotate)(q, v3), lambda: tsp.quat_rotate(t(q), t(v3))),
        ("quat_inv", lambda: jax.vmap(jsp.quat_inv)(q), lambda: tsp.quat_inv(t(q))),
        ("quat_to_mat", lambda: E3, lambda: tsp.quat_to_mat(t(q))),
        ("quat_integrate", lambda: jax.vmap(lambda a, b: jsp.quat_integrate(a, b, 1.0 / 240.0))(q, w3),
         lambda: tsp.quat_integrate(t(q), t(w3), 1.0 / 240.0)),
        ("quat_from_axis_angle", lambda: jax.vmap(lambda a: jsp.quat_from_axis_angle(jnp.asarray(axis), a))(ang),
         lambda: tsp.quat_from_axis_angle(t(axis), t(ang))),
        ("axis_angle_to_mat", lambda: jax.vmap(lambda a: jsp.axis_angle_to_mat(jnp.asarray(axis), a))(ang),
         lambda: tsp.axis_angle_to_mat(t(axis), t(ang))),
        ("xmat", lambda: jax.vmap(jsp.xmat)(E3, v3), lambda: tsp.xmat(t(E3), t(v3))),
        ("xmat_force", lambda: jax.vmap(jsp.xmat_force)(E3, v3), lambda: tsp.xmat_force(t(E3), t(v3))),
        ("xmat_inv", lambda: jax.vmap(jsp.xmat_inv)(E3, v3), lambda: tsp.xmat_inv(t(E3), t(v3))),
        ("crm", lambda: jax.vmap(jsp.crm)(v6), lambda: tsp.crm(t(v6))),
        ("crf", lambda: jax.vmap(jsp.crf)(v6), lambda: tsp.crf(t(v6))),
        ("spatial_inertia", lambda: jsp.spatial_inertia(mass, com, inertia),
         lambda: tsp.spatial_inertia(mass, t(com.copy()), t(inertia))),
    ]
    for name, want, got in cases:
        _close(got().numpy(), np.array(want()), name)
    np.testing.assert_array_equal(tsp.quat_identity().numpy(), np.array(jsp.quat_identity()))


def test_rollout_state_engages_sticks_and_slides(case):
    cs0, cs1 = case["cs"], case["out"][2]
    eng0, eng1 = cs0[:, 3::4] > 0.5, cs1[:, 3::4] > 0.5
    moved = (cs1[:, 0::4] != cs0[:, 0::4]) | (cs1[:, 1::4] != cs0[:, 1::4])
    both = eng0 & eng1
    assert eng0.any() and not eng0.all(), "some pairs engaged, some not"
    assert (both & ~moved).any(), "some engaged pairs stick"
    assert (both & moved).any(), "some engaged pairs slide"
    assert np.isfinite(case["q"]).all() and np.isfinite(case["qd"]).all()


def _both_kin(case):
    jq, tq = _cols(case["q"])
    jqd, tqd = _cols(case["qd"])
    return (jq, jqd, jd._kin_s(case["m"], jq)), (tq, tqd, td._kin_s(case["pm"], tq))


def test_kinematics_and_velocities(case):
    (jq, jqd, jk), (tq, tqd, tk) = _both_kin(case)
    for what, j, t in (("R_wb", jk[0], tk[0]), ("p_wb", jk[1], tk[1])):
        _close(t, j, what)
    for i, ((jE, jr), (tE, tr_)) in enumerate(zip(jk[2], tk[2])):
        _close(tE, jE, f"Xup[{i}].E")
        _close(tr_, jr, f"Xup[{i}].r")
    assert tk[3] == jk[3]
    jv = jd._vel_s(case["m"], jk[2], jk[3], jqd)
    tv = td._vel_s(case["pm"], tk[2], tk[3], tqd)
    _close(tv, jv, "v")


def _jax_ground(case):
    """JAX ground_anchored_v (vmapped over envs) at the test state:
    (f_ext [E, nb, 6], contact state' [E, nc])."""
    jt, m = case["jt"], case["m"]

    def one(q, qd, cs):
        R, p, X, S = jd._kin_s(m, [q[i] for i in range(m.nq)])
        v = jd._vel_s(m, X, S, [qd[i] for i in range(m.nv)])
        cs_l = [cs[i] for i in range(cs.shape[0])]
        cs_new = list(cs_l)
        f, _ = jc.ground_anchored_v(m, R, p, v, cs_l, cs_new, 0, jt._pp_ground)
        f = [[x if not isinstance(x, float) else jnp.zeros(()) + x for x in row] for row in f]
        return jnp.stack([jnp.stack(row) for row in f]), jnp.stack(cs_new)

    f, cs_new = jax.vmap(one)(jnp.asarray(case["q"]), jnp.asarray(case["qd"]), jnp.asarray(case["cs"]))
    return np.array(f), np.array(cs_new)


def _port_ground(case, tk, tqd):
    pm, pt = case["pm"], case["pt"]
    v = td._vel_s(pm, tk[2], tk[3], tqd)
    cs = [torch.from_numpy(case["cs"][:, i].copy()) for i in range(case["cs"].shape[1])]
    cs_new = list(cs)
    f, nxt = tc.ground_anchored_v(pm, tk[0], tk[1], v, cs, cs_new, 0, tc.ground_pairs(pm, pt._pp_ground, CPU))
    assert nxt == len(pm.geoms)
    return f, cs_new


def test_ground_anchored_v(case):
    _, (tq, tqd, tk) = _both_kin(case)
    jf, jcs = _jax_ground(case)
    tf, tcs = _port_ground(case, tk, tqd)
    force_atol = float(tc.ground_pairs(case["pm"], case["pt"]._pp_ground, CPU).pp.kp.max()) * 4 * 2.0**-23
    np.testing.assert_allclose(np.moveaxis(_arr(tf), -1, 0), jf, rtol=1e-5, atol=force_atol, err_msg="f_ext")
    _close(np.moveaxis(_arr(tcs), -1, 0), jcs, "contact state'")


def test_mass_matrix_bias_forces_tau_and_solve(case):
    m, pm = case["m"], case["pm"]
    (jq, jqd, jk), (tq, tqd, tk) = _both_kin(case)
    jv = jd._vel_s(m, jk[2], jk[3], jqd)
    tv = td._vel_s(pm, tk[2], tk[3], tqd)
    jM, tM = jd._mass_matrix_s(m, jk[2], jk[3]), td._mass_matrix_s(pm, tk[2], tk[3])
    _close(tM, jM, "M")

    f, _ = _jax_ground(case)
    jf = [[jnp.asarray(f[:, b, k]) for k in range(6)] for b in range(m.nb)]
    tf = [[_to_torch(f[:, b, k]) for k in range(6)] for b in range(m.nb)]
    jC = jd._bias_forces_s(m, jk[2], jk[3], jv, jqd, jf, jk[0], jk[1])
    tC = td._bias_forces_s(pm, tk[2], tk[3], tv, tqd, tf, tk[0], tk[1])
    _close(tC, jC, "C")

    ja, ta = _cols(case["action"])
    jtau, ttau = jd._tau_s(m, jq, ja, jqd), td._tau_s(pm, tq, ta, tqd)
    _close(ttau, jtau, "tau")

    # the solve on the JAX M and b on both sides
    jb = [jtau[d] - jC[d] for d in range(m.nv)]
    x_j = jd._spd_solve_s(jM, jb)
    x_t = td._spd_solve_s(_like(jM, _to_torch), _like(jb, _to_torch))
    _close(x_t, x_j, "qdd")


def test_one_control_step_with_contact_state(case):
    pm, pt = case["pm"], case["pt"]
    pairs = tc.ground_pairs(pm, pt._pp_ground, CPU)

    def contact_fn(m, R, p, v, cs):
        cs_new = list(cs)
        f, _ = tc.ground_anchored_v(m, R, p, v, cs, cs_new, 0, pairs)
        return f, cs_new

    got = td.physics_substeps(
        pm, torch.from_numpy(case["q"]), torch.from_numpy(case["qd"]), torch.from_numpy(case["action"]),
        pt.substeps, contact_fn=contact_fn, contact_state=torch.from_numpy(case["cs"]),
    )
    for what, g, w in zip(("q", "qd", "contact"), got, case["out"]):
        np.testing.assert_allclose(g.numpy(), w, err_msg=what, **STEP_TOL[what])


def test_matrix_form_matches_scalar_form(case):
    """The port's [E, 6, 6] matrix form against its scalar hot path, at the
    test state with the JAX contact forces."""
    pm = case["pm"]
    q, qd, action = (torch.from_numpy(case[k]) for k in ("q", "qd", "action"))
    f_ext = torch.from_numpy(_jax_ground(case)[0])
    R, p, X, S = td.fwd_kinematics(pm, q)
    v = td.body_velocities(pm, X, S, qd)
    tq, tqd, ta = td._columns(q), td._columns(qd), td._columns(action)
    Rs, ps, Xs, Ss = td._kin_s(pm, tq)
    vs = td._vel_s(pm, Xs, Ss, tqd)
    _close(np.moveaxis(_arr(Rs), -1, 0), R.numpy(), "R_wb")
    _close(np.moveaxis(_arr(ps), -1, 0), p.numpy(), "p_wb")
    for i, (Es, rs) in enumerate(Xs):
        Xm = tsp.xmat(torch.from_numpy(np.moveaxis(_arr(Es), -1, 0)), torch.from_numpy(np.moveaxis(_arr(rs), -1, 0)))
        _close(Xm.numpy(), X[i].numpy(), f"Xup[{i}]")
    _close(np.moveaxis(_arr(vs), -1, 0), torch.stack(v, 1).numpy(), "v")
    M = td.mass_matrix(pm, X, S)
    _close(np.moveaxis(_arr(td._mass_matrix_s(pm, Xs, Ss)), -1, 0), M.numpy(), "M")
    f_s = [[f_ext[:, b, k] for k in range(6)] for b in range(pm.nb)]
    C = td.bias_forces(pm, X, S, v, qd, f_ext, R, p)
    _close(np.moveaxis(_arr(td._bias_forces_s(pm, Xs, Ss, vs, tqd, f_s, Rs, ps)), -1, 0), C.numpy(), "C")
    tau = td.actuation(pm, action) + td._limit_torque(pm, q)
    _close(np.moveaxis(_arr(td._tau_s(pm, tq, ta, tqd)), -1, 0), tau.numpy(), "tau")
    b = tau - C
    M_s = [[M[:, i, j] for j in range(pm.nv)] for i in range(pm.nv)]
    _close(np.moveaxis(_arr(td._spd_solve_s(M_s, td._columns(b))), -1, 0), td.spd_solve(M, b).numpy(), "solve")


def _matrix_step(model, q, qd, action, f_ext):
    """One semi-implicit Euler step on the port's matrix form (the JAX
    package's ``tests/test_scalar_physics.py::_matrix_fd_step``)."""
    R_wb, p_wb, Xup, S = td.fwd_kinematics(model, q)
    v = td.body_velocities(model, Xup, S, qd)
    M = td.mass_matrix(model, Xup, S)
    C = td.bias_forces(model, Xup, S, v, qd, f_ext, R_wb, p_wb)
    tau = td.actuation(model, action, q, qd) + td._limit_torque(model, q)
    qd_new = torch.clamp(qd + model.dt * td.spd_solve(M, tau - C), -model.max_dof_speed, model.max_dof_speed)
    q_new = q.clone()
    for i in range(model.nb):
        qs, vs = model.q_start[i], model.v_start[i]
        if model.joint_type[i] == "free":
            quat = q[:, qs + 3 : qs + 7]
            q_new[:, qs : qs + 3] += model.dt * (tsp.quat_to_mat(quat) @ qd_new[:, vs + 3 : vs + 6, None])[..., 0]
            q_new[:, qs + 3 : qs + 7] = tsp.quat_integrate(quat, qd_new[:, vs : vs + 3], model.dt)
        else:
            q_new[:, qs] += model.dt * qd_new[:, vs]
    return q_new, qd_new


def test_fd_step_matches_matrix_step(case):
    """fd_step (scalar core) against a step on the matrix form, with the JAX
    contact forces: atol 5e-6 on q and 5e-3 on qd, as the JAX package's own
    matrix-vs-scalar test (tests/test_scalar_physics.py)."""
    pm = case["pm"]
    q, qd, action = (torch.from_numpy(case[k]) for k in ("q", "qd", "action"))
    f_ext = torch.from_numpy(_jax_ground(case)[0])
    q1, qd1, aux = td.fd_step(pm, q, qd, action, f_ext)
    q1m, qd1m = _matrix_step(pm, q, qd, action, f_ext)
    np.testing.assert_allclose(q1.numpy(), q1m.numpy(), atol=5e-6)
    np.testing.assert_allclose(qd1.numpy(), qd1m.numpy(), atol=5e-3)
    R, p, X, S = td.fwd_kinematics(pm, q)
    _close(aux["R_wb"].numpy(), R.numpy(), "aux R_wb")
    _close(aux["p_wb"].numpy(), p.numpy(), "aux p_wb")
    _close(aux["v_body"].numpy(), torch.stack(td.body_velocities(pm, X, S, qd), 1).numpy(), "aux v_body")
    # physics_step without contacts is the same core with no external force
    q2, qd2 = td.physics_step(pm, q, qd, action)
    q3, qd3, _ = td.fd_step(pm, q, qd, action, torch.zeros_like(f_ext))
    assert torch.equal(q2, q3) and torch.equal(qd2, qd3)
