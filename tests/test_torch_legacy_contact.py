"""The legacy viscous contacts and the per-pair anchored loops, ported
(pql_tpu_torch.physics.contact), against the JAX package on the CPU.

Every case hands both packages the SAME inputs: the port's scalar
kinematics of seeded states (``td._kin_s``/``td._vel_s``), as lists of [E]
columns and Python floats for the scalar forms (the JAX scalar functions
``vmap``ped over the columns, the floats kept floats, so both sides fold
the same structural zeros), and stacked into [E, nb, 3, 3] / [E, nb, 3] /
[E, nb, 6] arrays for the matrix forms. So each form is held against its
JAX twin alone, not against a difference of kinematics.

States (E = 64 per model, seeded with numpy):

- Ant and Humanoid (``_rigid_states``): the free base dropped anywhere from
  10 cm under the ground to 60 cm over it, any orientation, hinges across
  and past their limits, velocities N(0, 2-3): spheres separated,
  penetrating, capped at ``contact_force_cap``, pressed apart faster than
  the spring pushes (normal force clamped at 0), with Coulomb-limited and
  viscous friction;
- AllegroHand (``test_torch_contact_hand._hand_states``): finger spheres
  inside the cube nearest each face, just outside a face and a corner, the
  cube dropped near the palm (corners below and above it), random anchors
  and engaged flags;
- the cube alone (``hand_model(n_fingers=0)``, the contact lab's 32-scalar
  state): the cube at heights and tilts around rest, half the envs near
  rest and half spinning, anchors off the
  corners by 1e-6 to 1e-2 m, half the pairs engaged.

Which branches the port took is recorded (``_legacy_branches``, and
``_branches`` of the hand's contact test for the anchored loops) and
asserted, so a construction that stops reaching a branch fails.

Tolerances (fp32 on both sides):
- the port against JAX, form by form: rtol 1e-5, atol kp · 4 · 2⁻²³ on
  wrenches and magnitudes (the model's spring times a few ulps of a
  position of order 0.1 m, as for the ground group in
  tests/test_torch_physics.py), the contact state as in the hand's contact
  test (rtol 1e-5, atol 1e-6 · the largest value);
- the port's matrix form against its scalar form: atol 2e-3, the JAX
  package's own bound for its two forms (tests/test_scalar_physics.py):
  the two sum in other orders;
- the anchored loops against the pair-vectorized groups: the hand's
  contact-test tolerance (the JAX package holds them at 1e-4,
  tests/test_contact_anchored.py);
- one ``physics_step`` with the legacy contacts: rtol 1e-5 with atol 1e-6
  on q and 1e-4 on qd, as the hand's substep test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pql_tpu.envs.hand as jhand
import pql_tpu.envs.rigid as jrigid
import pql_tpu_torch.envs.hand as thand
import pql_tpu_torch.envs.rigid as trigid
from pql_tpu.physics import contact as jc
from pql_tpu.physics import dynamics as jd
from pql_tpu_torch import physics as tphysics
from pql_tpu_torch.physics import contact as tc
from pql_tpu_torch.physics import dynamics as td
from test_torch_contact_hand import _branches, _hand_states

E = 64
CPU = torch.device("cpu")
HALF = [jhand.CUBE_HALF] * 3


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(x, n=E):
    """Nested lists of [E] tensors / python floats → numpy [..., E]."""
    if isinstance(x, (list, tuple)):
        return np.stack([_arr(y, n) for y in x])
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.full(n, x, np.float32)


def _cols(a: np.ndarray):
    return [torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(a.shape[1])]


# ------------------------------------------------------------------ states


def _rigid_states(model, seed):
    """q [E, nq], qd [E, nv] float32 for a free-base model; see the module docstring."""
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(model.neutral_q(), np.float64), (E, 1))
    quat = rng.normal(size=(E, 4))
    quat[: E // 2] = [1.0, 0.0, 0.0, 0.0] + 0.2 * quat[: E // 2]  # half near upright
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, 2] = rng.uniform(-0.1, 0.6, E)
    q[:, 7:] = rng.uniform(-1.5, 1.5, (E, model.nq - 7))
    qd = rng.normal(0.0, 2.0, (E, model.nv))
    qd[:, 3:6] = rng.normal(0.0, 3.0, (E, 3))
    return q.astype(np.float32), qd.astype(np.float32)


def _cube_states(seed):
    """The contact lab's cube: q [E, 7], qd [E, 6], contact state [E, 32]."""
    m = thand.hand_model(n_fingers=0)
    rng = np.random.RandomState(seed)
    h = jhand.CUBE_HALF
    tilt = rng.uniform(-0.4, 0.4, (E, 3)) * (rng.uniform(size=(E, 1)) < 0.5)
    quat = np.concatenate([np.ones((E, 1)), 0.5 * tilt], -1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    q = np.concatenate([rng.uniform(-0.05, 0.05, (E, 2)), h + rng.uniform(-0.01, 0.01, (E, 1)), quat], -1)
    qd = np.concatenate([rng.normal(0.0, 3.0, (E, 3)), rng.normal(0.0, 0.3, (E, 3))], -1)
    qd[: E // 2] *= 1e-3  # near rest: engaged corners stick
    R, p, _, _ = td._kin_s(m, _cols(q.astype(np.float64)))
    Rb, pb = _arr(R[0]), _arr(p[0])  # [3, 3, E], [3, E]
    corners = pb.T[:, None] + np.einsum("rce,jc->ejr", Rb, np.asarray(tc._CORNER_SIGNS) * h)
    off = rng.normal(size=corners.shape)
    off *= (10.0 ** rng.uniform(-6, -2, corners.shape[:2]))[..., None] / np.linalg.norm(off, axis=-1, keepdims=True)
    engaged = rng.randint(0, 2, (E, 8))  # about half the pairs
    cs = np.concatenate([corners + off, engaged[..., None]], -1).reshape(E, -1)
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return m, f32(q), f32(qd), f32(cs)


def _kin(pm, q, qd):
    """The port's scalar kinematics: (R, p, v) lists of [E] columns / floats."""
    R, p, X, S = td._kin_s(pm, _cols(q))
    return R, p, td._vel_s(pm, X, S, _cols(qd))


def _matrix(R, p, v):
    """The scalar kinematics stacked: R [E, nb, 3, 3], p [E, nb, 3], v [E, nb, 6]."""
    return (torch.from_numpy(np.moveaxis(_arr(R), -1, 0)), torch.from_numpy(np.moveaxis(_arr(p), -1, 0)),
            torch.from_numpy(np.moveaxis(_arr(v), -1, 0)))


def _jax_scalar(fn, trees):
    """vmap of ``fn(*trees)`` over the [E] tensors of the nested lists
    ``trees``, with the Python floats left floats; returns numpy [E, ...] of
    each output leaf (floats broadcast), nested as ``fn``'s output."""
    leaves = []

    def template(x):
        if isinstance(x, (list, tuple)):
            return [template(y) for y in x]
        if isinstance(x, torch.Tensor):
            leaves.append(x.numpy())
            return len(leaves) - 1
        return ("const", x)

    tmpl = template(trees)

    def build(t, args):
        if isinstance(t, list):
            return [build(y, args) for y in t]
        if isinstance(t, tuple):
            return t[1]
        return args[t]

    def one(*args):
        out = fn(*build(tmpl, args))
        return jax.tree_util.tree_map(lambda x: jnp.zeros(()) + x, out)

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(one))(*leaves))


# --------------------------------------------------------------- branches


def _legacy_branches(monkeypatch):
    """Record, per call of the port's ``_contact_force``/``_contact_force_s``,
    which branches each pair took (numpy float64 from its inputs)."""
    seen = []

    def record(depth, normal, vel, kp, kd, mu, cap):
        d = np.asarray(depth, np.float64)
        n = [np.broadcast_to(np.asarray(c, np.float64), d.shape) for c in normal]
        u = [np.broadcast_to(np.asarray(c, np.float64), d.shape) for c in vel]
        vn = sum(a * b for a, b in zip(u, n))
        raw = kp * d - kd * vn
        vt = np.sqrt(sum((a - vn * b) ** 2 for a, b in zip(u, n))) + 1e-6
        active = d > 0.0
        seen.append(dict(active=active, capped=active & (raw > cap), pulled=active & (raw < 0.0),
                         coulomb=active & (raw > 0.0) & (mu * np.clip(raw, 0.0, cap) < 2.0 * kd * vt),
                         viscous=active & (raw > 0.0) & (mu * np.clip(raw, 0.0, cap) > 2.0 * kd * vt)))

    orig_m, orig_s = tc._contact_force, tc._contact_force_s

    def spy_m(depth, normal, vel, kp, kd, mu, cap=1.0e4):
        record(depth.numpy(), normal.numpy().T, vel.numpy().T, kp, kd, mu, cap)
        return orig_m(depth, normal, vel, kp, kd, mu, cap)

    def spy_s(depth, normal, vel, kp, kd, mu, cap, ref):
        f = lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.full(ref.shape, x)  # noqa: E731
        record(f(depth), [f(c) for c in normal], [f(c) for c in vel], kp, kd, mu, cap)
        return orig_s(depth, normal, vel, kp, kd, mu, cap, ref)

    monkeypatch.setattr(tc, "_contact_force", spy_m)
    monkeypatch.setattr(tc, "_contact_force_s", spy_s)
    return seen


def _union(seen):
    return {k: np.concatenate([s[k].reshape(-1) for s in seen]) for k in seen[0]}


# ------------------------------------------------------------------ cases

RIGID = ("Ant", "Humanoid")


@pytest.fixture(scope="module", params=RIGID + ("AllegroHand",))
def case(request):
    name = request.param
    if name == "AllegroHand":
        jt, pt = jhand.AllegroHand(), thand.AllegroHand()
        q, qd, cs = _hand_states(pt)
    else:
        jt, pt = getattr(jrigid, name)(), getattr(trigid, name)()
        q, qd = _rigid_states(pt.model, seed=RIGID.index(name))
        cs = None
    return dict(name=name, jm=jt.model, pm=pt.model, jt=jt, pt=pt, q=q, qd=qd, cs=cs)


def _tol(model):
    return dict(rtol=1e-5, atol=model.contact_kp * 4 * 2.0**-23)


def _groups(case):
    """(name, port matrix fn, JAX matrix fn, port scalar fn, JAX scalar fn)
    of each legacy group of the case's model; the box groups on the hand's
    cube only."""
    out = [("ground", lambda R, p, v: tc.ground_contacts(case["pm"], R, p, v),
            lambda R, p, v: jc.ground_contacts(case["jm"], R, p, v),
            lambda R, p, v: tc.ground_contacts_s(case["pm"], R, p, v),
            lambda R, p, v: jc.ground_contacts_s(case["jm"], R, p, v))]
    if case["name"] == "AllegroHand":
        cube, half_t, half_j = case["pt"].cube, torch.full((3,), jhand.CUBE_HALF), jnp.full(3, jhand.CUBE_HALF)
        out.append(("sphere_box", lambda R, p, v: tc.sphere_box_contacts(case["pm"], R, p, v, cube, half_t),
                    lambda R, p, v: jc.sphere_box_contacts(case["jm"], R, p, v, cube, half_j),
                    lambda R, p, v: tc.sphere_box_contacts_s(case["pm"], R, p, v, cube, HALF),
                    lambda R, p, v: jc.sphere_box_contacts_s(case["jm"], R, p, v, cube, HALF)))
        out.append(("box_ground", lambda R, p, v: (tc.box_ground_contacts(case["pm"], R, p, v, cube, half_t), None),
                    lambda R, p, v: (jc.box_ground_contacts(case["jm"], R, p, v, cube, half_j), jnp.zeros(0)),
                    lambda R, p, v: (tc.box_ground_contacts_s(case["pm"], R, p, v, cube, HALF), None),
                    lambda R, p, v: (jc.box_ground_contacts_s(case["jm"], R, p, v, cube, HALF), jnp.zeros(0))))
    return out


def _scalar_out(f, mags):
    """Port scalar output → (f_ext [E, nb, 6], mags [E, n] or None) numpy."""
    return np.moveaxis(_arr(f), -1, 0), None if mags is None else np.moveaxis(_arr(mags), -1, 0)


def test_matrix_forms_match_jax(case, monkeypatch):
    """ground_contacts (and on the hand sphere_box_contacts and
    box_ground_contacts) against the JAX matrix forms, vmapped over envs."""
    seen = _legacy_branches(monkeypatch)
    R, p, v = _kin(case["pm"], case["q"], case["qd"])
    Rm, pm_, vm = _matrix(R, p, v)
    for name, port_m, jax_m, _, _ in _groups(case):
        f, mags = port_m(Rm, pm_, vm)
        jf, jmags = jax.jit(jax.vmap(jax_m))(Rm.numpy(), pm_.numpy(), vm.numpy())
        assert f.shape == (E, case["pm"].nb, 6) and f.dtype == torch.float32
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), err_msg=f"{name}: f_ext", **_tol(case["pm"]))
        if mags is not None:
            assert mags.shape == (E, len(case["pm"].geoms))
            np.testing.assert_allclose(mags.numpy(), np.asarray(jmags), err_msg=f"{name}: magnitudes",
                                       **_tol(case["pm"]))
    _assert_legacy_branches(case, _union(seen))


def _assert_legacy_branches(case, b):
    assert (~b["active"]).any() and b["active"].any(), "contact and no contact"
    assert b["coulomb"].any() and b["viscous"].any(), "Coulomb-limited and viscous friction"
    assert b["capped"].any(), "a capped normal force"
    assert b["pulled"].any(), "a normal force clamped at 0"


def test_scalar_forms_match_jax(case, monkeypatch):
    """The ``_s`` twins against the JAX ones on the same columns and floats."""
    seen = _legacy_branches(monkeypatch)
    R, p, v = _kin(case["pm"], case["q"], case["qd"])
    for name, _, _, port_s, jax_s in _groups(case):
        f, mags = _scalar_out(*port_s(R, p, v))
        jf, jmags = _jax_scalar(jax_s, [R, p, v])
        np.testing.assert_allclose(f, _e_first(jf), err_msg=f"{name}: f_ext", **_tol(case["pm"]))
        if mags is not None:
            np.testing.assert_allclose(mags, _e_first(jmags), err_msg=f"{name}: magnitudes", **_tol(case["pm"]))
    _assert_legacy_branches(case, _union(seen))


def _e_first(x):
    """The vmapped JAX output of a nested list: [E, ...] with E first."""
    return np.asarray(x) if not isinstance(x, list) else np.stack([_e_first(y) for y in x], 1)


def test_matrix_form_matches_scalar_form(case):
    """The port's two forms on the same kinematics (the JAX package's bound)."""
    R, p, v = _kin(case["pm"], case["q"], case["qd"])
    Rm, pm_, vm = _matrix(R, p, v)
    for name, port_m, _, port_s, _ in _groups(case):
        fm, mm = port_m(Rm, pm_, vm)
        fs, ms = _scalar_out(*port_s(R, p, v))
        np.testing.assert_allclose(fs, fm.numpy(), atol=2e-3, err_msg=f"{name}: f_ext")
        if mm is not None:
            np.testing.assert_allclose(ms, mm.numpy(), atol=2e-3, err_msg=f"{name}: magnitudes")


def test_physics_exports_the_legacy_contacts():
    assert tphysics.ground_contacts is tc.ground_contacts
    assert tphysics.sphere_box_contacts is tc.sphere_box_contacts
    assert set(tphysics.__all__) == set(__import__("pql_tpu.physics", fromlist=["__all__"]).__all__)
    import pql_tpu.physics.contact as jmod
    jax_fns = {k for k, x in vars(jmod).items() if callable(x) and getattr(x, "__module__", "") == jmod.__name__}
    port_fns = {k for k, x in vars(tc).items() if callable(x) and getattr(x, "__module__", "") == tc.__name__}
    assert jax_fns <= port_fns, sorted(jax_fns - port_fns)


# ----------------------------------------------------- per-pair anchored loops


def _stateful(fn, *args):
    """A contact function (m, R, p, v, cs) → (f_ext, cs') of one pair group,
    ``...`` marking the contact state's place in ``args``."""
    k = args.index(...)

    def call(m, R, p, v, cs):
        cs_new = list(cs)
        f, _ = fn(m, R, p, v, *args[:k], cs, cs_new, *args[k + 1 :])
        return f, cs_new

    return call


def _anchored_cases(which):
    """(model, q, qd, cs, [(name, port _s call, JAX _s call, port _v call, kp_max)])."""
    if which == "cube":
        pm, q, qd, cs = _cube_states(seed=7)
        jm = jhand.hand_model(n_fingers=0)
        pp = tc.derive_pair(pm, tc.point_eff_mass(pm, 0, (jhand.CUBE_HALF,) * 3), n_share=4)
        jpp = jc.derive_pair(jm, jc.point_eff_mass(jm, 0, (jhand.CUBE_HALF,) * 3), n_share=4)
        assert pp.__dict__ == jpp.__dict__
        corners = tc.box_corners(HALF, CPU)
        return pm, q, qd, cs, [("box_ground", _stateful(tc.box_ground_anchored_s, 0, HALF, ..., 0, pp),
                                _stateful(jc.box_ground_anchored_s, 0, HALF, ..., 0, jpp),
                                _stateful(tc.box_ground_anchored_v, 0, corners, ..., 0, pp), pp.kp)]
    jt, pt = jhand.AllegroHand(), thand.AllegroHand()
    q, qd, cs = _hand_states(pt, seed=3)
    c, n = pt._on(CPU), len(pt.model.geoms)
    return pt.model, q, qd, cs, [
        ("ground", _stateful(tc.ground_anchored_s, ..., 0, pt._pp_ground),
         _stateful(jc.ground_anchored_s, ..., 0, jt._pp_ground),
         _stateful(tc.ground_anchored_v, ..., 0, c.ground), max(p.kp for p in pt._pp_ground)),
        ("sphere_box", _stateful(tc.sphere_box_anchored_s, pt.cube, HALF, ..., n, pt._pp_cube),
         _stateful(jc.sphere_box_anchored_s, jt.cube, HALF, ..., n, jt._pp_cube),
         _stateful(tc.sphere_box_anchored_v, pt.cube, HALF, ..., n, c.cube), max(p.kp for p in pt._pp_cube)),
        ("box_ground", _stateful(tc.box_ground_anchored_s, pt.cube, HALF, ..., 2 * n, pt._pp_corner),
         _stateful(jc.box_ground_anchored_s, jt.cube, HALF, ..., 2 * n, jt._pp_corner),
         _stateful(tc.box_ground_anchored_v, pt.cube, c.corners, ..., 2 * n, pt._pp_corner), pt._pp_corner.kp),
    ]


def _compare_stateful(got, want, kp_max, what):
    (tf, tcs), (jf, jcs) = got, want
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=kp_max * 4 * 2.0**-23, err_msg=f"{what}: f_ext")
    np.testing.assert_allclose(tcs, jcs, rtol=1e-5, atol=1e-6 * np.abs(jcs).max(), err_msg=f"{what}: contact state'")


@pytest.mark.parametrize("which", ["cube", "hand"])
def test_anchored_loops_match_jax_and_the_vectorized_groups(which, monkeypatch):
    """Each ``*_anchored_s`` loop against the JAX loop on the same columns,
    and against the port's pair-vectorized ``*_v`` group."""
    pm, q, qd, cs, groups = _anchored_cases(which)
    seen = _branches(monkeypatch)
    R, p, v = _kin(pm, q, qd)
    cs_cols = _cols(cs)
    for name, port_s, jax_s, port_v, kp_max in groups:
        n0 = len(seen)
        f, cs_new = port_s(pm, R, p, v, cs_cols)
        got = (np.moveaxis(_arr(f), -1, 0), np.moveaxis(_arr(cs_new), -1, 0))
        jf, jcs = _jax_scalar(lambda R, p, v, cs: jax_s(_jm(which), R, p, v, cs), [R, p, v, cs_cols])
        _compare_stateful(got, (_e_first(jf), _e_first(jcs)), kp_max, f"{which} {name} vs JAX")
        rec = {k: np.concatenate([s[k].reshape(-1) for s in seen[n0:]]) for k in seen[n0]}
        assert rec["active"].any() and (~rec["active"]).any(), f"{which} {name}: contact and no contact"
        if name != "ground":
            assert (rec["active"] & rec["engaged"] & ~rec["slide"]).any(), f"{which} {name}: no engaged pair sticks"
            assert (rec["active"] & ~rec["engaged"]).any(), f"{which} {name}: no fresh touch"
        fv, csv = port_v(pm, R, p, v, cs_cols)
        _compare_stateful(got, (np.moveaxis(_arr(fv), -1, 0), np.moveaxis(_arr(csv), -1, 0)), kp_max,
                          f"{which} {name} vs the vectorized group")


def _jm(which):
    return jhand.hand_model(n_fingers=0) if which == "cube" else jhand.AllegroHand().model


# ------------------------------------------------------------ physics step


@pytest.mark.parametrize("name", RIGID)
def test_physics_step_with_legacy_contacts_matches_jax(name):
    """One ``physics_step`` with ``ground_contacts_s`` as the contact
    function (tests/test_scalar_physics.py::test_physics_step_vmaps), each
    package from the same q, qd and action with its own kinematics."""
    jm, pm = getattr(jrigid, name)().model, getattr(trigid, name)().model
    q, qd = _rigid_states(pm, seed=11)
    q[:, 2] = np.abs(q[:, 2]) * 0.5 + 0.1  # most feet near the ground: contacts, few at the cap
    act = np.random.RandomState(12).uniform(-1.0, 1.0, (E, pm.nu)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda q, qd, a: jd.physics_step(
        jm, q, qd, a, contact_fn=lambda m, R, p, v: jc.ground_contacts_s(m, R, p, v)[0])))(q, qd, act)
    got = td.physics_step(pm, torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(act),
                          contact_fn=lambda m, R, p, v: tc.ground_contacts_s(m, R, p, v)[0])
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6, err_msg="q")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-4, err_msg="qd")
