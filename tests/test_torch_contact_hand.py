"""The hand's contact groups, its model and a position-mode substep, ported
(pql_tpu_torch.physics.contact, pql_tpu_torch.envs.hand.hand_model) against
the JAX package, on the CPU. No env step is compiled here.

States: E = 64 envs of the AllegroHand model with finger angles drawn in
their limits and the cube placed per env to hit every branch
(``_hand_states``):

- envs with e % 8 in 0..4 put the centre of one finger sphere at a chosen
  point of the cube's frame: inside, nearest the x, y or z face (the three
  ``pick`` normals of the inside branch), just outside a face, and just
  outside a corner (a diagonal outside normal);
- envs with e % 8 in 5..7 drop the cube near the palm (centre height 0 to
  6 cm, any orientation), so some corners sit below the palm plane and
  some above, and some inside the bowl's rim and some outside it;
- every pair's engaged flag is 0 or 1 at random and its anchor lies off
  the tracked point by 10⁻⁶ to 10⁻² m, so engaged contacts both stick and
  slide.

Both sides compute the kinematics from the same q and qd (the JAX functions
``vmap``ped over envs), then call the group. Which branches were taken is
recorded on the port's side (``_branches``) and asserted, so a change of
the construction that stops reaching a branch fails the test.

Tolerances (fp32 on both sides, sums in other orders):
- wrenches: rtol 1e-5, atol kp_max · 4 · 2⁻²³ (the stiffest spring of the
  group times a few ulps of a position of order 0.1 m, as for the ground
  group in tests/test_torch_physics.py);
- new anchors and engaged flags: rtol 1e-5, atol 1e-6 · the largest value;
- the position-mode substep: rtol 1e-5 with atol 1e-6 on q and 1e-4 on qd
  (finger accelerations reach ~10³ rad/s² at 480 Hz, so qd is the sum of
  terms ~100 times its rounding);
- the model and the pair gains are numpy and Python floats on both sides:
  exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pql_tpu.envs.hand as jhand
import pql_tpu_torch.envs.hand as thand
from pql_tpu.physics import contact as jc
from pql_tpu.physics import dynamics as jd
from pql_tpu_torch.physics import contact as tc
from pql_tpu_torch.physics import dynamics as td

E = 64
CPU = torch.device("cpu")
HALF = [jhand.CUBE_HALF] * 3
HANDS = ("AllegroHand", "ShadowHand")


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(x):
    """Nested lists of [E] tensors / python floats → numpy [..., E]."""
    if isinstance(x, (list, tuple)):
        return np.stack([_arr(y) for y in x])
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.full(E, x, np.float32)


def _cols(a: np.ndarray):
    return [torch.from_numpy(a[:, i].copy()) for i in range(a.shape[1])]


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _sphere_centres(pm, q):
    """[E, n_geoms, 3] world sphere centres (float64, the port's kinematics)."""
    R, p, _, _ = td._kin_s(pm, _cols(q.astype(np.float64)))
    out = []
    for g in pm.geoms:
        Rb, pb = _arr(R[g.body]), _arr(p[g.body])  # [3, 3, E], [3, E]
        out.append(pb.T + np.einsum("rce,c->er", Rb, np.asarray(g.offset)))
    return np.stack(out, 1)


def _hand_states(pt, seed=0):
    """q [E, nq], qd [E, nv], contact state [E, 4 · pairs] (float32) built to
    reach every branch; see the module docstring."""
    rng = np.random.RandomState(seed)
    pm, n_dof, n_geoms = pt.model, pt.n_dof, len(pt.model.geoms)
    lo, hi = pm.limit_lo[:n_dof], pm.limit_hi[:n_dof]
    q = np.zeros((E, pm.nq))
    q[:, :n_dof] = lo + (hi - lo) * rng.uniform(0.05, 0.95, (E, n_dof))
    quat = rng.normal(size=(E, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, pt.cube_q + 3 : pt.cube_q + 7] = quat
    centres = _sphere_centres(pm, q)
    h, r = jhand.CUBE_HALF, pm.geoms[0].radius
    for e in range(E):
        Rb, kind = _quat_to_mat(quat[e]), e % 8
        if kind >= 5:  # free drop near the palm
            q[e, pt.cube_q : pt.cube_q + 3] = [*rng.uniform(-0.05, 0.05, 2), rng.uniform(0.0, 0.06)]
            continue
        s = rng.choice([-1.0, 1.0], 3)
        if kind <= 2:  # inside, nearest the face of axis `kind`
            local = s * rng.uniform(0.0, 0.5, 3) * h
            local[kind] = s[kind] * 0.8 * h
        elif kind == 3:  # just outside a face
            local = s * rng.uniform(0.0, 0.7, 3) * h
            local[e % 3] = s[e % 3] * (h + 0.5 * r)
        else:  # just outside a corner
            local = s * (h + 0.3 * r)
        j = rng.randint(n_geoms)
        q[e, pt.cube_q : pt.cube_q + 3] = centres[e, j] - Rb @ local
    qd = np.concatenate([rng.normal(0.0, 2.0, (E, n_dof)), rng.normal(0.0, 0.3, (E, 6))], -1)

    # anchors: the tracked point (world for the palm pairs, the cube's frame
    # for the finger-cube pairs) off by 1e-6..1e-2 m; engaged at random
    pos, Rb = q[:, pt.cube_q : pt.cube_q + 3], np.stack([_quat_to_mat(x) for x in quat])
    local = np.einsum("erc,ejr->ejc", Rb, centres - pos[:, None])
    corners = pos[:, None] + np.einsum("erc,jc->ejr", Rb, np.asarray(tc._CORNER_SIGNS) * h)
    points = np.concatenate([centres, local, corners], 1)  # [E, pairs, 3] in the slot order of the hand
    off = rng.normal(size=points.shape)
    off *= (10.0 ** rng.uniform(-6, -2, points.shape[:2]))[..., None] / np.linalg.norm(off, axis=-1, keepdims=True)
    engaged = rng.randint(0, 2, points.shape[:2])
    cs = np.concatenate([points + off, engaged[..., None]], -1).reshape(E, -1)
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return f32(q), f32(qd), f32(cs)


def _branches(monkeypatch):
    """Record, for every call of the port's ``_anchored_force_s``, which of
    its branches each pair took (numpy, float64, from its inputs)."""
    seen = []
    orig = tc._anchored_force_s

    def spy(depth, normal, vel, dx, engaged, pp):
        a = lambda x: np.broadcast_to(np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float64),  # noqa: E731
                                      depth.shape)
        d, n = a(depth), [a(x) for x in normal]
        u, x, eng = [a(c) for c in vel], [a(c) for c in dx], a(engaged)
        kp, kd, mu, cap, kpt, kdt = (a(getattr(pp, k)) for k in ("kp", "kd", "mu", "cap", "kpt", "kdt"))
        active = d > 0.0
        un, xn = sum(c * m for c, m in zip(u, n)), sum(c * m for c, m in zip(x, n))
        fn = np.clip(kp * d - kd * un, 0.0, cap) * active
        ft = [-(kpt * (xc - xn * m) * active * eng + kdt * (uc - un * m) * active) for xc, uc, m in zip(x, u, n)]
        slide = mu * fn / (np.sqrt(sum(f * f for f in ft)) + 1e-9) < 1.0
        seen.append(dict(active=active, engaged=eng > 0.5, slide=slide))
        return orig(depth, normal, vel, dx, engaged, pp)

    monkeypatch.setattr(tc, "_anchored_force_s", spy)
    return seen


def _assert_all_branches(rec, what):
    active, engaged, slide = rec["active"], rec["engaged"], rec["slide"]
    assert (~active).any(), f"{what}: no pair out of contact"
    assert (active & ~engaged).any(), f"{what}: no fresh touch"
    assert (active & engaged & ~slide).any(), f"{what}: no engaged pair sticks"
    assert (active & engaged & slide).any(), f"{what}: no engaged pair slides"


def _group(fn, *args):
    """A contact function (m, R, p, v, cs) → (f_ext, cs') of one pair group:
    ``fn(m, R, p, v, *args_before_cs, cs, cs_new, *args_after)`` with the
    contact state's place marked by ``...`` in ``args``."""
    k = args.index(...)

    def call(m, R, p, v, cs):
        cs_new = list(cs)
        f, _ = fn(m, R, p, v, *args[:k], cs, cs_new, *args[k + 1 :])
        return f, cs_new

    return call


def _jax_call(m, call, q, qd, cs):
    """jit(vmap) of: kinematics from (q, qd), then ``call(m, R, p, v, cs)``
    → (f_ext [E, nb, 6], contact state' [E, nc]) as numpy."""

    def one(q, qd, cs):
        R, p, X, S = jd._kin_s(m, [q[i] for i in range(m.nq)])
        v = jd._vel_s(m, X, S, [qd[i] for i in range(m.nv)])
        f, cs_new = call(m, R, p, v, [cs[i] for i in range(cs.shape[0])])
        f = [[x if not isinstance(x, float) else jnp.zeros(()) + x for x in row] for row in f]
        return jnp.stack([jnp.stack(row) for row in f]), jnp.stack(cs_new)

    return tuple(np.array(x) for x in jax.jit(jax.vmap(one))(q, qd, cs))


def _port_call(pm, call, q, qd, cs):
    R, p, X, S = td._kin_s(pm, _cols(q))
    v = td._vel_s(pm, X, S, _cols(qd))
    f, cs_new = call(pm, R, p, v, _cols(cs))
    return np.moveaxis(_arr(f), -1, 0), np.moveaxis(_arr(cs_new), -1, 0)


def _compare(got, want, kp_max):
    (tf, tcs), (jf, jcs) = got, want
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=kp_max * 4 * 2.0**-23, err_msg="f_ext")
    np.testing.assert_allclose(tcs, jcs, rtol=1e-5, atol=1e-6 * np.abs(jcs).max(), err_msg="contact state'")


@pytest.fixture(scope="module")
def hand():
    jt, pt = jhand.AllegroHand(), thand.AllegroHand()
    q, qd, cs = _hand_states(pt)
    return dict(jt=jt, pt=pt, c=pt._on(CPU), n=len(pt.model.geoms), state=(q, qd, cs))


def test_states_reach_every_sphere_box_branch(hand):
    """The construction puts the targeted spheres where intended: inside
    nearest each face, and outside within reach of a face and of a corner."""
    pt, q = hand["pt"], hand["state"][0]
    centres = _sphere_centres(pt.model, q)
    pos = q[:, pt.cube_q : pt.cube_q + 3].astype(np.float64)
    Rb = np.stack([_quat_to_mat(x) for x in q[:, pt.cube_q + 3 : pt.cube_q + 7].astype(np.float64)])
    local = np.einsum("erc,ejr->ejc", Rb, centres - pos[:, None])
    h, r = jhand.CUBE_HALF, pt.model.geoms[0].radius
    inside = (np.abs(local) < h).all(-1)
    dist = np.linalg.norm(local - np.clip(local, -h, h), axis=-1)
    axis = np.argmax(np.abs(local), -1)
    kind = np.arange(E) % 8
    for k in range(3):
        assert (inside & (axis == k))[kind == k].any(), f"inside, nearest face {k}"
    touching = ~inside & (dist < r)
    assert touching[kind == 3].any() and touching[kind == 4].any()
    assert (~inside & (dist > r)).any()


def test_ground_group_with_world_rooted_fingers(hand, monkeypatch):
    """Finger spheres vs the palm plane: link 0 of each finger hangs from the
    world, so its pose holds python floats, broadcast against the envs."""
    jt, pt, c = hand["jt"], hand["pt"], hand["c"]
    seen = _branches(monkeypatch)
    got = _port_call(pt.model, _group(tc.ground_anchored_v, ..., 0, c.ground), *hand["state"])
    want = _jax_call(jt.model, _group(jc.ground_anchored_v, ..., 0, jt._pp_ground), *hand["state"])
    _compare(got, want, float(c.ground.pp.kp.max()))
    assert len(seen) == 1
    # the fingers seldom reach the palm in this construction: contact and no contact suffice
    assert seen[0]["active"].any() and (~seen[0]["active"]).any()


def test_sphere_box_anchored_v(hand, monkeypatch):
    jt, pt, c, n = hand["jt"], hand["pt"], hand["c"], hand["n"]
    seen = _branches(monkeypatch)
    got = _port_call(pt.model, _group(tc.sphere_box_anchored_v, pt.cube, HALF, ..., n, c.cube), *hand["state"])
    want = _jax_call(jt.model, _group(jc.sphere_box_anchored_v, jt.cube, HALF, ..., n, jt._pp_cube),
                     *hand["state"])
    _compare(got, want, float(c.cube.pp.kp.max()))
    _assert_all_branches(seen[0], "sphere-box")


def test_box_ground_anchored_v(hand, monkeypatch):
    jt, pt, c, n = hand["jt"], hand["pt"], hand["c"], hand["n"]
    seen = _branches(monkeypatch)
    got = _port_call(pt.model, _group(tc.box_ground_anchored_v, pt.cube, c.corners, ..., 2 * n, pt._pp_corner),
                     *hand["state"])
    want = _jax_call(jt.model, _group(jc.box_ground_anchored_v, jt.cube, HALF, ..., 2 * n, jt._pp_corner),
                     *hand["state"])
    _compare(got, want, pt._pp_corner.kp)
    _assert_all_branches(seen[0], "box-ground")


def test_bowl_anchored_v(hand, monkeypatch):
    jt, pt, c, n = hand["jt"], hand["pt"], hand["c"], hand["n"]
    seen = _branches(monkeypatch)
    got = _port_call(pt.model, _group(tc.bowl_anchored_v, pt.cube, c.corners, pt._bowl_center, pt.bowl_radius, ...,
                                      2 * n, pt._pp_bowl), *hand["state"])
    want = _jax_call(jt.model, _group(jc.bowl_anchored_v, jt.cube, HALF, jt._bowl_center, jt.bowl_radius, ...,
                                      2 * n, jt._pp_bowl), *hand["state"])
    _compare(got, want, pt._pp_bowl.kp)
    _assert_all_branches(seen[0], "bowl")
    # corners inside and outside the rim, in the free-drop envs
    q = hand["state"][0].astype(np.float64)
    Rb = np.stack([_quat_to_mat(x) for x in q[:, pt.cube_q + 3 : pt.cube_q + 7]])
    corners = q[:, None, pt.cube_q : pt.cube_q + 3] + np.einsum(
        "erc,jc->ejr", Rb, np.asarray(tc._CORNER_SIGNS) * jhand.CUBE_HALF)
    in_rim = (corners[..., :2] ** 2).sum(-1) < pt.bowl_radius**2 - pt._bowl_center[2] ** 2
    drop = np.arange(E) % 8 >= 5
    assert in_rim[drop].any() and (~in_rim[drop]).any()


@pytest.mark.parametrize("palm", ["flat", "bowl"])
def test_hand_contact_fn_and_add_fext_s(hand, palm):
    """The whole contact function of one substep (the three groups summed
    by ``add_fext_s``) against the JAX ``AllegroHand._contact_fn``; the
    stiffest group sets the force tolerance, times 3 for the summed groups."""
    jt, pt = jhand.AllegroHand(), thand.AllegroHand()
    jt.palm = pt.palm = palm
    got = _port_call(pt.model, pt._contact_fn(pt._on(CPU)), *hand["state"])
    want = _jax_call(jt.model, jt._contact_fn, *hand["state"])
    kp_max = max(float(hand["c"].cube.pp.kp.max()), float(hand["c"].ground.pp.kp.max()), pt._pp_corner.kp)
    _compare(got, want, 3 * kp_max)


def test_add_fext_s_keeps_structural_zeros():
    a = [[0.0, 1.0, torch.ones(3)] + [0.0] * 3]
    b = [[0.0, 2.0, torch.ones(3)] + [0.0, torch.full((3,), 4.0), 0.0]]
    out = tc.add_fext_s(a, b, [[0.0] * 6])
    assert out[0][0] == 0.0 and isinstance(out[0][0], float) and out[0][1] == 3.0
    assert torch.equal(out[0][2], torch.full((3,), 2.0)) and torch.equal(out[0][4], torch.full((3,), 4.0))
    want = jc.add_fext_s([[0.0, 1.0, jnp.ones(3)] + [0.0] * 3], [[0.0, 2.0, jnp.ones(3)] + [0.0, jnp.full(3, 4.0), 0.0]],
                         [[0.0] * 6])
    assert [isinstance(x, float) for x in want[0]] == [isinstance(x, float) for x in out[0]]


def test_corner_signs_and_box_corners():
    assert tc._CORNER_SIGNS == jc._CORNER_SIGNS
    want = np.asarray(jc._CORNER_SIGNS, np.float32) * np.float32(jhand.CUBE_HALF)
    np.testing.assert_array_equal(tc.box_corners(HALF, CPU).numpy(), want)


@pytest.mark.parametrize("name", HANDS)
def test_hand_model_and_pair_gains_match_exactly(name):
    """hand_model (every array, index tuple and derived layout) and the
    task's pair gains, bowl centre and pair count."""
    jt, pt = getattr(jhand, name)(), getattr(thand, name)()
    jm, pm = jt.model, pt.model
    for f in jm.__dataclass_fields__:
        a, b = getattr(jm, f), getattr(pm, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        elif f == "geoms":
            assert [(g.body, g.offset, g.radius, g.m_eff) for g in b] == [(g.body, g.offset, g.radius, g.m_eff) for g in a]
        else:
            assert a == b, f
    for f in ("nq_per_joint", "nv_per_joint", "q_start", "v_start", "nq", "nv", "nu", "q_of_dof"):
        assert getattr(pm, f) == getattr(jm, f), f
    np.testing.assert_array_equal(pm.neutral_q(), jm.neutral_q())
    for f in ("cube", "cube_q", "cube_v", "n_contact_pairs", "_bowl_center", "obs_dim", "action_dim",
              "max_episode_length", "substeps", "palm", "bowl_radius"):
        assert getattr(pt, f) == getattr(jt, f), f
    for f in ("_pp_ground", "_pp_cube"):
        assert [p.__dict__ for p in getattr(pt, f)] == [p.__dict__ for p in getattr(jt, f)], f
    for f in ("_pp_corner", "_pp_bowl"):
        assert getattr(pt, f).__dict__ == getattr(jt, f).__dict__, f


@pytest.mark.parametrize("name", HANDS)
def test_position_mode_substep_matches_jax(name):
    """One ``physics_step`` of the hand (world-rooted finger chains, a free
    cube, the position servo, finite joint limits, armature), free flight:
    the first test of position control and world-rooted chains."""
    jt, pt = getattr(jhand, name)(), getattr(thand, name)()
    m, pm = jt.model, pt.model
    q, qd, _ = _hand_states(pt, seed=1)
    rng = np.random.RandomState(2)
    # a few fingers past their limits, so the limit springs act too
    q[: E // 4, : pt.n_dof] += rng.choice([-0.3, 0.3], (E // 4, pt.n_dof)).astype(np.float32)
    action = rng.uniform(-1.2, 1.2, (E, pt.action_dim)).astype(np.float32)  # past ±1: the servo clips
    tau_j = jax.vmap(lambda q, qd, a: jnp.stack([jnp.zeros(()) + x for x in jd._tau_s(
        m, [q[i] for i in range(m.nq)], [a[k] for k in range(m.nu)], [qd[d] for d in range(m.nv)])]))(q, qd, action)
    tau_t = td._tau_s(pm, _cols(q), _cols(action), _cols(qd))
    np.testing.assert_allclose(np.moveaxis(_arr(tau_t), -1, 0), np.array(tau_j), rtol=1e-5, atol=1e-6)
    want = jax.jit(jax.vmap(lambda q, qd, a: jd.physics_step(m, q, qd, a)))(q, qd, action)
    got = td.physics_step(pm, torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(action))
    np.testing.assert_allclose(got[0].numpy(), np.array(want[0]), rtol=1e-5, atol=1e-6, err_msg="q")
    np.testing.assert_allclose(got[1].numpy(), np.array(want[1]), rtol=1e-5, atol=1e-4, err_msg="qd")
