"""The plain references against cases worked out by hand."""

import importlib.util
import math
import os

import pytest
import torch

from conftest import BENCH
from reference import pql_plain, plain


def load(name):
    spec = importlib.util.spec_from_file_location("t_" + name.replace("-", "_"),
                                                  os.path.join(BENCH, "reference", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


hand = load("pql-allegrohand")
vision = load("ddpgv-reachervision")


def test_nstep_discounts_to_the_first_done_and_takes_its_next_obs():
    ns = pql_plain.NStep({"nstep": 3, "gamma": 0.5})
    col = lambda *v: torch.tensor(v, dtype=torch.float32)[:, None]  # noqa: E731
    emitted = [ns.push(col(t, t), col(0, 0), col(1.0, 2.0), col(10 + t, 20 + t), col(0, float(t == 1)))
               for t in range(4)]
    # env 0 never ends: Σ 0.5^i · 1 over three steps, next obs of the newest step
    obs, _, ret, nxt, done = emitted[2]
    assert obs[0, 0] == 0 and ret[0, 0] == pytest.approx(1.75) and nxt[0, 0] == 12 and done[0, 0] == 0
    # env 1 ends at step 1: the window 0..2 stops there, 2 + 0.5·2, next obs of step 1, done
    assert ret[1, 0] == pytest.approx(3.0) and nxt[1, 0] == 21 and done[1, 0] == 1
    # the first push sees the zero-filled FIFO: the oldest entry is zeros, the newest reward is γ²·r
    assert float(emitted[0][0][0, 0]) == 0.0 and float(emitted[0][2][0, 0]) == pytest.approx(0.25)


def test_ring_skips_the_filling_slots_until_it_wraps():
    ring = pql_plain.Ring({"memory": 8 * 4, "E": 4, "H": 1, "nstep": 3})
    for s in range(5):
        ring.add(torch.full((4, 1), float(s)))
    got = ring.sample(torch.tensor([0, 1, 2, 3, 1 << 29]), torch.tensor([0, 1, 2, 3, 0]))
    # valid slots are 2, 3, 4: raw r → 2 + r mod 3
    assert got[:, 0].tolist() == [2.0, 3.0, 4.0, 2.0, 2.0 + (1 << 29) % 3]


def test_adamw_first_step_is_decay_then_a_signed_lr_step():
    p = {"w": torch.tensor([1.0, -2.0])}
    opt = plain.AdamW(p, lr=0.1, max_norm=None)
    opt.step(p, {"w": torch.tensor([0.5, -4.0])})
    # m̂ / √v̂ = sign(g) at the first step; decay 1 − lr·wd first
    want = torch.tensor([1.0, -2.0]) * (1 - 0.1 * 0.01) - 0.1 * torch.tensor([1.0, -1.0]) / (1 + 1e-8 / 0.5)
    torch.testing.assert_close(p["w"], want, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(opt.first["w"], torch.tensor([0.5, -4.0]))


def test_global_norm_clip_scales_only_above_the_norm():
    opt = plain.AdamW({"a": torch.zeros(2)}, lr=0.1, max_norm=1.0)
    g = opt.clip({"a": torch.tensor([3.0, 4.0])})
    torch.testing.assert_close(g["a"], torch.tensor([0.6, 0.8]))
    assert opt.clip({"a": torch.tensor([0.3, 0.4])})["a"].tolist() == pytest.approx([0.3, 0.4])


def test_running_moments_merge_batches_by_hand():
    m = plain.RunningMoments(1, "cpu")
    m.update(torch.tensor([[1.0], [3.0]]))  # batch mean 2, variance (n − 1) 2
    n = 2 + 1e-4
    assert m.mean.item() == pytest.approx(4 / n, rel=1e-6)
    assert m.var.item() == pytest.approx((1e-4 + 2 * 2 + 4 * 1e-4 * 2 / n) / n, rel=1e-6)
    m.update(torch.tensor([[5.0], [5.0]]))  # mean 5, variance 0
    mean1, var1 = 4 / n, (1e-4 + 4 + 4 * 1e-4 * 2 / n) / n
    d, tot = 5 - mean1, n + 2
    assert m.mean.item() == pytest.approx(mean1 + d * 2 / tot, rel=1e-6)
    assert m.var.item() == pytest.approx((var1 * n + d * d * n * 2 / tot) / tot, rel=1e-6)
    assert m.normalize_clip(torch.tensor([[1e6]])).item() == 5.0


def test_mixed_noise_ladder_runs_from_std_min_to_std_max():
    a = plain.mixed_noise_action(torch.zeros(5, 1), torch.ones(5, 1), 0.05, 0.85)
    assert a[:, 0].tolist() == pytest.approx([0.05, 0.25, 0.45, 0.65, 0.85])
    assert plain.smoothed_target_action(torch.zeros(1, 1), torch.tensor([[5.0]]), 0.8, 0.2).item() == pytest.approx(0.2)


def test_quaternion_distance_and_shoemake():
    q = hand.uniform_quat(torch.tensor([[0.0, 0.0, 0.25]]))  # b = 0, a = 1: (sin 0, cos 0, 0, 0)
    assert q[0].tolist() == pytest.approx([0.0, 1.0, 0.0, 0.0], abs=1e-7)
    half = torch.tensor([[math.cos(math.pi / 4), 0.0, 0.0, math.sin(math.pi / 4)]])  # 90° about z
    assert hand.rot_dist(half, torch.tensor([[1.0, 0.0, 0.0, 0.0]])).item() == pytest.approx(math.pi / 2, rel=1e-6)


def test_hand_fresh_obs_layout():
    task = {"n_dof": 4, "links_per_finger": 4, "finger_q0_abduction": 0.0, "finger_q0_curl": 0.2,
            "cube_q0": [0.0, 0.0, 0.037]}
    draw = torch.tensor([[0.01, 0.02, 0.03, 0.04, 0.0, 0.0, 0.25, 0.0, 0.0, 0.25]])
    obs = hand.fresh_obs(draw, task)
    assert obs[0, :4].tolist() == pytest.approx([0.01, 0.22, 0.23, 0.24])
    assert obs[0, 4:8].tolist() == [0.0] * 4 and obs[0, 8:11].tolist() == pytest.approx([0.0, 0.0, 0.037])
    # cube and goal both (0, 1, 0, 0): the relative rotation is the identity
    assert obs[0, -4:].tolist() == pytest.approx([1.0, 0.0, 0.0, 0.0], abs=1e-7)


def reacher_task():
    return dict(link1=0.1, link2=0.11, dt=0.02, max_torque=1.0, damping=0.99, inertia=0.01, max_speed=10.0,
                action_cost=0.1, episode_length=150, link_points=16, target_points=8, target_ring=0.01, view=0.25,
                height=48, width=48)


def test_reacher_step_by_hand():
    env = vision.Reacher(reacher_task(), torch.tensor([[0.0, 0.0, 0.0, 0.1]]))
    assert env.fingertip(env.q)[0].tolist() == pytest.approx([0.21, 0.0])
    reward, done = env.step(torch.tensor([[1.0, 0.0]]), torch.zeros(1, 4))
    # qd = 0.02·1/0.01 = 2 on joint 0, q = 0.02·2 = 0.04
    assert env.qd[0].tolist() == pytest.approx([2.0, 0.0]) and env.q[0].tolist() == pytest.approx([0.04, 0.0])
    tip = [0.21 * math.cos(0.04), 0.21 * math.sin(0.04)]
    assert reward.item() == pytest.approx(-math.hypot(tip[0] - 0.1, tip[1]) - 0.1, rel=1e-5)
    assert done.item() == 0.0 and env.q_prev.tolist() == [[0.0, 0.0]]


def test_reacher_views_shapes_and_splat_peak():
    env = vision.Reacher(reacher_task(), torch.tensor([[0.3, -0.2, 1.0, 0.15]]))
    img, proprio, pc = env.views()
    assert img.shape == (1, 1, 2, 48, 48, 3) and proprio.shape == (1, 6) and pc.shape == (1, 40, 3)
    assert float(img.max()) == pytest.approx(1.0) and float(img[..., 2].abs().max()) == 0.0


def test_same_padding_is_flax_s():
    assert vision.same_pad(48, 7, 2) == (2, 3) and vision.same_pad(24, 3, 2) == (0, 1)
    assert vision.same_pad(12, 3, 1) == (1, 1) and vision.same_pad(12, 1, 2) == (0, 0)


def test_leaf_gaps_are_gaps_of_norms_against_the_median_leaf():
    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 1.0]), "c": torch.tensor([0.0, 2.0])}
    prog = {"a": torch.tensor([4.0, 3.0]), "b": torch.tensor([0.0, 1.5]), "c": torch.tensor([0.0, -2.0])}
    # a: same norm; b: 0.5 / max(1, median 2); c: same norm with the sign flipped
    assert plain.leaf_gaps(prog, ref, ["a", "b", "c"]) == pytest.approx([0.0, 0.25, 0.0])
    assert plain.kept_leaves({"x": torch.ones(4), "y": torch.full((4,), 1e-4), "z": torch.ones(4)}) == ["x", "z"]



def pql_sides():
    """A side and a reference of PQL's learner: three iterations' losses,
    first gradients and parameters of three actor and three critic leaves,
    and 33 + 2 steps' actions (warm-up 32, horizon 1)."""
    leaves = [f"{net}.l{i}" for net in ("actor", "critic") for i in range(3)]
    weights = {k: torch.zeros(4) for k in leaves}
    ref = {"losses": [(1.0, -1.0), (0.5, -2.0), (0.25, -3.0)], "g1": {k: torch.ones(4) for k in leaves},
           "params": {**{k: torch.ones(4) for k in leaves}, **{f"target.l{i}": torch.ones(4) for i in range(3)}},
           "actions": [torch.zeros(2, 3) for _ in range(35)]}
    side = {k: (dict(v) if isinstance(v, dict) else list(v)) for k, v in ref.items()}
    return side, ref, weights, {"warm_up": 32, "H": 1}


def test_pql_numbers_leave_out_what_a_near_tie_of_the_twin_heads_moves():
    """A near tie of min(Q1, Q2) in an actor update moves the later actor
    losses, one actor leaf's change and the later actions: none of them is
    compared. The critic's losses, its worst leaf and the first iteration's
    actions are."""
    side, ref, weights, hp = pql_sides()
    side["losses"] = [(1.0, -1.0), (0.5, -2.5), (0.25, -3.5)]
    side["params"]["actor.l0"] = torch.full((4,), 1.5)
    side["actions"] = ref["actions"][:33] + [torch.full((2, 3), 0.5)] * 2
    assert pql_plain.learner_numbers(side, ref, weights, hp) == {
        "loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0, "action_gap": 0.0}
    side, ref, weights, hp = pql_sides()
    side["losses"] = [(1.0, -1.0), (0.5, -2.0), (0.3, -3.0)]
    side["params"]["target.l2"] = torch.full((4,), 1.5)
    side["actions"] = ref["actions"][:32] + [torch.full((2, 3), 0.5)] + ref["actions"][33:]
    side["params"].update({f"actor.l{i}": torch.full((4,), 2.0) for i in range(2)})
    assert pql_plain.learner_numbers(side, ref, weights, hp) == pytest.approx(
        {"loss_gap": 0.05 / 0.25, "grad_gap": 0.0, "change_gap": 1.0, "action_gap": 0.5})

def hand_physics_config():
    import json

    with open(os.path.join(BENCH, "configs", "pql-allegrohand.json")) as f:
        return json.load(f)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from reference.hand_physics import tf32_round

    x = torch.tensor([1.0 + 2.0**-12, 1.0 + 2.0**-11, -(1.0 + 3 * 2.0**-11), 3.0], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1.0, 1.0 + 2.0**-10, -(1.0 + 2 * 2.0**-10), 3.0]


def test_hand_engine_free_fall_and_servo_at_rest_by_hand():
    from reference.hand_physics import HandEngine

    phys = hand_physics_config()["physics"]
    eng = HandEngine(phys, "cpu")
    q = torch.zeros(1, 23, dtype=torch.float64)
    q[0, 16:19] = torch.tensor([0.0, 0.0, 1.0])  # the cube far above the palm: no contact
    q[0, 19] = 1.0
    q[0, :16] = 0.5  # every finger curled clear of the palm
    qd = torch.zeros(1, 22, dtype=torch.float64)
    act = torch.zeros(1, 16, dtype=torch.float64)
    q2, qd2, cs = eng.substep(q, qd, act, torch.zeros(1, 160, dtype=torch.float64))
    dt, g = phys["dt"], phys["gravity"]
    # the cube falls freely: v = g·dt, then x += dt·v (semi-implicit)
    assert qd2[0, 19:22].tolist() == pytest.approx([0.0, 0.0, g * dt], abs=1e-15)
    assert q2[0, 16:19].tolist() == pytest.approx([0.0, 0.0, 1.0 + g * dt * dt], abs=1e-15)
    # nothing touches: every pair disengaged, its anchor following its point
    assert q2[0, 19:23].tolist() == [1.0, 0.0, 0.0, 0.0] and float(cs.view(1, 40, 4)[..., 3].max()) == 0.0
    # abduction hinges (about the vertical) at their servo target 0 with no gravity torque stay put
    q[0, 0:16:4] = 0.0
    q2, qd2, _ = eng.substep(q, qd, act, torch.zeros(1, 160, dtype=torch.float64))
    assert qd2[0, 0:16:4].abs().max().item() < 1e-12


def test_hand_contact_law_by_hand():
    from reference.hand_physics import HandEngine, pair_gains

    g = pair_gains({"dt": 0.01, "contact_kp": 100.0, "contact_zeta": 1.0, "friction_mu": 0.5,
                    "contact_force_cap": 80.0}, 1.0, 1)
    assert g["kp"] == 100.0 and g["kd"] == pytest.approx(20.0) and g["kdt"] == pytest.approx(70.0)
    up = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    # first touch, 1 mm deep, sliding at 1 m/s: the damping (70 N) capped by the cone (µ·0.1 N), the anchor snaps
    vel = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64)
    f, off, on = HandEngine.anchored(torch.tensor([0.001], dtype=torch.float64), up, vel,
                                     torch.tensor([[0.3, 0.0, 0.0]], dtype=torch.float64),
                                     torch.tensor([0.0], dtype=torch.float64), g)
    assert f[0].tolist() == pytest.approx([-0.05, 0.0, 0.1]) and off[0].tolist() == [0.0, 0.0, 0.0]
    assert on.tolist() == [1.0]
    # engaged and at rest 1 µm past the anchor: the anchor spring alone, inside the cone, the anchor kept
    f, off, _ = HandEngine.anchored(torch.tensor([0.001], dtype=torch.float64), up, torch.zeros_like(vel),
                                    torch.tensor([[1e-6, 0.0, 0.0]], dtype=torch.float64),
                                    torch.tensor([1.0], dtype=torch.float64), g)
    assert f[0].tolist() == pytest.approx([-1e-4, 0.0, 0.1]) and off[0].tolist() == pytest.approx([1e-6, 0.0, 0.0])


def test_hand_engine_follows_the_port_eagerly_on_the_cpu():
    """The plain engine against the port's own control step (eager, fp32)
    from the task's random starts, each step from the port's state."""
    from pql_tpu_torch.envs.hand import AllegroHand
    from reference.hand_physics import HandEngine

    torch.manual_seed(0)
    task, eng = AllegroHand(), HandEngine(hand_physics_config()["physics"], "cpu")
    gen = torch.Generator().manual_seed(5)
    state = task.init_state(task.draw_reset(gen, 16))
    gaps, engaged = [], 0
    for _ in range(8):
        action = torch.rand(16, 16, generator=gen) * 2 - 1
        nxt = task.control_step(state, action, torch.rand(16, 3, generator=gen))[0]
        q, qd, cs = eng.control_step(state["q"].double(), state["qd"].double(), action.double(),
                                     state["contact"].double())
        want = torch.cat([q, qd], -1)
        got = torch.cat([nxt["q"], nxt["qd"]], -1).double()
        gaps.append(((got - want).abs() / (1 + want.abs())).amax(-1))
        assert float((cs - nxt["contact"].double()).abs().max()) < 1e-5
        engaged += int(nxt["contact"].view(16, 40, 4)[..., 3].sum())
        state = nxt
    g = torch.cat(gaps)
    assert engaged > 0 and float(g.median()) < 1e-3 and float(g.max()) < 1e-2
