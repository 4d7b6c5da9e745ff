"""The ported hand tasks (pql_tpu_torch.envs.hand) against the JAX package, on the CPU.

Cases: AllegroHand and ShadowHand on the flat palm, and AllegroHand with
``palm = "bowl"``. For each, a JAX ``VecEnv`` of E = 8 envs with
``max_episode_length`` cut to ``MAX_LEN`` is reset from a key, and two envs
are set up to reach the task's events on the first step:

- env 0's cube is lifted 1 m (beyond the 0.24 m fall distance), so it
  terminates (a fall) and auto-resets;
- env 1's target is set to the orientation its cube will have after the
  first step (taken once beforehand: the target does not enter the
  physics), so its goal is reached on the first step and re-sampled from
  the step's draw.

The jitted JAX ``VecEnv.step`` (compiled once per case, the costly part of
this file, ~20 s) then runs ``ROLL`` steps under uniform numpy actions;
the rollout also reaches the time limit (steps MAX_LEN - 1 and MAX_LEN).
``test_rollout_covers_fall_success_and_truncation`` asserts all three.

At every step the port starts from the JAX state and takes the same step:
``dynamics`` with the step draws rebuilt from the step's dynamics key
(``jax_step_draws``), its reward, terminated and success against the JAX
step's, its next state against the JAX one where the env did not reset;
and ``VecEnv.step`` with the reset draws rebuilt from the reset key
(``jax_reset_draws``).

Tolerances (fp32 on both sides, sums in other orders):
- ``init_state`` from the same draws: exact on the finger angles, the
  cube position and the contact state; atol 1e-6 on the quaternions (the
  two frameworks' sin and cos differ by an ulp);
- ``get_obs``: rtol 1e-6 / atol 1e-6;
- one step's state, obs and reward: rtol 1e-4 with atol 1e-5 on positions,
  anchors, targets and the reward, as for the rigid tasks
  (tests/test_torch_rigid.py). Velocities (qd and the obs) get rtol 1e-4
  with atol 1e-3, and 1e-2 on the cube's angular velocity: the cube's
  inertia is 8e-5 kg·m², so a capped 80 N finger contact at its 3.5 cm
  lever turns it at ~3e4 rad/s², and a substep's increments of tens of
  rad/s cancel to the final velocity. Against the port's own float64 step
  from the same states, the port's fp32 step is off by up to 4.4e-3 rad/s
  on the cube's angular velocity and the JAX package's by up to 2.9e-3, so
  the two fp32 steps may differ by their sum (7.3e-3 seen); the other
  velocities by up to 2e-4;
- terminated, success, done, truncated and the episode clocks: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pql_tpu.envs.hand as jhand
import pql_tpu_torch.envs.hand as thand
from pql_tpu.envs.base import VecEnv as JVecEnv
from pql_tpu_torch.cfg import make_config, parse_cli
from pql_tpu_torch.envs import make_task
from pql_tpu_torch.envs.base import VecEnv, VecEnvState
from test_torch_rigid import jax_reset_draws, jax_step_draws

CASES = [("AllegroHand", "flat"), ("ShadowHand", "flat"), ("AllegroHand", "bowl")]
IDS = ["AllegroHand", "ShadowHand", "AllegroHand-bowl"]
E = 8
MAX_LEN = 12
ROLL = MAX_LEN + 2
TOL = dict(rtol=1e-4, atol=1e-5)
VEL_ATOL, CUBE_W_ATOL = 1e-3, 1e-2  # velocities; the cube's angular velocity (see the docstring)


def _assert_close(pt, field, got, want, msg):
    """assert_allclose with the tolerances of a state field or of "obs"
    (see the module docstring)."""
    if field not in ("qd", "obs"):
        np.testing.assert_allclose(got, want, err_msg=msg, **TOL)
        return
    # the cube's angular velocity: qd's slots, or obs's (q, qd of the fingers,
    # cube position, quaternion, linear velocity, angular velocity, ...)
    w = pt.cube_v if field == "qd" else 2 * pt.n_dof + 3 + 4 + 3
    ang = np.zeros(got.shape[-1], bool)
    ang[w : w + 3] = True
    np.testing.assert_allclose(got[..., ~ang], want[..., ~ang], rtol=1e-4, atol=VEL_ATOL, err_msg=msg)
    np.testing.assert_allclose(got[..., ang], want[..., ang], rtol=1e-4, atol=CUBE_W_ATOL,
                               err_msg=f"{msg} (the cube's angular velocity)")


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(x):
    return jax.tree_util.tree_map(np.array, x)


def _state(jstate):
    return {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}


def _tasks(name, palm):
    jt, pt = getattr(jhand, name)(), getattr(thand, name)()
    jt.palm = pt.palm = palm
    return jt, pt


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def rollout(request):
    name, palm = request.param
    jt, pt = _tasks(name, palm)
    jenv = JVecEnv(jt, E)
    jenv.max_episode_length = MAX_LEN
    step = jax.jit(jenv.step)
    s, _ = jenv.reset(jax.random.PRNGKey(0))
    cq = jt.cube_q
    s = s.replace(state=dict(s.state, q=s.state["q"].at[0, cq + 2].set(1.0)))  # env 0: the cube 1 m up
    rng, key = np.random.RandomState(1), jax.random.PRNGKey(1)
    keys = jax.random.split(key, ROLL + 1)[1:]
    actions = rng.uniform(-1, 1, (ROLL, E, jt.action_dim)).astype(np.float32)
    first = step(s, jnp.asarray(actions[0]), keys[0])[0].state["q"][1, cq + 3 : cq + 7]
    s = s.replace(state=dict(s.state, target=s.state["target"].at[1].set(first)))  # env 1: at its goal
    steps = []
    for k, action in zip(keys, actions):
        out = step(s, jnp.asarray(action), k)
        k_dyn, k_reset = jax.random.split(k)
        steps.append(dict(
            state=_np_tree(dict(s.state)), time=np.array(s.time), action=action,
            reset_draw=jax_reset_draws(jt, jenv.env_keys(k_reset, 0)),
            step_draw=jax_step_draws(jt, jenv.env_keys(k_dyn, 0)),
            out=_np_tree((dict(out[0].state), out[0].time, out[1], out[2], out[3], out[4]["truncated"],
                          out[4]["success"])),
        ))
        s = out[0]
    return dict(jt=jt, pt=pt, steps=steps)


@pytest.mark.parametrize("name", ["AllegroHand", "ShadowHand"])
def test_init_state_from_injected_draws(name):
    jt, pt = getattr(jhand, name)(), getattr(thand, name)()
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(jnp.arange(E))
    want = _np_tree(jax.vmap(jt.init_state)(keys))
    got = pt.init_state(jax_reset_draws(jt, keys))
    assert set(got) == set(want)
    cq = pt.cube_q
    np.testing.assert_array_equal(got["q"][:, : cq + 3].numpy(), want["q"][:, : cq + 3])
    np.testing.assert_allclose(got["q"][:, cq + 3 :].numpy(), want["q"][:, cq + 3 :], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["target"].numpy(), want["target"], rtol=0, atol=1e-6)
    for k in ("qd", "contact"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("name", ["AllegroHand", "ShadowHand"])
def test_draws_shape_and_ranges(name):
    pt = make_task(name)
    gen = torch.Generator().manual_seed(0)
    draw = pt.draw_reset(gen, 4096)
    assert draw.shape == (4096, pt.n_dof + 6)
    assert draw[:, : pt.n_dof].abs().max() <= 0.1 and 0.0 <= draw[:, pt.n_dof :].min() <= draw.max() < 1.0
    state = pt.init_state(draw)
    for quat in (state["target"], state["q"][:, pt.cube_q + 3 : pt.cube_q + 7]):
        np.testing.assert_allclose(torch.linalg.vector_norm(quat, dim=-1).numpy(), 1.0, atol=1e-6)
    # uniform rotations: the mean of each quaternion component is 0, of its square 1/4
    np.testing.assert_allclose(state["target"].mean(0).numpy(), 0.0, atol=0.03)
    np.testing.assert_allclose(state["target"].square().mean(0).numpy(), 0.25, atol=0.02)
    step = pt.draw_step(gen, 4096)
    assert step.shape == (4096, 3) and 0.0 <= step.min() <= step.max() < 1.0


def test_rollout_covers_fall_success_and_truncation(rollout):
    out = [st["out"] for st in rollout["steps"]]
    terminated = [(o[4] > 0) & ~o[5] for o in out]
    assert terminated[0][0], "the lifted cube falls on the first step"
    assert out[0][6][1] == 1.0, "the upright cube reaches its target on the first step"
    goal = rollout["steps"][0]["state"]["target"][1]
    assert not np.allclose(out[0][0]["target"][1], goal), "a reached goal is re-sampled"
    assert out[MAX_LEN - 1][5][1:].all() and out[MAX_LEN][5][0], "every env reaches the time limit"


def test_get_obs(rollout):
    jt, pt = rollout["jt"], rollout["pt"]
    for t, st in enumerate(rollout["steps"]):
        want = np.array(jax.vmap(jt.get_obs)({k: jnp.asarray(v) for k, v in st["state"].items()}))
        got = pt.get_obs(_state(st["state"])).numpy()
        assert got.shape == (E, pt.obs_dim)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"step {t}")


def test_dynamics_reward_terminated_and_success(rollout):
    pt = rollout["pt"]
    for t, st in enumerate(rollout["steps"]):
        nxt, reward, terminated, info = pt.dynamics(_state(st["state"]), torch.from_numpy(st["action"]),
                                                    st["step_draw"])
        jstate, _, _, jreward, jdone, jtrunc, jsuccess = st["out"]
        np.testing.assert_array_equal(terminated.numpy(), (jdone > 0) & ~jtrunc, err_msg=f"step {t}")
        np.testing.assert_array_equal(info["success"].numpy(), jsuccess, err_msg=f"step {t}")
        np.testing.assert_allclose(reward.numpy(), jreward, err_msg=f"step {t}", **TOL)
        kept = jdone == 0
        for k, v in jstate.items():
            _assert_close(pt, k, nxt[k].numpy()[kept], v[kept], f"step {t} {k}")


def test_vec_env_step(rollout):
    pt = rollout["pt"]
    env = VecEnv(pt, E)
    env.max_episode_length = MAX_LEN
    for t, st in enumerate(rollout["steps"]):
        s = VecEnvState(state=_state(st["state"]), time=torch.from_numpy(st["time"]))
        s2, obs, reward, done, info = env.step(s, torch.from_numpy(st["action"]), st["reset_draw"], st["step_draw"])
        jstate, jtime, jobs, jreward, jdone, jtrunc, jsuccess = st["out"]
        np.testing.assert_array_equal(done.numpy(), jdone, err_msg=f"step {t}")
        np.testing.assert_array_equal(info["truncated"].numpy(), jtrunc, err_msg=f"step {t}")
        np.testing.assert_array_equal(info["success"].numpy(), jsuccess, err_msg=f"step {t}")
        np.testing.assert_array_equal(s2.time.numpy(), jtime, err_msg=f"step {t}")
        for k, v in jstate.items():
            _assert_close(pt, k, s2.state[k].numpy(), v, f"step {t} {k}")
        _assert_close(pt, "obs", obs.numpy(), jobs, f"step {t} obs")
        np.testing.assert_allclose(reward.numpy(), jreward, err_msg=f"step {t} reward", **TOL)


def test_hand_config_resolves_as_jax():
    """``algo=pql_d task=AllegroHand`` (and the bench's PQL-D @16384) resolve
    to the JAX package's values on every field the port keeps."""
    from pql_tpu.cfg import parse_cli as j_parse_cli

    for argv in (["algo=pql_d", "task=AllegroHand"], ["algo=pql", "task=ShadowHand", "num_envs=8192"],
                 ["algo=pql_d", "task=AllegroHand", "num_envs=16384", "algo.memory_size=2000000"]):
        got, want = parse_cli(argv), j_parse_cli(argv)
        for f in ("task", "num_envs", "seed", "max_step", "max_time"):
            assert getattr(got, f) == getattr(want, f), (argv, f)
        for f in got.algo.__dataclass_fields__:
            if f != "noise":
                assert getattr(got.algo, f) == getattr(want.algo, f), (argv, f)
        assert got.algo.noise.__dict__ == {k: getattr(want.algo.noise, k) for k in got.algo.noise.__dict__}
    assert make_config("pql", task="AllegroHand").algo.reward_scale == 0.01
