"""The two-agent tier of the port against the JAX package, on the CPU.

- ``SymmetryManager`` (after tests/test_multi_agent.py:44-107): obs split,
  action merge and reward split, plain and mirrored, on the same inputs as
  the JAX one; ``ranges_to_indices``, ``slice_tensor``, ``parse_multi_rew``;
  the C2 rep helpers copied from pql_tpu/models/emlp.py:55-85;
- ``BimanualReacher`` and ``BimanualReacherSym``: ``init_state`` from the
  JAX draws (the target's radius and angle from one uniform per arm), the
  obs, a rollout of control steps (state, reward, every ``detailed_reward``
  term, success) and the auto-resetting ``VecEnv.step``, whose info keeps
  the nested ``detailed_reward`` dict; the symmetry tracker;
- one iteration of IPPO (two pairs, and one pair under ``same_policy`` on
  the Sym task) and of MAPPO from a converted JAX state with the JAX draws
  (``test_torch_ppo.jax_iteration_draws``; the episodes truncated at 6
  steps inside a horizon of 8): parameters of every network, losses, the
  normalizers, obs, dones, episode statistics (the detailed-reward
  trackers included) and counters;
- the eval hooks (no mirroring) against the JAX ones;
- the spec-less task, unequal obs dims and the divisibility refusals.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.algos import ma_base as jma
from pql_tpu.envs.base import VecEnv as JVecEnv
from pql_tpu.envs.bimanual import BimanualReacher as JReacher
from pql_tpu.envs.bimanual import BimanualReacherSym as JReacherSym
from pql_tpu.models import emlp
from pql_tpu.utils import symmetry as jsym
from pql_tpu_torch.algos import get_algo, ma_base
from pql_tpu_torch.algos.base import make_stats
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs import make_env
from pql_tpu_torch.envs.base import VecEnv, VecEnvState
from pql_tpu_torch.envs.bimanual import BimanualReacher, BimanualReacherSym
from pql_tpu_torch.utils import symmetry as tsym
from pql_tpu_torch.utils.convert import load_ppo_state, ma_state_from_jax, params_from_jax
from test_torch_ppo import _agents, assert_onpolicy_state, jax_iteration_draws, onpolicy_tree
from test_torch_pql import TOL, _assert_close, _copy
from test_torch_rigid import jax_reset_draws

E, T, H = 16, 8, 8
MAX_LEN = 6
SMALL = dict(num_envs=E, algo__horizon_len=H, algo__batch_size=32, algo__update_times=2)


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(mod):
    return mod.MultiAgentSpec(
        single_agent_obs_idx=(((0, 2),), ((2, 4),)), single_agent_obs_dim=(2, 2), single_agent_action_dim=1,
        shared_obs_dim=4, right_reward_terms=("r_term",), left_reward_terms=("l_term",),
        shared_reward_terms=("shared",), mirror_obs_perm=(1, 0), mirror_obs_sign=(1.0, -1.0), mirror_act_perm=(0,),
        mirror_act_sign=(-1.0,))


# --------------------------------------------------------------- symmetry


def test_ranges_and_slices():
    np.testing.assert_array_equal(tsym.ranges_to_indices([(0, 3), (5, 7)]), jsym.ranges_to_indices([(0, 3), (5, 7)]))
    x = np.arange(12.0, dtype=np.float32).reshape(2, 6)
    np.testing.assert_allclose(tsym.slice_tensor(torch.from_numpy(x), [(1, 3), (5, 6)]).numpy(),
                               np.asarray(jsym.slice_tensor(jnp.asarray(x), [(1, 3), (5, 6)])))


@pytest.mark.parametrize("symmetric", [False, True], ids=["plain", "symmetric"])
def test_symmetry_manager_matches_jax(symmetric):
    rng = np.random.default_rng(0)
    m, jm = tsym.SymmetryManager(_spec(tsym), symmetric), jsym.SymmetryManager(_spec(jsym), symmetric)
    obs = rng.normal(size=(8, 4)).astype(np.float32)
    tracker = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.float32)
    act_r, act_l = rng.normal(size=(8, 1)).astype(np.float32), rng.normal(size=(8, 1)).astype(np.float32)
    detailed = {k: rng.normal(size=8).astype(np.float32) for k in ("r_term", "l_term", "shared")}
    for tr in (None, tracker):
        t_tr = None if tr is None else torch.from_numpy(tr)
        j_tr = None if tr is None else jnp.asarray(tr)
        for got, want in zip(m.get_multi_agent_obs(torch.from_numpy(obs), t_tr),
                             jm.get_multi_agent_obs(jnp.asarray(obs), j_tr)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(
            m.get_execute_action(torch.from_numpy(act_r), torch.from_numpy(act_l), t_tr).numpy(),
            np.asarray(jm.get_execute_action(jnp.asarray(act_r), jnp.asarray(act_l), j_tr)))
        for got, want in zip(m.get_multi_agent_rew({k: torch.from_numpy(v) for k, v in detailed.items()}, t_tr),
                             jm.get_multi_agent_rew({k: jnp.asarray(v) for k, v in detailed.items()}, j_tr)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the JAX tests' hand-computed mirrored case
    if symmetric:
        ob_r, ob_l = m.get_multi_agent_obs(torch.tensor([[1.0, 2.0, 3.0, 4.0]]), torch.ones(1))
        assert ob_r.tolist() == [[4.0, -3.0]] and ob_l.tolist() == [[2.0, -1.0]]
        assert m.get_execute_action(torch.tensor([[0.5]]), torch.tensor([[0.25]]), torch.ones(1)).tolist() == [
            [-0.25, -0.5]]
    got = tsym.parse_multi_rew({k: torch.from_numpy(v) for k, v in detailed.items()}, _spec(tsym))
    want = jsym.parse_multi_rew({k: jnp.asarray(v) for k, v in detailed.items()}, _spec(jsym))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_rep_helpers_match_emlp():
    assert ma_base.sign_rep((1, -1, -1)) == emlp.sign_rep((1, -1, -1))
    assert ma_base.perm_sign_rep((2, 0, 1), (1.0, -1.0, 1.0)) == emlp.perm_sign_rep((2, 0, 1), (1.0, -1.0, 1.0))
    assert ma_base.perm_sign_rep((1, 0)) == emlp.perm_sign_rep((1, 0))
    a, b = emlp.sign_rep((1, -1)), emlp.perm_sign_rep((1, 0))
    assert ma_base.concat_reps(a, b) == emlp.concat_reps(a, b)
    env, jenv = VecEnv(BimanualReacher(), 2), JVecEnv(JReacher(), 2)
    ctx, jctx = ma_base.MultiAgentCtx(env), jma.MultiAgentCtx(jenv)
    assert ctx.joint_obs_gen() == jctx.joint_obs_gen() and ctx.act_gen() == jctx.act_gen()
    assert ctx.obs_gen(1) == jctx.obs_gen(1)


# ------------------------------------------------------------ the reacher


@pytest.mark.parametrize("name", ["BimanualReacher", "BimanualReacherSym"])
def test_reacher_steps_match_jax(name):
    jt, pt = {"BimanualReacher": (JReacher(), BimanualReacher()),
              "BimanualReacherSym": (JReacherSym(), BimanualReacherSym())}[name]
    jenv, env = JVecEnv(jt, E), VecEnv(pt, E)
    jenv.max_episode_length = env.max_episode_length = MAX_LEN
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    js = jax.vmap(jt.init_state)(keys)
    s = pt.init_state(jax_reset_draws(jt, keys))
    for k in ("q", "qd", "target", "sym"):
        np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]), err_msg=k, **TOL)
    # the angle is a function of the radius: one uniform per arm drives both
    target = s["target"].numpy()
    r, ang = np.linalg.norm(target, axis=-1), np.arctan2(target[..., 1], target[..., 0])
    np.testing.assert_allclose((ang + np.pi) / (2 * np.pi), (r - 0.08) / 0.11, atol=1e-4)
    np.testing.assert_allclose(pt.get_obs(s).numpy(), np.asarray(jax.vmap(jt.get_obs)(js)), **TOL)

    step = jax.jit(jenv.step)
    jst, _ = jenv.reset(jax.random.PRNGKey(1))
    st = VecEnvState(state={k: torch.from_numpy(np.array(v)) for k, v in jst.state.items()},
                     time=torch.from_numpy(np.array(jst.time)))
    rng, key = np.random.RandomState(2), jax.random.PRNGKey(3)
    trackers = []
    for i in range(T):
        key, k = jax.random.split(key)
        action = rng.uniform(-1.5, 1.5, (E, 4)).astype(np.float32)
        _, k_reset = jax.random.split(k)
        nxt, r, d, info = pt.dynamics(st.state, torch.from_numpy(action))
        w = jax.vmap(jt.dynamics)(jst.state, jnp.asarray(action), jax.random.split(k, E))
        for f in ("q", "qd", "target", "sym"):
            np.testing.assert_allclose(nxt[f].numpy(), np.asarray(w[0][f]), err_msg=f"{i} {f}", **TOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(w[1]), **TOL)
        assert set(info["detailed_reward"]) == set(w[3]["detailed_reward"]) == {
            "reach_right", "reach_left", "ctrl_right", "ctrl_left", "coordination"}
        for term, v in info["detailed_reward"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(w[3]["detailed_reward"][term]), err_msg=term, **TOL)
        np.testing.assert_array_equal(info["success"].numpy(), np.asarray(w[3]["success"]))

        st, obs, reward, done, info = env.step(st, torch.from_numpy(action),
                                               jax_reset_draws(jt, jenv.env_keys(k_reset, 0)))
        jst, jobs, jreward, jdone, jinfo = step(jst, jnp.asarray(action), k)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), err_msg=f"{i} obs", **TOL)
        np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), **TOL)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(info["truncated"].numpy(), np.asarray(jinfo["truncated"]))
        assert set(info["detailed_reward"]) == set(jinfo["detailed_reward"])  # nested, through VecEnv.step
        tracker = env.symmetry_tracker(st)
        np.testing.assert_array_equal(tracker.numpy(), np.asarray(jenv.symmetry_tracker(jst)))
        trackers.append(tracker)
    flags = torch.stack(trackers)
    if name == "BimanualReacherSym":
        assert 0 < float(flags.mean()) < 1  # half the episodes are mirrored
    else:
        assert float(flags.abs().sum()) == 0


def test_stats_track_the_detailed_reward_terms():
    cfg = make_config("ippo", task="BimanualReacher", **SMALL)
    stats = make_stats(cfg, make_env(cfg), "cpu")
    assert set(stats.detailed_tracker) == {"reach_right", "reach_left", "ctrl_right", "ctrl_left", "coordination"}
    assert make_env(make_config("ppo", task="Cartpole")).multi is None


# ------------------------------------------------------------- iterations


def _normals(algo):
    a = 2  # per-hand action dim
    if algo == "ippo":
        return lambda ks: {"action_normal": jax.random.normal(ks[0], (E, a), jnp.float32),
                           "action_normal_left": jax.random.normal(ks[1], (E, a), jnp.float32)}
    return lambda k: {"action_normal": jax.random.normal(k, (2 * E, a), jnp.float32)}


CASES = [
    pytest.param("ippo", "BimanualReacher", {}, id="ippo"),
    pytest.param("ippo", "BimanualReacherSym", dict(algo__same_policy=True), id="ippo-same_policy-sym"),
    pytest.param("mappo", "BimanualReacher", dict(algo__value_norm=True), id="mappo"),
]


@pytest.mark.parametrize("algo,task,extra", CASES)
def test_one_iteration_matches_jax(algo, task, extra):
    jcfg, jagent, agent = _agents(algo, task=task, **SMALL, **extra)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js = jagent.init(jax.random.PRNGKey(0))
    js, _ = jagent.train_iter(js)
    before = _copy(js)
    rows = (2 if algo == "mappo" else 1) * H * E
    draws = jax_iteration_draws(jagent, jcfg, js.rng, _normals(algo), rows)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)

    state = agent.init()
    load_ppo_state(state, ma_state_from_jax(onpolicy_tree(before)))
    state, metrics = agent.train_iter(state, draws)

    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    n_updates = jcfg.algo.update_times * rows // jcfg.algo.batch_size
    bound = 2 * jcfg.algo.actor_lr * n_updates  # actor_lr == critic_lr
    if algo == "ippo":
        names = ("actor", "critic") if extra else ("actor", "critic", "actor_left", "critic_left")
        assert set(after.params) == set(names) == set(state.nets)
        for name in names:
            got = {k.split(".", 1)[1]: v for k, v in state.nets.state_dict().items() if k.split(".", 1)[0] == name}
            _assert_close(got, params_from_jax(after.params[name]), name, bound)
    else:
        _assert_close(state.actor.state_dict(), params_from_jax(after.actor_params), "actor", bound)
        _assert_close(state.critic.state_dict(), params_from_jax(after.critic_params), "critic", bound)
    assert_onpolicy_state(state, after, algo)
    assert int(after.stats.return_tracker.count) > int(before.stats.return_tracker.count)  # episodes ended
    assert state.update_count == 2 * n_updates


@pytest.mark.parametrize("algo", ["ippo", "mappo"])
def test_eval_hook_matches_jax(algo):
    task = "BimanualReacherSym"
    jcfg, jagent, agent = _agents(algo, task=task, **SMALL)
    js = _copy(jagent.init(jax.random.PRNGKey(2)))
    state = agent.init()
    load_ppo_state(state, ma_state_from_jax(onpolicy_tree(js)))
    obs = np.random.default_rng(5).normal(size=(E, 24)).astype(np.float32)
    params = js.params if algo == "ippo" else js.actor_params
    want = jagent.eval_actor_apply(params, jnp.asarray(obs))
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), torch.from_numpy(obs))
    assert got.shape == (E, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_refusals():
    with pytest.raises(ValueError, match="no MultiAgentSpec"):
        get_algo("IPPO")(make_config("ippo", task="Cartpole", **SMALL), device="cpu")
    with pytest.raises(ValueError, match="must be divisible by batch_size"):
        get_algo("IPPO")(make_config("ippo", task="BimanualReacher", **dict(SMALL, algo__horizon_len=3)),
                         device="cpu")
    # MAPPO drops the remainder, as the JAX epoch_minibatches does
    agent = get_algo("MAPPO")(make_config("mappo", task="BimanualReacher", **dict(SMALL, algo__horizon_len=3)),
                              device="cpu")
    state, _ = agent.train_iter(agent.init())
    assert state.update_count == 2 * (2 * 3 * E // 32)
