"""IDDPG of the port against the JAX package, on the CPU.

- n-step staging with two reward channels: against two single-channel runs
  of the port and against the JAX ``nstep_scan`` on the same inputs, for
  ``nstep`` 1 and 3 (after tests/test_multi_agent.py:264-285);
- the replay ring with two reward channels: the layout and the field views
  of the JAX ``create_replay``'s, minus its lane padding, after the same
  writes, and one batch at the same indices;
- the warm-up and one iteration from a converted JAX state with the JAX
  draws, rebuilt from ``state.rng`` by the JAX package's own splits
  (``_explore``'s split and per step ``k, k_a, k_e = split(k, 3)``, the
  mixed noise's per-row normals on the joint action; ``_update``'s
  ``split(k, update_times)`` and per update ``k_s, k_r, k_l = split(key,
  3)``, ``replay_sample``'s slot and env keys), on BimanualReacher and on
  BimanualReacherSym (mirrored envs: the explore split through the
  tracker, the update without one), and with fixed noise: the six networks,
  the four Adam states, obs-rms, the replay's fields (both reward channels),
  the n-step FIFO, the episode statistics and the counters. Episodes are
  cut at 6 steps so that they end in the compared iteration;
- the eval hook; kill and resume bitwise; the entry point's evals, best
  model, checkpoint and resume through ``train.main``; a JAX best-model
  snapshot into the port.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import state_diffs
from pql_tpu.algos import get_algo as j_get_algo
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.envs import make_env as j_make_env
from pql_tpu.ops.noise import per_row_normal
from pql_tpu.replay import create_nstep as j_create_nstep
from pql_tpu.replay import create_replay as j_create_replay
from pql_tpu.replay import nstep_scan as j_nstep_scan
from pql_tpu.replay import replay_add as j_replay_add
from pql_tpu.utils import checkpoint as jckpt
from pql_tpu_torch import train
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.replay import ReplayBuffer, create_nstep, nstep_scan
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.convert import iddpg_state_from_jax, load_iddpg_state, params_from_jax, snapshot_from_jax
from pql_tpu_torch.utils.logging import RunLogger
from test_torch_ppo import opt_tree, rms_tree, stats_tree
from test_torch_pql import TOL, _assert_close, _copy
from test_torch_rigid import jax_reset_draws, jax_step_draws

E, MAX_LEN = 16, 6
SMALL = dict(num_envs=E, algo__batch_size=64, algo__memory_size=4096, algo__warm_up=4, algo__update_times=2)
NETS = ("actor", "actor_left", "critic", "critic_left", "critic_target", "critic_target_left")


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def iddpg_tree(s) -> dict:
    """The numpy tree ``iddpg_state_from_jax`` takes, from a numpy JAX IDDPG state."""
    return dict(
        params=s.params, opts={k: opt_tree(o) for k, o in s.opts.items()}, obs_rms=rms_tree(s.obs_rms),
        env_state=dict(state=dict(s.env_state.state), time=s.env_state.time), obs=s.obs,
        nstep=dict(obs=s.nstep.obs, action=s.nstep.action, reward=s.nstep.reward, next_obs=s.nstep.next_obs,
                   done=s.nstep.done, count=s.nstep.count),
        replay=dict(data=s.replay.data, ptr=s.replay.ptr, total_writes=s.replay.total_writes),
        stats=stats_tree(s.stats), env_steps=s.env_steps, update_count=s.update_count,
    )


def iddpg_draws(jagent, cfg, rng, random: bool = False) -> dict:
    """One IDDPG warm-up's (``random``) or iteration's draws, rebuilt from the
    state's key as ``_explore`` (pql_tpu/algos/iddpg.py:150-152, 159-163,
    131-145), ``VecEnv.step`` and ``_update`` (:243, :188-195; replay/buffer.py:
    229-231) split it."""
    E, A, a = cfg.num_envs, jagent.env.action_dim, jagent.ma.action_dim
    B, U, split = cfg.algo.batch_size, cfg.algo.update_times, jax.random.split
    task = jagent.env.task
    rng, k = split(rng)
    action, reset, step = [], [], []
    for _ in range(cfg.algo.warm_up if random else cfg.algo.horizon_len):
        k, k_a, k_e = split(k, 3)
        if random:
            action.append(jax.random.uniform(k_a, (E, A), jnp.float32, -1.0, 1.0))
        elif cfg.algo.noise.type == "mixed":
            action.append(per_row_normal(k_a, (E, A), jnp.float32, 0))
        else:
            action.append(jax.random.normal(k_a, (E, A), jnp.float32))
        k_dyn, k_reset = split(k_e)
        reset.append(jax_reset_draws(task, jagent.env.env_keys(k_reset, 0)))
        step.append(jax_step_draws(task, jagent.env.env_keys(k_dyn, 0)))
    t = lambda xs: torch.from_numpy(np.array(jnp.stack(xs)))  # noqa: E731
    draws = {"action_uniform" if random else "explore_normal": t(action), "reset": torch.stack(reset)}
    if step[0] is not None:
        draws["step"] = torch.stack(step)
    if random:
        return draws
    _, k = split(rng)
    out = {n: [] for n in ("sample_slot", "sample_env", "target_normal", "target_normal_left")}
    for key in split(k, U):
        k_s, k_r, k_l = split(key, 3)
        k_slot, k_env = split(k_s)
        out["sample_slot"].append(jax.random.randint(k_slot, (B,), 0, 1 << 30))
        out["sample_env"].append(jax.random.randint(k_env, (B,), 0, E))
        out["target_normal"].append(jax.random.normal(k_r, (B, a), jnp.float32))
        out["target_normal_left"].append(jax.random.normal(k_l, (B, a), jnp.float32))
    draws.update({n: t(v) for n, v in out.items()})
    draws["sample_slot"], draws["sample_env"] = draws["sample_slot"].long(), draws["sample_env"].long()
    return draws


def _agents(task, **extra):
    size = dict(SMALL, task=task, **extra)
    jcfg = j_make_config("iddpg", **size)
    jagent = j_get_algo("IDDPG")(jcfg, j_make_env(jcfg))
    agent = get_algo("IDDPG")(make_config("iddpg", **size), device="cpu")
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    return jcfg, jagent, agent


def _port_state(agent, js):
    state = agent.init(seed=5)
    load_iddpg_state(state, iddpg_state_from_jax(iddpg_tree(js), js.replay.layout))
    return state


def assert_iddpg_state(state, after, lr_steps: float):
    """Every part of a port IDDPG state against a numpy JAX one."""
    for name in NETS:
        got = {k.split(".", 1)[1]: v for k, v in state.nets.state_dict().items() if k.split(".", 1)[0] == name}
        _assert_close(got, params_from_jax(after.params[name]), name, lr_steps)
    assert set(state.opts) == set(after.opts) == {"actor", "actor_left", "critic", "critic_left"}
    for name, opt in state.opts.items():  # the Adam moments and counts
        want = opt_tree(after.opts[name])
        for k, pname in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments = {n: opt.state[p][pname] for n, p in state.nets[name].named_parameters()}
            _assert_close(moments, params_from_jax(want[k]), f"{name}.{k}", lr_steps)
        assert all(int(s["step"]) == want["count"] for s in opt.state.values()), name
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(state.obs_rms, k).numpy(), getattr(after.obs_rms, k), err_msg=k, **TOL)
    assert state.replay.layout == tuple(x for x in after.replay.layout)
    for name, s, d in after.replay.layout:
        np.testing.assert_allclose(state.replay.field(name).numpy(), after.replay.data[..., s : s + d],
                                   err_msg=f"replay {name}", **TOL)
    assert (state.replay.ptr, state.replay.total_writes) == (int(after.replay.ptr), int(after.replay.total_writes))
    for k in ("obs", "action", "reward", "next_obs", "done"):
        np.testing.assert_allclose(getattr(state.nstep, k).numpy(), getattr(after.nstep, k), err_msg=f"nstep {k}",
                                   **TOL)
    assert state.nstep.count == int(after.nstep.count)
    np.testing.assert_allclose(state.obs.numpy(), after.obs, **TOL)
    want = iddpg_state_from_jax(iddpg_tree(after), after.replay.layout)["stats"]
    got = state.stats.state_dict()
    for name, v in want["accumulators"].items():
        np.testing.assert_allclose(got["accumulators"][name].numpy(), v.numpy(), err_msg=name, **TOL)
    for name, t in want["trackers"].items():
        for k in ("ring", "ptr", "count"):
            np.testing.assert_allclose(got["trackers"][name][k].numpy(), t[k].numpy(), err_msg=f"{name}.{k}", **TOL)
    assert (state.env_steps, state.update_count) == (int(after.env_steps), int(after.update_count))


# ------------------------------------------------------------ n-step, replay


@pytest.mark.parametrize("nstep", [1, 3])
def test_two_channel_nstep_matches_single_runs_and_jax(nstep):
    T, gamma = 7, 0.9
    rs = np.random.RandomState(nstep)
    traj = dict(obs=rs.randn(T, E, 4), action=rs.randn(T, E, 2), reward=rs.randn(T, E, 2),
                next_obs=rs.randn(T, E, 4), done=(rs.rand(T, E, 1) < 0.25))
    traj = {k: v.astype(np.float32) for k, v in traj.items()}
    t_traj = lambda tr: {k: list(torch.from_numpy(v)) for k, v in tr.items()}  # noqa: E731
    st, out, valid = nstep_scan(create_nstep(E, 4, 2, nstep, gamma, device="cpu", reward_dim=2), t_traj(traj))
    jst, jout, jvalid = j_nstep_scan(j_create_nstep(E, 4, 2, nstep, gamma, reward_dim=2),
                                     {k: jnp.asarray(v) for k, v in traj.items()})
    assert out["reward"].shape == (T, E, 2) and out["done"].shape == (T, E, 1)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), err_msg=k, **TOL)
        np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(jst, k)), err_msg=k, **TOL)
    assert valid == [bool(v) for v in np.asarray(jvalid)] and st.count == int(jst.count) == T
    for c in range(2):
        one, out1, _ = nstep_scan(create_nstep(E, 4, 2, nstep, gamma, device="cpu"),
                                  t_traj(dict(traj, reward=traj["reward"][..., c : c + 1])))
        assert torch.equal(out["reward"][..., c : c + 1], out1["reward"]) and torch.equal(out["done"], out1["done"])
        assert torch.equal(out["next_obs"], out1["next_obs"]) and torch.equal(st.reward[..., c : c + 1], one.reward)
    if nstep == 3:
        assert traj["done"].any() and not torch.equal(out["reward"][..., 0], out["reward"][..., 1])


def test_two_channel_replay_matches_jax():
    slots, rs = 6, np.random.RandomState(0)
    jrep = j_create_replay(slots, E, 24, 4, reward_dim=2)
    rep = ReplayBuffer(slots, E, 24, 4, device="cpu", reward_dim=2)
    assert rep.layout == jrep.layout == (("obs", 0, 24), ("action", 24, 4), ("reward", 28, 2),
                                         ("next_obs", 30, 24), ("done", 54, 1))
    assert rep.data.shape[-1] == 55 and jrep.data.shape[-1] == 64  # the JAX lane padding, not the port's
    for _ in range(8):  # past the wrap
        rows = dict(obs=rs.randn(1, E, 24), action=rs.randn(1, E, 4), reward=rs.randn(1, E, 2),
                    next_obs=rs.randn(1, E, 24), done=(rs.rand(1, E, 1) < 0.5))
        rows = {k: v.astype(np.float32) for k, v in rows.items()}
        jrep = j_replay_add(jrep, {k: jnp.asarray(v) for k, v in rows.items()})
        rep.add({k: torch.from_numpy(v) for k, v in rows.items()})
    for name, _, _ in rep.layout:
        np.testing.assert_array_equal(rep.field(name).numpy(), np.asarray(jrep.field(name)))
    assert (rep.ptr, rep.total_writes) == (int(jrep.ptr), int(jrep.total_writes))
    raw, env = torch.from_numpy(rs.randint(0, 1 << 30, 32)), torch.from_numpy(rs.randint(0, E, 32))
    batch = rep.sample(raw, env)
    flat = np.asarray(jrep.data).reshape(slots * E, -1)[((raw % slots) * E + env).numpy()]
    for name, s, d in jrep.layout:
        np.testing.assert_array_equal(batch[name].numpy(), flat[:, s : s + d])


# ------------------------------------------------------------ the agent


@pytest.mark.parametrize("task", ["BimanualReacher", "BimanualReacherSym"])
def test_warmup_matches_jax(task):
    jcfg, jagent, agent = _agents(task)
    js = jagent.init(jax.random.PRNGKey(0))
    before = _copy(js)
    draws = iddpg_draws(jagent, jcfg, js.rng, random=True)
    js, _ = jagent.warmup(js)
    state, _ = agent.warmup(_port_state(agent, before), draws)
    assert_iddpg_state(state, _copy(js), 0.0)
    assert state.replay.total_writes == 4 and state.env_steps == 4 * E


CASES = [pytest.param("BimanualReacher", {}, id="reacher"),
         pytest.param("BimanualReacherSym", {}, id="reacher_sym"),
         pytest.param("BimanualReacher", dict(algo__noise__type="fixed", algo__handle_timeout=False), id="fixed")]


@pytest.mark.parametrize("task,extra", CASES)
def test_one_iteration_matches_jax(task, extra):
    jcfg, jagent, agent = _agents(task, **extra)
    js, _ = jagent.warmup(jagent.init(jax.random.PRNGKey(0)))
    js, _ = jagent.train_iter(js)  # moments and targets off their initial values
    before = _copy(js)
    draws = iddpg_draws(jagent, jcfg, js.rng)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)
    state, metrics = agent.train_iter(_port_state(agent, before), draws)

    assert set(metrics) == set(jmetrics) >= {"train/critic_loss", "train/actor_loss", "train/critic_loss_left",
                                              "train/actor_loss_left"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    assert_iddpg_state(state, after, 2 * jcfg.algo.actor_lr * jcfg.algo.update_times)  # actor_lr == critic_lr
    assert int(after.stats.return_tracker.count) > int(before.stats.return_tracker.count)  # episodes ended
    reward = state.replay.field("reward")[: state.replay.total_writes]
    assert not torch.equal(reward[..., 0], reward[..., 1])  # two distinct channels
    if task == "BimanualReacherSym":
        assert 0 < float(agent.env.symmetry_tracker(state.env_state).mean()) < 1


def test_eval_hook_matches_jax():
    jcfg, jagent, agent = _agents("BimanualReacherSym")
    js = _copy(jagent.init(jax.random.PRNGKey(2)))
    state = _port_state(agent, js)
    obs = np.random.default_rng(5).normal(size=(E, 24)).astype(np.float32)
    want = jagent.eval_actor_apply(js.params, jnp.asarray(obs))
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), torch.from_numpy(obs))
    assert got.shape == (E, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ loop, checkpoints


LOOP = dict(task="BimanualReacher", num_envs=8, algo__batch_size=32, algo__memory_size=2048, algo__warm_up=4,
            algo__update_times=2, logging__mode="off")


def test_kill_and_resume_bitwise(tmp_path):
    def build():
        cfg = make_config("iddpg", checkpoint_dir=str(tmp_path / "ckpt"), **LOOP)
        return get_algo("IDDPG")(cfg, device="cpu"), cfg

    agent, _ = build()
    s, _ = agent.warmup(agent.init(seed=0))
    s, _ = agent.train_iter(s)
    checkpoint.save_checkpoint(str(tmp_path / "ckpt" / "state"), s)
    for _ in range(2):
        s, m = agent.train_iter(s)
    agent2, cfg2 = build()
    s2, resumed = checkpoint.maybe_resume_full_state(cfg2, agent2.init(seed=99))
    assert resumed
    for _ in range(2):
        s2, m2 = agent2.train_iter(s2)
    assert state_diffs(s, s2) == [] and all(torch.equal(m[k], m2[k]) for k in m)
    assert (s2.env_steps, s2.update_count) == ((4 + 3) * 8, 3 * 2)
    sd = checkpoint.state_dict(s2)
    assert {k.split(".")[0] for k in sd["nets"]} == set(NETS) and set(sd["opts"]) == set(NETS[:4])
    assert sd["replay"]["data"].shape[-1] == 55 and sd["nstep"]["reward"].shape[-1] == 2


def test_entry_point_evaluates_checkpoints_and_resumes(tmp_path, capsys):
    """``train.main algo=iddpg``: 8 envs, eval every 4 iterations, a full
    checkpoint every 6, stopped past 14 iterations; rerun to 20 it resumes
    from iteration 12 without a warm-up and ends bitwise where one run of
    20 iterations ends."""
    warm, per_iter = 4 * 8, 8
    common = [f"{k.replace('__', '.')}={v}" for k, v in LOOP.items() if k != "logging__mode"] + [
        "eval_num_envs=8", "algo.eval_freq=4", "algo.log_freq=2", "checkpoint_freq=6", "logging.console=false",
        f"logging.out_dir={tmp_path / 'runs'}"]
    train.main(["algo=iddpg", *common, f"max_step={warm + 13 * per_iter}", f"checkpoint_dir={tmp_path / 'ckpt'}",
                "logging.run_name=first", "--device=cpu"])
    recs = [__import__("json").loads(x) for x in open(tmp_path / "runs" / "first" / "metrics.jsonl")]
    it_of = lambda step: (step - warm) // per_iter  # noqa: E731
    assert [it_of(r["step"]) for r in recs if "eval/return" in r] == [4, 8, 12]
    assert all(np.isfinite(r["eval/return"]) for r in recs if "eval/return" in r)
    best = checkpoint.load_model_snapshot(str(tmp_path / "runs" / "first" / "best_model"))
    assert {k.split(".")[0] for k in best["actor"]} == set(NETS)
    assert {k.split(".")[0] for k in best["critic"]} == set(NETS[2:])

    def run(name, ckpt):
        cfg = make_config("iddpg", eval_num_envs=8, checkpoint_dir=str(tmp_path / ckpt), checkpoint_freq=6,
                          max_step=warm + 19 * per_iter, logging__out_dir=str(tmp_path / "runs"),
                          logging__run_name=name, logging__console=False,
                          **dict(LOOP, logging__mode="local", algo__eval_freq=4, algo__log_freq=2))
        logger = RunLogger(cfg)
        try:
            return train.train_baseline(cfg, logger, device="cpu")[1]
        finally:
            logger.close()

    capsys.readouterr()
    resumed = run("second", "ckpt")
    assert f"at env step {warm + 12 * per_iter} (no warm-up)" in capsys.readouterr().out
    whole = run("whole", "ckpt_whole")
    assert state_diffs(resumed, whole) == [] and resumed.update_count == 2 * 20


def test_snapshot_from_jax_starts_the_port(tmp_path):
    """A JAX IDDPG best-model snapshot (``state.params`` and its critics)
    starts every network of the port: eval actions and the critics' and
    targets' Q values within 1e-5."""
    jcfg = j_make_config("iddpg", **LOOP)
    jagent = j_get_algo("IDDPG")(jcfg, j_make_env(jcfg))
    js, _ = jagent.train_iter(jagent.warmup(jagent.init(jax.random.PRNGKey(0)))[0])
    critics = {k: v for k, v in js.params.items() if k.startswith("critic")}
    jckpt.save_model_snapshot(str(tmp_path / "jax_snap"), js.params, critics, js.obs_rms)
    tree = jax.tree_util.tree_map(np.asarray, jckpt.load_model_snapshot(str(tmp_path / "jax_snap")))

    agent = get_algo("IDDPG")(make_config("iddpg", **LOOP), device="cpu")
    os.makedirs(tmp_path / "port_snap")
    torch.save(snapshot_from_jax(tree), tmp_path / "port_snap" / checkpoint.SNAPSHOT_FILE)
    state = agent.init(seed=3)
    state = checkpoint.restore_into_state(state, checkpoint.load_model_snapshot(str(tmp_path / "port_snap")),
                                          agent.snapshot_parts(state))
    assert not state.opts["actor"].state  # weights only
    obs = np.random.default_rng(0).normal(size=(16, 24)).astype(np.float32)
    obs_n = js.obs_rms.normalize(jnp.asarray(obs))
    want = jagent.eval_actor_apply(js.params, obs_n)
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), state.obs_rms.normalize(torch.from_numpy(obs)))
        for name in ("critic_left", "critic_target_left"):
            q_got = state.nets[name](torch.from_numpy(np.array(obs_n))[:, 12:], got[:, 2:])
            q_want = jagent.critic_left.apply(js.params[name], obs_n[:, 12:], jnp.asarray(got.numpy())[:, 2:])
            for g, w in zip(q_got, q_want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
