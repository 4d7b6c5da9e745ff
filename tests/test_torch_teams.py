"""The split-population team agents of the port against the JAX package, on the CPU.

- one iteration of IART, IPPOTeam and IPPOTeam2 on BimanualReacher, and of
  IPPOTeam on BimanualReacherSym (obs split through the tracker, the
  individual actions merged without it), from a converted JAX state with
  the JAX draws (``_train_iter``'s three-way split; per rollout step IART's
  ``split(k, 6)``, IPPOTeam's ``split(k, 5)``; one permutation of the
  H·E/2 training rows per epoch key); episodes truncated at 6 steps inside
  a horizon of 8: every network, the losses, obs-rms, obs, dones, episode
  statistics and counters;
- ``value_norm`` is ignored: a run with it on is bitwise the run with it off;
- the eval hooks; the odd-``num_envs`` refusal and that of an equivariant
  ``act_class`` on a task without an ``EquivarianceSpec``; kill and resume bitwise; the entry point with IART; a JAX
  snapshot of IPPOTeam into the port;
- no module of the port imports JAX, flax, optax or the JAX package.

Tolerance rtol 1e-4 / atol 1e-5 with the Adam allowance of
tests/test_torch_pql.py::_assert_close.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import state_diffs
from pql_tpu.utils import checkpoint as jckpt
from pql_tpu_torch import train
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs.bimanual import BimanualReacher
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.convert import load_ppo_state, ma_state_from_jax, snapshot_from_jax
from pql_tpu_torch.utils.logging import RunLogger
from test_torch_ppo import _agents, assert_onpolicy_state
from test_torch_pql import TOL, _copy
from test_torch_qtot import assert_nets, ma_tree, onpolicy_draws

E, H, MAX_LEN = 16, 8, 6
SMALL = dict(num_envs=E, algo__horizon_len=H, algo__batch_size=32, algo__update_times=2)
NAMES = {"iart": "IART", "ippoteam": "IPPOTeam", "ippoteam2": "IPPOTeam2"}
NETS = {"iart": ("actor", "actor_left", "critic", "critic_left", "actor_team", "actor_left_team", "critic_team",
                 "critic_left_team"),
        "ippoteam": ("actor", "actor_left", "critic", "critic_left", "actor_team", "critic_tot", "critic_team")}
NETS["ippoteam2"] = NETS["ippoteam"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def team_draws(jagent, cfg, rng) -> dict:
    """One iteration's draws of a team agent (teams.py:147, :383): IART's
    four half-population actors, or IPPOTeam's two hands (on all envs, or on
    the first half for IPPOTeam2) and its joint team actor."""
    a, half, normal = 2, cfg.num_envs // 2, jax.random.normal
    if type(jagent).__name__ == "IART":
        def normals(ks):
            return {f"action_normal{s}": normal(k, (half, a), jnp.float32)
                    for s, k in zip(("", "_left", "_team", "_left_team"), ks)}
        n_keys = 6
    else:
        n_ind = cfg.num_envs if jagent.ind_streams_full else half

        def normals(ks):
            return {"action_normal": normal(ks[0], (n_ind, a), jnp.float32),
                    "action_normal_left": normal(ks[1], (n_ind, a), jnp.float32),
                    "action_normal_team": normal(ks[2], (half, 2 * a), jnp.float32)}
        n_keys = 5
    return onpolicy_draws(jagent, cfg, rng, n_keys, normals, cfg.algo.horizon_len * half)


CASES = [pytest.param("iart", "BimanualReacher", id="iart"),
         pytest.param("ippoteam", "BimanualReacher", id="ippoteam"),
         pytest.param("ippoteam2", "BimanualReacher", id="ippoteam2"),
         pytest.param("ippoteam", "BimanualReacherSym", id="ippoteam-sym")]


@pytest.mark.parametrize("algo,task", CASES)
def test_one_iteration_matches_jax(algo, task):
    jcfg, jagent, agent = _agents(algo, task=task, **SMALL)
    jagent.env.max_episode_length = agent.env.max_episode_length = MAX_LEN
    js, _ = jagent.train_iter(jagent.init(jax.random.PRNGKey(0)))  # moments off their initial values
    before = _copy(js)
    draws = team_draws(jagent, jcfg, js.rng)
    js, jmetrics = jagent.train_iter(js)
    after = _copy(js)

    state = agent.init()
    load_ppo_state(state, ma_state_from_jax(ma_tree(before)))
    state, metrics = agent.train_iter(state, draws)

    assert set(metrics) == set(jmetrics) >= {"train/actor_loss_team", "train/critic_loss_team"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), err_msg=k, rtol=1e-4, atol=1e-4)
    n_updates = jcfg.algo.update_times * H * E // 2 // jcfg.algo.batch_size
    assert_nets(state, after, NETS[algo], 2 * jcfg.algo.actor_lr * n_updates)  # actor_lr == critic_lr
    assert_onpolicy_state(state, after, algo)  # the value-rms pair unmoved in both
    assert float(after.value_rms.count) == float(before.value_rms.count)
    assert int(after.stats.return_tracker.count) > int(before.stats.return_tracker.count)  # episodes ended
    assert state.update_count == 2 * n_updates
    if task == "BimanualReacherSym":
        assert 0 < float(agent.env.symmetry_tracker(state.env_state).mean()) < 1


@pytest.mark.parametrize("algo", ["iart", "ippoteam"])
def test_value_norm_is_ignored(algo):
    runs = []
    for value_norm in (False, True):
        agent = get_algo(NAMES[algo])(make_config(algo, task="BimanualReacher", **SMALL, algo__value_norm=value_norm),
                                      device="cpu")
        s = agent.init(seed=1)
        ms = []
        for _ in range(2):
            s, m = agent.train_iter(s)
            ms.append(m)
        runs.append((s, ms))
    (s0, m0), (s1, m1) = runs
    assert state_diffs(s0, s1) == []
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)
    assert float(s1.value_rms.count) == float(s0.value_rms.count) < 1.0


@pytest.mark.parametrize("algo", ["iart", "ippoteam"])
def test_eval_hook_matches_jax(algo):
    jcfg, jagent, agent = _agents(algo, task="BimanualReacherSym", **SMALL)
    js = _copy(jagent.init(jax.random.PRNGKey(2)))
    state = agent.init()
    load_ppo_state(state, ma_state_from_jax(ma_tree(js)))
    obs = np.random.default_rng(5).normal(size=(E, 24)).astype(np.float32)
    want = jagent.eval_actor_apply(js.params, jnp.asarray(obs))
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), torch.from_numpy(obs))
    assert got.shape == (E, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("algo", sorted(NAMES))
def test_odd_num_envs_is_refused(algo):
    with pytest.raises(ValueError, match="even num_envs"):
        get_algo(NAMES[algo])(make_config(algo, task="BimanualReacher", **dict(SMALL, num_envs=15)), device="cpu")


@pytest.mark.parametrize("algo", sorted(NAMES))
def test_equivariant_act_class_is_refused(algo, monkeypatch):
    """An equivariant ``act_class`` needs the task's reps: on a task without
    an ``EquivarianceSpec`` the agent is refused (the equivariant team agents
    themselves: tests/test_torch_eq_streams.py)."""
    monkeypatch.setattr(BimanualReacher, "equivariance", None)
    cfg = make_config(algo, task="BimanualReacher", **SMALL, algo__act_class="DiagGaussianEquivariantMLPPolicy")
    with pytest.raises(ValueError, match="no EquivarianceSpec"):
        get_algo(NAMES[algo])(cfg, device="cpu").init()


@pytest.mark.parametrize("algo", sorted(NAMES))
def test_kill_and_resume_bitwise(tmp_path, algo):
    def build():
        cfg = make_config(algo, task="BimanualReacherSym", checkpoint_dir=str(tmp_path / "ckpt"), **SMALL)
        return get_algo(cfg.algo.name)(cfg, device="cpu"), cfg

    agent, _ = build()
    s, _ = agent.train_iter(agent.init(seed=0))
    checkpoint.save_checkpoint(str(tmp_path / "ckpt" / "state"), s)
    for _ in range(2):
        s, m = agent.train_iter(s)
    agent2, cfg2 = build()
    s2, resumed = checkpoint.maybe_resume_full_state(cfg2, agent2.init(seed=99))
    assert resumed
    for _ in range(2):
        s2, m2 = agent2.train_iter(s2)
    assert state_diffs(s, s2) == [] and all(torch.equal(m[k], m2[k]) for k in m)
    assert (s2.env_steps, s2.update_count) == (3 * H * E, 3 * 2 * (H * E // 2) // 32)


def test_entry_point_evaluates_checkpoints_and_resumes(tmp_path, capsys):
    """``train.main algo=iart``: 8 envs, horizon 4, eval every 4 iterations,
    a full checkpoint every 6, stopped after 14 iterations; rerun to 20 it
    resumes from iteration 12 and ends bitwise where one run of 20 ends."""
    size = dict(task="BimanualReacher", num_envs=8, algo__horizon_len=4, algo__batch_size=16, algo__update_times=2)
    per_iter = 4 * 8
    common = [f"{k.replace('__', '.')}={v}" for k, v in size.items()] + [
        "eval_num_envs=8", "algo.eval_freq=4", "algo.log_freq=2", "checkpoint_freq=6", "logging.console=false",
        f"logging.out_dir={tmp_path / 'runs'}"]
    train.main(["algo=iart", *common, f"max_step={13 * per_iter}", f"checkpoint_dir={tmp_path / 'ckpt'}",
                "logging.run_name=first", "--device=cpu"])
    recs = [json.loads(x) for x in open(tmp_path / "runs" / "first" / "metrics.jsonl")]
    assert [r["step"] // per_iter for r in recs if "eval/return" in r] == [4, 8, 12]  # no warm-up
    assert all(np.isfinite(r["eval/return"]) for r in recs if "eval/return" in r)
    best = checkpoint.load_model_snapshot(str(tmp_path / "runs" / "first" / "best_model"))
    assert {k.split(".")[0] for k in best["actor"]} == set(NETS["iart"])

    def run(name, ckpt):
        cfg = make_config("iart", eval_num_envs=8, checkpoint_dir=str(tmp_path / ckpt), checkpoint_freq=6,
                          max_step=19 * per_iter, logging__out_dir=str(tmp_path / "runs"), logging__run_name=name,
                          logging__console=False, **dict(size, algo__eval_freq=4, algo__log_freq=2))
        logger = RunLogger(cfg)
        try:
            return train.train_baseline(cfg, logger, device="cpu")[1]
        finally:
            logger.close()

    capsys.readouterr()
    resumed = run("second", "ckpt")
    assert f"at env step {12 * per_iter} (no warm-up)" in capsys.readouterr().out
    whole = run("whole", "ckpt_whole")
    assert state_diffs(resumed, whole) == [] and resumed.update_count == 20 * 2 * (4 * 8 // 2) // 16


def test_snapshot_from_jax_starts_the_port(tmp_path):
    """A JAX IPPOTeam best-model snapshot (``state.params`` and its critics)
    starts the port: the team actor's eval actions and the central critics'
    values within 1e-5."""
    jcfg, jagent, agent = _agents("ippoteam", task="BimanualReacher", **SMALL)
    js, _ = jagent.train_iter(jagent.init(jax.random.PRNGKey(0)))
    critics = {k: v for k, v in js.params.items() if k.startswith("critic")}
    jckpt.save_model_snapshot(str(tmp_path / "jax_snap"), js.params, critics, js.obs_rms)
    tree = jax.tree_util.tree_map(np.asarray, jckpt.load_model_snapshot(str(tmp_path / "jax_snap")))
    os.makedirs(tmp_path / "port_snap")
    torch.save(snapshot_from_jax(tree), tmp_path / "port_snap" / checkpoint.SNAPSHOT_FILE)
    state = agent.init(seed=3)
    state = checkpoint.restore_into_state(state, checkpoint.load_model_snapshot(str(tmp_path / "port_snap")),
                                          agent.snapshot_parts(state))
    obs = np.random.default_rng(0).normal(size=(E, 24)).astype(np.float32)
    obs_n = js.obs_rms.normalize(jnp.asarray(obs))
    want = jagent.eval_actor_apply(js.params, obs_n)
    with torch.no_grad():
        got = agent.eval_actor_apply(agent.eval_params(state), state.obs_rms.normalize(torch.from_numpy(obs)))
        for name in ("critic_tot", "critic_team"):
            v_got = state.nets[name](torch.from_numpy(np.array(obs_n)))
            v_want = jagent.critic_tot.apply(js.params[name], obs_n)
            np.testing.assert_allclose(v_got.numpy(), np.asarray(v_want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_two_agent_modules_import_no_jax():
    code = (
        "import sys\n"
        "import pql_tpu_torch.algos.iddpg, pql_tpu_torch.algos.qtot, pql_tpu_torch.algos.teams\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pql_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
