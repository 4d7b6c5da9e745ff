"""The on-policy agents in the port's training loop and checkpoints, on the CPU.

- kill and resume: save the full state of PPO (with ``value_norm``), IPPO
  (both ``same_policy`` settings) and MAPPO mid-run, build a fresh agent
  with another seed, resume, and the continuation is bitwise the
  uninterrupted one in every tensor of the state (networks, optimizers, the
  obs and value normalizers, env state, dones, episode statistics,
  generator, counters);
- the entry point with PPO and with IPPO: ``train.main ... --device=cpu``
  runs no warm-up (the first record's env steps are log_freq iterations),
  evaluates at the predicted iterations, saves the best model (IPPO's actor
  all its networks) and the checkpoint; rerun, it resumes at the predicted
  iteration and ends bitwise where one uninterrupted run ends;
- weights-only snapshots: a JAX PPO or IPPO best-model snapshot (orbax,
  read back on the JAX side) starts the port's networks (eval actions
  within 1e-5), and the port's own round trip;
- no module of the port imports JAX, flax, optax or the JAX package.
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
from pql_tpu.algos import get_algo as j_get_algo
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.envs import make_env as j_make_env
from pql_tpu.utils import checkpoint as jckpt
from pql_tpu_torch import train
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.convert import snapshot_from_jax
from pql_tpu_torch.utils.logging import RunLogger

SMALL = dict(num_envs=8, algo__horizon_len=4, algo__batch_size=16, algo__update_times=2, logging__mode="off")
TASK = {"ppo": "PointMass", "ippo": "BimanualReacher", "mappo": "BimanualReacher"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("algo,extra", [("ppo", dict(algo__value_norm=True)), ("ippo", {}),
                                        ("ippo", dict(task="BimanualReacherSym", algo__same_policy=True)),
                                        ("mappo", dict(algo__value_norm=True))],
                         ids=["ppo", "ippo", "ippo-same_policy", "mappo"])
def test_kill_and_resume_bitwise(tmp_path, algo, extra):
    def build():
        kw = dict(dict(SMALL, task=TASK[algo]), **extra)
        cfg = make_config(algo, checkpoint_dir=str(tmp_path / "ckpt"), **kw)
        return cfg, get_algo(cfg.algo.name)(cfg, device="cpu")

    cfg, agent = build()
    s, _ = agent.train_iter(agent.init(seed=0))
    checkpoint.save_checkpoint(str(tmp_path / "ckpt" / "state"), s)
    for _ in range(2):  # the uninterrupted continuation, on its own generator's draws
        s, m = agent.train_iter(s)

    cfg2, agent2 = build()
    s2, resumed = checkpoint.maybe_resume_full_state(cfg2, agent2.init(seed=99))
    assert resumed
    for _ in range(2):
        s2, m2 = agent2.train_iter(s2)
    assert state_diffs(s, s2) == []
    assert all(torch.equal(m[k], m2[k]) for k in m)
    rows = (2 if algo == "mappo" else 1) * 4 * 8
    assert (s2.env_steps, s2.update_count) == (3 * 4 * 8, 3 * 2 * rows // 16)
    sd = checkpoint.state_dict(s2)
    assert "replay" not in sd and "dones" in sd and ("value_rms_left" in sd) == (algo == "ippo")


def test_checkpoint_of_another_algorithm_is_refused(tmp_path):
    ippo = get_algo("IPPO")(make_config("ippo", task="BimanualReacher", **SMALL), device="cpu")
    checkpoint.save_checkpoint(str(tmp_path / "state"), ippo.init())
    mappo = get_algo("MAPPO")(make_config("mappo", task="BimanualReacher", **SMALL), device="cpu")
    with pytest.raises(ValueError, match="checkpoint holds"):
        checkpoint.load_checkpoint(str(tmp_path / "state"), mappo.init())
    same = get_algo("IPPO")(make_config("ippo", task="BimanualReacher", algo__same_policy=True, **SMALL), device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        checkpoint.load_checkpoint(str(tmp_path / "state"), same.init())


def _records(path) -> list[dict]:
    return [json.loads(x) for x in open(path).read().splitlines()]


@pytest.mark.parametrize("algo", ["ppo", "ippo"])
def test_entry_point_evaluates_checkpoints_and_resumes(tmp_path, capsys, algo):
    """``train.main`` with 8 envs and horizon 4 (32 env steps an iteration),
    eval every 4 iterations, a full checkpoint every 6, stopped after 14
    iterations; rerun to 20 it resumes from iteration 12 and ends bitwise
    where one run of 20 iterations ends."""
    per_iter = 4 * 8
    size = dict(SMALL, task=TASK[algo])
    common = [f"{k.replace('__', '.')}={v}" for k, v in size.items() if k != "logging__mode"] + [
        "eval_num_envs=8", "algo.eval_freq=4", "algo.log_freq=2", "checkpoint_freq=6", "logging.console=false",
        f"logging.out_dir={tmp_path / 'runs'}"]
    train.main([f"algo={algo}", *common, f"max_step={13 * per_iter}", f"checkpoint_dir={tmp_path / 'ckpt'}",
                "logging.run_name=first", "--device=cpu"])
    recs = _records(tmp_path / "runs" / "first" / "metrics.jsonl")
    it_of = lambda step: step // per_iter  # noqa: E731  (no warm-up steps)
    assert [it_of(r["step"]) for r in recs if "eval/return" in r] == [4, 8, 12]
    assert [it_of(r["step"]) for r in recs if "speed/env_steps_per_s" in r] == [2, 4, 6, 8, 10, 12, 14]
    assert all(np.isfinite(r["eval/return"]) for r in recs if "eval/return" in r)
    best = checkpoint.load_model_snapshot(str(tmp_path / "runs" / "first" / "best_model"))
    if algo == "ippo":
        assert {k.split(".")[0] for k in best["actor"]} == {"actor", "critic", "actor_left", "critic_left"}
        assert {k.split(".")[0] for k in best["critic"]} == {"critic", "critic_left"}
    assert os.path.exists(tmp_path / "ckpt" / "state" / checkpoint.STATE_FILE)

    def run(name, ckpt):
        cfg = make_config(algo, eval_num_envs=8, checkpoint_dir=str(tmp_path / ckpt), checkpoint_freq=6,
                          max_step=19 * per_iter, logging__out_dir=str(tmp_path / "runs"), logging__run_name=name,
                          logging__console=False,
                          **dict(size, logging__mode="local", algo__eval_freq=4, algo__log_freq=2))
        logger = RunLogger(cfg)
        try:
            return train.train_baseline(cfg, logger, device="cpu")[1]
        finally:
            logger.close()

    capsys.readouterr()
    resumed = run("second", "ckpt")
    assert f"at env step {12 * per_iter} (no warm-up)" in capsys.readouterr().out
    whole = run("whole", "ckpt_whole")
    assert state_diffs(resumed, whole) == []
    rows = 4 * 8
    assert resumed.update_count == 20 * 2 * rows // 16 and resumed.env_steps == 20 * per_iter
    second = _records(tmp_path / "runs" / "second" / "metrics.jsonl")
    assert min(r["step"] for r in second) > 12 * per_iter  # logs from the resumed step on
    assert [it_of(r["step"]) for r in second if "eval/return" in r] == [16, 20]


@pytest.mark.parametrize("algo", ["ppo", "ippo"])
def test_snapshot_from_jax_starts_the_port(tmp_path, algo):
    """A JAX best-model snapshot as ``scripts/train.py::train_baseline`` saves
    it (PPO: the actor and critic trees; IPPO: ``state.params`` and its
    critics) starts the port: eval actions within 1e-5, and the values."""
    size = dict(SMALL, task=TASK[algo])
    jcfg = j_make_config(algo, **size)
    jagent = j_get_algo(jcfg.algo.name)(jcfg, j_make_env(jcfg))
    js, _ = jagent.train_iter(jagent.init(jax.random.PRNGKey(0)))  # a non-trivial obs_rms
    if algo == "ippo":
        actor, critic = js.params, {k: v for k, v in js.params.items() if k.startswith("critic")}
    else:
        actor, critic = js.actor_params, js.critic_params
    jckpt.save_model_snapshot(str(tmp_path / "jax_snap"), actor, critic, js.obs_rms)
    tree = jax.tree_util.tree_map(np.asarray, jckpt.load_model_snapshot(str(tmp_path / "jax_snap")))

    agent = get_algo(jcfg.algo.name)(make_config(algo, **size), device="cpu")
    os.makedirs(tmp_path / "port_snap")
    torch.save(snapshot_from_jax(tree), tmp_path / "port_snap" / checkpoint.SNAPSHOT_FILE)
    state = agent.init(seed=3)
    state = checkpoint.restore_into_state(state, checkpoint.load_model_snapshot(str(tmp_path / "port_snap")),
                                          agent.snapshot_parts(state))
    assert not (state.opts["actor"].state if algo == "ippo" else state.actor_opt.state)  # weights only

    obs = np.random.default_rng(0).normal(size=(16, agent.obs_dim)).astype(np.float32)
    obs_n = js.obs_rms.normalize(jnp.asarray(obs))
    want = jagent.eval_actor_apply(js.params if algo == "ippo" else js.actor_params, obs_n)
    actor_of = agent.eval_params(state)
    with torch.no_grad():
        got = agent.eval_actor_apply(actor_of, state.obs_rms.normalize(torch.from_numpy(obs)))
        if algo == "ippo":
            v_got = state.nets["critic_left"](torch.from_numpy(np.array(obs_n))[:, 12:])
            v_want = jagent.critic_left.apply(js.params["critic_left"], obs_n[:, 12:])
        else:
            v_got = state.critic(torch.from_numpy(np.array(obs_n)))
            v_want = jagent.critic.apply(js.critic_params, obs_n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_want), atol=1e-5, rtol=1e-5)

    # the port's own round trip
    checkpoint.save_model_snapshot(str(tmp_path / "own"), *agent.snapshot_parts(state), state.obs_rms)
    s2 = agent.init(seed=4)
    s2 = checkpoint.restore_into_state(s2, checkpoint.load_model_snapshot(str(tmp_path / "own")),
                                       agent.snapshot_parts(s2))
    for (k, a), b in zip(actor_of.state_dict().items(), agent.eval_params(s2).state_dict().values()):
        assert torch.equal(a, b), k


def test_on_policy_modules_import_no_jax():
    code = (
        "import sys\n"
        "import pql_tpu_torch.algos.ppo, pql_tpu_torch.algos.ippo, pql_tpu_torch.algos.mappo\n"
        "import pql_tpu_torch.algos.ma_base, pql_tpu_torch.utils.symmetry, pql_tpu_torch.envs.bimanual\n"
        "import pql_tpu_torch.envs.manip, pql_tpu_torch.envs.wrappers\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pql_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
