"""The baselines' training loop and checkpoints in the port, on the CPU.

- kill and resume: save the full state of DDPG (with and without an actor
  target), SAC and CrossQ mid-run, build a fresh agent with another seed,
  resume, and the continuation is bitwise the uninterrupted one in every
  tensor of the state (SAC's ``log_alpha`` and its optimizer, CrossQ's
  BatchNorm statistics, the episode statistics and the generator included),
  as tests/test_utils.py:171-213 demands of the JAX package;
- the entry point, ``train.main algo=ddpg ... --device=cpu``: log records
  with ``speed/env_steps_per_s``, evals at the predicted iterations, the best
  model and the checkpoint; rerun, it resumes without a warm-up and ends
  bitwise where one uninterrupted run ends;
- weights-only snapshots: the port's round trip loads the targets too, and a
  JAX snapshot of DDPG, SAC or CrossQ (orbax, read back on the JAX side)
  starts the port's actor and critic (``snapshot_from_jax``);
- no module of the port imports JAX, flax, optax or the JAX package.
"""

import json
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pql_tpu_torch
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

SMALL = dict(task="PointMass", num_envs=8, algo__batch_size=32, algo__memory_size=2048, algo__warm_up=4,
             algo__update_times=2, logging__mode="off")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("algo,extra", [("ddpg", {}), ("ddpg", dict(algo__no_tgt_actor=False)), ("sac", {}),
                                        ("crossq", dict(info_track_keys=("success",)))],
                         ids=["ddpg", "ddpg-actor_target", "sac", "crossq"])
def test_kill_and_resume_bitwise(tmp_path, algo, extra):
    def build():
        cfg = make_config(algo, checkpoint_dir=str(tmp_path / "ckpt"), **SMALL, **extra)
        return cfg, get_algo(cfg.algo.name)(cfg, device="cpu")

    cfg, agent = build()
    s, _ = agent.warmup(agent.init(seed=0))
    s, _ = agent.train_iter(s)
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
    assert (s2.env_steps, s2.update_count) == ((4 + 3) * 8, 3 * 2)
    sd = checkpoint.state_dict(s2)
    assert ("log_alpha" in sd) == (algo == "sac") and ("actor_target" in sd) == ("algo__no_tgt_actor" in extra)
    assert ("critic_target" in sd) == (algo != "crossq")


def test_explore_then_update_is_train_iter():
    """The public halves of an iteration, on one draw dict, are ``train_iter``."""
    cfg = make_config("ddpg", **SMALL)
    a, b = (get_algo("DDPG")(cfg, device="cpu") for _ in range(2))
    (s1, _), (s2, _) = a.warmup(a.init(seed=0)), b.warmup(b.init(seed=0))
    draws = a.draw_iteration(torch.Generator().manual_seed(3))
    s1, m1 = a.train_iter(s1, draws)
    s2, m2 = b.update(b.explore(s2, draws), draws)
    assert state_diffs(s1, s2) == [] and all(torch.equal(m1[k], m2[k]) for k in m1)
    assert (s2.env_steps, s2.update_count) == ((4 + 1) * 8, 2)


def test_checkpoint_of_another_algorithm_is_refused(tmp_path):
    sac = get_algo("SAC")(make_config("sac", **SMALL), device="cpu")
    checkpoint.save_checkpoint(str(tmp_path / "state"), sac.init())
    ddpg = get_algo("DDPG")(make_config("ddpg", **SMALL), device="cpu")
    with pytest.raises(ValueError, match="checkpoint holds"):
        checkpoint.load_checkpoint(str(tmp_path / "state"), ddpg.init())


def _records(path) -> list[dict]:
    return [json.loads(x) for x in open(path).read().splitlines()]


def test_entry_point_evaluates_checkpoints_and_resumes(tmp_path, capsys):
    """``train.main`` with DDPG: 8 envs, eval every 4 iterations, a full
    checkpoint every 6, stopped past 14 iterations; rerun to 20 it resumes
    from iteration 12 without a warm-up and ends bitwise where one run of 20
    iterations ends."""
    warm, per_iter = 4 * 8, 8
    common = [f"{k.replace('__', '.')}={v}" for k, v in SMALL.items() if k != "logging__mode"] + [
        "eval_num_envs=8", "algo.eval_freq=4", "algo.log_freq=2", "checkpoint_freq=6", "logging.console=false",
        f"logging.out_dir={tmp_path / 'runs'}"]
    train.main(["algo=ddpg", *common, f"max_step={warm + 13 * per_iter}", f"checkpoint_dir={tmp_path / 'ckpt'}",
                "logging.run_name=first", "--device=cpu"])
    recs = _records(tmp_path / "runs" / "first" / "metrics.jsonl")
    it_of = lambda step: (step - warm) // per_iter  # noqa: E731
    assert [it_of(r["step"]) for r in recs if "eval/return" in r] == [4, 8, 12]
    assert [it_of(r["step"]) for r in recs if "speed/env_steps_per_s" in r] == [2, 4, 6, 8, 10, 12, 14]
    assert all(np.isfinite(r["eval/return"]) for r in recs if "eval/return" in r)
    assert os.path.exists(tmp_path / "runs" / "first" / "best_model" / checkpoint.SNAPSHOT_FILE)
    assert os.path.exists(tmp_path / "ckpt" / "state" / checkpoint.STATE_FILE)

    def run(name, ckpt):
        cfg = make_config("ddpg", eval_num_envs=8, checkpoint_dir=str(tmp_path / ckpt), checkpoint_freq=6,
                          max_step=warm + 19 * per_iter, logging__out_dir=str(tmp_path / "runs"),
                          logging__run_name=name, logging__console=False,
                          **dict(SMALL, logging__mode="local", algo__eval_freq=4, algo__log_freq=2))
        logger = RunLogger(cfg)
        try:
            return train.train_baseline(cfg, logger, device="cpu")[1]
        finally:
            logger.close()

    capsys.readouterr()
    resumed = run("second", "ckpt")
    assert f"at env step {warm + 12 * per_iter} (no warm-up)" in capsys.readouterr().out
    whole = run("whole", "ckpt_whole")
    assert state_diffs(resumed, whole) == []
    assert resumed.update_count == 2 * 20
    steps = [r["step"] for r in _records(tmp_path / "runs" / "second" / "metrics.jsonl")]
    assert min(steps) > warm + 12 * per_iter  # logs from the resumed step on


@pytest.mark.parametrize("algo", ["ddpg", "sac", "crossq"])
def test_snapshot_round_trip_loads_targets(tmp_path, algo):
    cfg = make_config(algo, **SMALL, algo__no_tgt_actor=False)
    agent = get_algo(cfg.algo.name)(cfg, device="cpu")
    s1, _ = agent.warmup(agent.init(seed=0))
    s1, _ = agent.train_iter(s1)
    checkpoint.save_model_snapshot(str(tmp_path / "snap"), s1.actor, s1.critic, s1.obs_rms)
    s2 = checkpoint.restore_into_state(agent.init(seed=7), checkpoint.load_model_snapshot(str(tmp_path / "snap")))
    pairs = [(s1.actor, s2.actor), (s1.actor, s2.actor_target), (s1.critic, s2.critic)]
    if s2.critic_target is not None:
        pairs.append((s1.critic, s2.critic_target))
    for src, dst in pairs:
        for (k, a), b in zip(src.state_dict().items(), dst.state_dict().values()):
            assert torch.equal(a, b), k
    assert not s2.actor_opt.state  # weights only: the optimizers stay fresh


@pytest.mark.parametrize("algo", ["ddpg", "sac", "crossq"])
def test_snapshot_from_jax_starts_the_port(tmp_path, algo):
    """A JAX best-model snapshot (flax trees; CrossQ's critic without its
    BatchNorm statistics, which stay the port's fresh ones as they stay the
    JAX state's) starts the port: eval actions within 1e-5, and the critic's
    Q values."""
    jcfg = j_make_config(algo, **SMALL)
    jagent = j_get_algo(jcfg.algo.name)(jcfg, j_make_env(jcfg))
    js, _ = jagent.warmup(jagent.init(jax.random.PRNGKey(0)))  # a non-trivial obs_rms
    jckpt.save_model_snapshot(str(tmp_path / "jax_snap"), js.actor_params, js.critic_params, js.obs_rms)
    tree = jax.tree_util.tree_map(np.asarray, jckpt.load_model_snapshot(str(tmp_path / "jax_snap")))

    agent = get_algo(jcfg.algo.name)(make_config(algo, **SMALL), device="cpu")
    os.makedirs(tmp_path / "port_snap")
    torch.save(snapshot_from_jax(tree), tmp_path / "port_snap" / checkpoint.SNAPSHOT_FILE)
    state = checkpoint.restore_into_state(agent.init(seed=3), checkpoint.load_model_snapshot(str(tmp_path / "port_snap")))

    obs = np.random.default_rng(0).normal(size=(16, 6)).astype(np.float32)
    want = jagent.eval_actor_apply(js.actor_params, js.obs_rms.normalize(jnp.asarray(obs)))
    with torch.no_grad():
        got = agent.eval_actor_apply(state.actor, state.obs_rms.normalize(torch.from_numpy(obs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    variables = js.critic_params if algo != "crossq" else {**js.critic_params, "batch_stats": js.batch_stats}
    q_want = jagent.critic.apply(variables, jnp.asarray(obs), jnp.asarray(np.array(want)))
    critics = [state.critic] + ([state.critic_target] if state.critic_target is not None else [])
    for critic in critics:
        with torch.no_grad():
            q_got = critic(torch.from_numpy(obs), got)
        for g, w in zip(q_got, q_want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-5)


def test_port_modules_import_no_jax():
    """Every module of the port, imported in a fresh interpreter, loads
    neither JAX, flax, optax nor the JAX package."""
    names = [m.name for m in pkgutil.walk_packages(pql_tpu_torch.__path__, "pql_tpu_torch.")]
    assert {"pql_tpu_torch.algos.ddpg", "pql_tpu_torch.algos.sac", "pql_tpu_torch.algos.crossq",
            "pql_tpu_torch.models.distributions", "pql_tpu_torch.train"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pql_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
