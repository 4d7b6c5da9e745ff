"""Checkpoints of the port, on the CPU.

- kill and resume: save the full state mid-run, build a fresh agent with
  another seed (as a restarted process would), resume, and the continuation
  is bitwise the uninterrupted one, every tensor of the state included
  (tests/test_utils.py:171-256 demands this of the JAX package); for PQL and
  PQL-D on PointMass and Cartpole, and PQL on Ant at 8 envs; and through
  the entry point, where the rerun resumes without warm-up;
- the weights-only snapshot round trip, the target net loaded from the
  critic;
- ``snapshot_from_jax``: a JAX ``save_model_snapshot`` (orbax), read back
  on the JAX side, converted and saved for the port, starts a port actor
  whose actions match the JAX actor's within 1e-5, from the raveled params
  the JAX PQL keeps and from flax trees.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import state_diffs
from pql_tpu.algos.pql import PQL as JPQL
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.parallel import make_mesh
from pql_tpu.utils import checkpoint as jckpt
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.train import train_pql
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.convert import snapshot_from_jax
from pql_tpu_torch.utils.logging import RunLogger

SMALL = dict(num_envs=8, algo__batch_size=32, algo__memory_size=1024, algo__warm_up=4, algo__iters_per_call=1,
             logging__mode="off")


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("algo,task", [("pql", "PointMass"), ("pql_d", "PointMass"), ("pql", "Cartpole"),
                                       ("pql_d", "Cartpole"), ("pql", "Ant")])
def test_kill_and_resume_bitwise(tmp_path, algo, task):
    def build():
        cfg = make_config(algo, task=task, checkpoint_dir=str(tmp_path / "ckpt"), **SMALL)
        return cfg, PQL(cfg, device="cpu")

    cfg, agent = build()
    s, _ = agent.warmup(agent.init(seed=0))
    s, _ = agent.train_iter(s)
    checkpoint.save_checkpoint(str(tmp_path / "ckpt" / "state"), s)
    for _ in range(2):  # the uninterrupted continuation, on its own generator's draws
        s, m = agent.train_iter(s)

    cfg2, agent2 = build()
    s2 = agent2.init(seed=99)  # "restarted process": fresh, other-seed state
    s2, resumed = checkpoint.maybe_resume_full_state(cfg2, s2)
    assert resumed
    for _ in range(2):
        s2, m2 = agent2.train_iter(s2)
    assert state_diffs(s, s2) == []
    assert all(torch.equal(m[k], m2[k]) for k in m)
    assert (s2.env_steps, s2.critic_update_count, s2.actor_update_count) == (7, 24, 12)


def test_no_checkpoint_means_no_resume(tmp_path):
    cfg = make_config("pql", task="PointMass", **SMALL)
    state = PQL(cfg, device="cpu").init()
    assert checkpoint.maybe_resume_full_state(cfg, state) == (state, False)
    cfg.checkpoint_dir = str(tmp_path / "empty")
    assert checkpoint.maybe_resume_full_state(cfg, state)[1] is False


def test_checkpoint_of_another_config_is_refused(tmp_path):
    agent = PQL(make_config("pql", task="PointMass", **SMALL), device="cpu")
    checkpoint.save_checkpoint(str(tmp_path / "state"), agent.init())
    other = PQL(make_config("pql", task="PointMass", **dict(SMALL, algo__memory_size=2048)), device="cpu")
    with pytest.raises(ValueError, match="replay ring"):
        checkpoint.load_checkpoint(str(tmp_path / "state"), other.init())


def test_snapshot_round_trip(tmp_path):
    cfg = make_config("pql_d", task="PointMass", **SMALL)
    agent = PQL(cfg, device="cpu")
    s1, _ = agent.warmup(agent.init(seed=0))
    s1, _ = agent.train_iter(s1)
    checkpoint.save_model_snapshot(str(tmp_path / "snap"), s1.actor, s1.critic, s1.obs_rms)
    assert os.listdir(tmp_path / "snap") == [checkpoint.SNAPSHOT_FILE]
    s2 = agent.init(seed=7)
    s2 = checkpoint.restore_into_state(s2, checkpoint.load_model_snapshot(str(tmp_path / "snap")))
    for name, src in (("actor", s1.actor), ("critic", s1.critic), ("critic_target", s1.critic)):
        for (k, a), b in zip(src.state_dict().items(), getattr(s2, name).state_dict().values()):
            assert torch.equal(a, b), f"{name}.{k}"
    for k in ("mean", "var", "count"):
        assert torch.equal(getattr(s1.obs_rms, k), getattr(s2.obs_rms, k))
    assert not s2.actor_opt.state  # weights only: the optimizers stay fresh


def test_wandb_artifact_path_needs_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError, match="needs the wandb package"):
        checkpoint.load_model_snapshot("wandb-artifact://entity/project/model:v0")


@pytest.mark.parametrize("raveled", [True, False], ids=["raveled", "flax_tree"])
def test_snapshot_from_jax_starts_the_port(tmp_path, raveled):
    jcfg = j_make_config("pql", task="PointMass", **SMALL)
    jagent = JPQL(jcfg, mesh=make_mesh(1))
    js, _ = jagent.warmup(jagent.init(jax.random.PRNGKey(0)))  # a non-trivial obs_rms
    actor_p, critic_p = js.actor_params, js.critic_params
    if not raveled:
        actor_p, critic_p = jagent._unravel_a(actor_p), jagent._unravel_c(critic_p)
    jckpt.save_model_snapshot(str(tmp_path / "jax_snap"), actor_p, critic_p, js.obs_rms)
    tree = jax.tree_util.tree_map(np.asarray, jckpt.load_model_snapshot(str(tmp_path / "jax_snap")))

    cfg = make_config("pql", task="PointMass", **SMALL)
    agent = PQL(cfg, device="cpu")
    state = agent.init(seed=3)
    snap = snapshot_from_jax(tree, state.actor, state.critic)
    os.makedirs(tmp_path / "port_snap")
    torch.save(snap, tmp_path / "port_snap" / checkpoint.SNAPSHOT_FILE)
    cfg.artifact = str(tmp_path / "port_snap")
    state = checkpoint.restore_into_state(state, checkpoint.load_model_snapshot(cfg.artifact))

    obs = np.random.default_rng(0).normal(size=(16, 6)).astype(np.float32)
    want = jagent.eval_actor_apply(js.actor_params, js.obs_rms.normalize(jnp.asarray(obs)))
    with torch.no_grad():
        got = PQL.eval_actor_apply(state.actor, state.obs_rms.normalize(torch.from_numpy(obs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    act = np.array(want)
    q_want = jagent.critic.apply(jagent._unravel_c(js.critic_params), jnp.asarray(obs), jnp.asarray(act))
    with torch.no_grad():
        q_got = state.critic_target(torch.from_numpy(obs), torch.from_numpy(act))
    for g, w in zip(q_got, q_want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=2e-5)


def test_snapshot_from_jax_raveled_needs_the_module():
    with pytest.raises(ValueError, match="raveled"):
        snapshot_from_jax({"actor": np.zeros(10, np.float32)})


def test_entry_point_resume_continues_bitwise(tmp_path, capsys):
    """train_pql with a checkpoint directory: stopped after 16 iterations
    (checkpoints at 8 and 16), rerun to 24 iterations, it resumes without a
    warm-up and ends bitwise where one run of 24 iterations ends; the run
    directory holds the best model."""

    def run(name, ckpt, max_step):
        cfg = make_config("pql", task="PointMass", eval_num_envs=8, checkpoint_dir=str(tmp_path / ckpt),
                          checkpoint_freq=8, max_step=max_step, logging__out_dir=str(tmp_path / "runs"),
                          logging__run_name=name, logging__console=False,
                          **dict(SMALL, logging__mode="local", algo__iters_per_call=4, algo__log_freq=4,
                                 algo__eval_freq=8))
        logger = RunLogger(cfg)
        try:
            return train_pql(cfg, logger, device="cpu")[1]
        finally:
            logger.close()

    warm, per_iter = 4 * 8, 8
    run("first", "ckpt", warm + 15 * per_iter)  # 16 iterations: 4 calls
    assert os.path.exists(tmp_path / "ckpt" / "state" / checkpoint.STATE_FILE)
    assert os.path.exists(tmp_path / "runs" / "first" / "best_model" / checkpoint.SNAPSHOT_FILE)
    capsys.readouterr()
    resumed = run("second", "ckpt", warm + 23 * per_iter)  # to 24 iterations
    assert "resumed the full state" in capsys.readouterr().out
    whole = run("whole", "ckpt_whole", warm + 23 * per_iter)
    assert state_diffs(resumed, whole) == []
    assert resumed.critic_update_count == 8 * 24
    steps = [json.loads(x)["step"] for x in (tmp_path / "runs" / "second" / "metrics.jsonl").read_text().splitlines()]
    assert min(steps) > warm + 16 * per_iter  # logs from the resumed step on
