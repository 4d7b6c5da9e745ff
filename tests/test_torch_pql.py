"""Whole-iteration parity: one PQL iteration of the port against the JAX package.

Cases: PQL-D and PQL on Cartpole, and PQL on Ant (E = 8, batch 32), whose
sim phase runs the ported rigid-body engine. A JAX ``PQL`` (fp32,
one-device mesh) is run through warm-up; its state is copied to numpy
before ``train_iter`` (which donates its input), and this iteration's
random draws are rebuilt from ``state.rng`` with the JAX package's own
functions: the key splits of ``_fused_step_local``, ``per_row_normal``,
``VecEnv.env_keys``, each task's ``init_state`` draws
(``test_torch_rigid.jax_reset_draws``) and the ``randint`` calls of
``replay_sample``. The port gets the state through ``pql_state_from_jax``
and runs one iteration with those draws.

Tolerance rtol 1e-4 / atol 1e-5: both sides run fp32, but matrix products
and reductions sum in another order, and 8 critic and 4 actor AdamW steps
carry those roundings into the parameters. Parameters get one stated
allowance for Adam's per-element normalisation (see ``_assert_params``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.algos.pql import PQL as JPQL
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.ops.noise import per_row_normal
from pql_tpu.parallel import make_mesh
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.utils.convert import load_pql_state, params_from_jax, pql_state_from_jax
from test_torch_rigid import jax_reset_draws, jax_step_draws

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(num_envs=16, algo__batch_size=64, algo__memory_size=4096, algo__warm_up=4, algo__iters_per_call=1)
SMALL_RIGID = dict(SMALL, num_envs=8, algo__batch_size=32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _adam(opt):
    """The ScaleByAdamState inside optax.chain(clip, adamw)'s state."""
    leaves = jax.tree_util.tree_leaves(opt, is_leaf=lambda x: hasattr(x, "mu"))
    return next(x for x in leaves if hasattr(x, "mu"))


def _jax_tree(agent, s) -> dict:
    """The numpy tree ``pql_state_from_jax`` takes, from a numpy PQLState."""
    un_a, un_c = agent._unravel_a, agent._unravel_c

    def opt(o, un):
        adam = _adam(o)
        return dict(mu=_copy(un(adam.mu)), nu=_copy(un(adam.nu)), count=int(adam.count))

    tracker = lambda t: dict(ring=t.ring, ptr=t.ptr, count=t.count)  # noqa: E731
    return dict(
        actor_params=_copy(un_a(s.actor_params)),
        critic_params=_copy(un_c(s.critic_params)),
        critic_target=_copy(un_c(s.critic_target)),
        actor_opt=opt(s.actor_opt, un_a),
        critic_opt=opt(s.critic_opt, un_c),
        obs_rms=dict(mean=s.obs_rms.mean, var=s.obs_rms.var, count=s.obs_rms.count),
        env_state=dict(state=dict(s.env_state.state), time=s.env_state.time),
        obs=s.obs,
        nstep=dict(obs=s.nstep.obs, action=s.nstep.action, reward=s.nstep.reward,
                   next_obs=s.nstep.next_obs, done=s.nstep.done, count=s.nstep.count),
        replay=dict(data=s.replay.data, ptr=s.replay.ptr, total_writes=s.replay.total_writes),
        cur_returns=s.cur_returns,
        cur_lengths=s.cur_lengths,
        return_tracker=tracker(s.return_tracker),
        len_tracker=tracker(s.len_tracker),
        success_tracker=tracker(s.success_tracker),
        env_steps=s.env_steps,
        critic_update_count=s.critic_update_count,
        actor_update_count=s.actor_update_count,
    )


def _jax_draws(agent, cfg, rng) -> dict:
    """This iteration's draws, rebuilt as _fused_step_local makes them
    (pql.py:372,391,533-536,596-597; one shard, so axis index 0), with the
    per-step draws of a task that draws in its dynamics
    (``VecEnv.step``'s ``fold_in(k_dyn, i)``, pql_tpu/envs/base.py:102-106)."""
    E, A, B = cfg.num_envs, agent.action_dim, cfg.algo.batch_size
    task = agent.env_local.task
    _, k_roll, k_crit, k_act = jax.random.split(rng, 4)
    explore, reset, step = [], [], []
    k = k_roll
    for _ in range(cfg.algo.horizon_len):
        k, _k_a, k_n, k_e = jax.random.split(k, 4)
        explore.append(per_row_normal(k_n, (E, A), jnp.float32, 0))
        k_dyn, k_reset = jax.random.split(k_e)
        reset.append(jax_reset_draws(task, agent.env_local.env_keys(k_reset, 0)))
        step.append(jax_step_draws(task, agent.env_local.env_keys(k_dyn, 0)))

    def sample_idx(k_s):
        k_slot, k_env = jax.random.split(k_s)
        return jax.random.randint(k_slot, (B,), 0, 1 << 30), jax.random.randint(k_env, (B,), 0, E)

    c_slot, c_env, t_normal = [], [], []
    for key in jax.random.split(k_crit, agent.n_critic * cfg.algo.horizon_len):
        k_s, k_t = jax.random.split(jax.random.fold_in(key, 0))
        slot, env = sample_idx(k_s)
        c_slot.append(slot)
        c_env.append(env)
        t_normal.append(jax.random.normal(k_t, (B, A), jnp.float32))
    a_slot, a_env = [], []
    for key in jax.random.split(k_act, agent.n_actor * cfg.algo.horizon_len):
        slot, env = sample_idx(jax.random.fold_in(key, 0))
        a_slot.append(slot)
        a_env.append(env)
    t = lambda xs, dtype=None: torch.from_numpy(np.array(jnp.stack(xs))).to(dtype)  # noqa: E731
    draws = dict(
        explore_normal=t(explore), reset=torch.stack(reset),
        critic_slot=t(c_slot, torch.int64), critic_env=t(c_env, torch.int64), target_normal=t(t_normal),
        actor_slot=t(a_slot, torch.int64), actor_env=t(a_env, torch.int64),
    )
    if step[0] is not None:  # the task draws in its dynamics
        draws["step"] = torch.stack(step)
    return draws


def _assert_close(got: dict, want: dict, what, max_step, noise: tuple = ()):
    """Elementwise rtol 1e-4 / atol 1e-5, with one allowance. Adam divides
    each gradient element by its own running RMS, so an element whose
    gradient is a near-cancelling sum over the batch (rounding noise in
    either framework) takes a step of arbitrary sign and size up to the
    learning rate. Such elements may differ by up to ``max_step`` (the sum
    of the AdamW steps taken), and must be fewer than 0.1% of the tensor. A
    tensor named in ``noise`` has a gradient that is zero but for rounding,
    so all of its elements step so: it is held to ``max_step`` alone."""
    assert set(got) == set(want), what
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        diff = np.abs(g - w)
        off = diff > TOL["atol"] + TOL["rtol"] * np.abs(w)
        if k not in noise:
            assert off.mean() <= 1e-3, f"{what}.{k}: {off.sum()} of {off.size} elements off"
        assert diff.max() <= max_step, f"{what}.{k}: max diff {diff.max()}"


def _assert_params(module, jax_nested, what, max_step):
    """``_assert_close`` of a port module against flax params."""
    _assert_close(module.state_dict(), params_from_jax(_copy(jax_nested)), what, max_step)


@pytest.mark.parametrize("algo,task,size", [
    pytest.param("pql_d", "Cartpole", SMALL, id="pql_d"),
    pytest.param("pql", "Cartpole", SMALL, id="pql"),
    pytest.param("pql", "Ant", SMALL_RIGID, id="pql-Ant"),
])
def test_one_iteration_matches_jax(algo, task, size):
    jcfg = j_make_config(algo, task=task, **size)
    jagent = JPQL(jcfg, mesh=make_mesh(1))
    jstate = jagent.init(jax.random.PRNGKey(0))
    jstate, _ = jagent.warmup(jstate)
    before = _copy(jstate)  # train_iter donates jstate
    tree = _jax_tree(jagent, before)
    draws = _jax_draws(jagent, jcfg, jstate.rng)
    jstate, jmetrics = jagent.train_iter(jstate)
    after = _copy(jstate)

    agent = PQL(make_config(algo, task=task, **size), device="cpu")
    state = agent.init()
    load_pql_state(state, pql_state_from_jax(tree, before.replay.layout))
    state, metrics = agent.train_iter(state, draws)

    for name in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(
            float(metrics[f"train/{name}"]), float(jmetrics[f"train/{name}"]), err_msg=name, **TOL
        )
    lr = jcfg.algo.actor_lr  # == critic_lr
    _assert_params(state.actor, jagent._unravel_a(after.actor_params), "actor", 2 * lr * jagent.n_actor)
    _assert_params(state.critic, jagent._unravel_c(after.critic_params), "critic", 2 * lr * jagent.n_critic)
    _assert_params(state.critic_target, jagent._unravel_c(after.critic_target), "critic_target",
                   2 * lr * jagent.n_critic)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(state.obs_rms, k).numpy(), getattr(after.obs_rms, k), **TOL)
    for name, s, d in after.replay.layout:
        np.testing.assert_allclose(
            state.replay.field(name).numpy(), after.replay.data[..., s : s + d], err_msg=name, **TOL
        )
    np.testing.assert_allclose(state.obs.numpy(), after.obs, **TOL)
    assert (state.replay.ptr, state.replay.total_writes) == (int(after.replay.ptr), int(after.replay.total_writes))
    assert (state.env_steps, state.critic_update_count, state.actor_update_count) == (
        int(after.env_steps), int(after.critic_update_count), int(after.actor_update_count)
    )
    assert (state.critic_update_count, state.actor_update_count) == (8, 4)  # one iteration after warm-up


def test_warmup_then_iterations_run_with_own_generator():
    """The port's own draws: counters 8:4 per iteration, per-env env_steps,
    finite losses, and the critic untouched by the actor phase."""
    agent = PQL(make_config("pql_d", **SMALL), device="cpu")
    state = agent.init(seed=3)
    state, _ = agent.warmup(state)
    assert state.env_steps == 4 and state.critic_update_count == 0
    for _ in range(3):
        state, m = agent.train_iter(state)
        assert torch.isfinite(m["train/critic_loss"]) and torch.isfinite(m["train/actor_loss"])
    assert (state.env_steps, state.critic_update_count, state.actor_update_count) == (7, 24, 12)
    params_before = [p.detach().clone() for p in state.critic.parameters()]
    grads_before = [p.grad.clone() for p in state.critic.parameters()]  # left by the critic phase
    agent._actor_phase(state, agent.draw_iteration(state.gen))
    for p, v, g in zip(state.critic.parameters(), params_before, grads_before):
        assert torch.equal(p.detach(), v) and torch.equal(p.grad, g)


@pytest.mark.parametrize("override", [dict(num_devices=2)])
def test_unported_options_fail_loudly(override):
    with pytest.raises(NotImplementedError):
        PQL(make_config("pql_d", **SMALL, **override), device="cpu")


def test_port_imports_no_jax():
    """A fresh interpreter importing the port (its entry point and its
    services, the physics engine, the rigid and the hand tasks) loads
    neither JAX, flax, optax nor the JAX package."""
    code = (
        "import sys, pql_tpu_torch, pql_tpu_torch.train, pql_tpu_torch.algos.pql, pql_tpu_torch.utils.convert\n"
        "import pql_tpu_torch.physics, pql_tpu_torch.physics.contact, pql_tpu_torch.envs.rigid\n"
        "import pql_tpu_torch.envs.hand, pql_tpu_torch.envs.classic\n"
        "import pql_tpu_torch.utils.evaluator, pql_tpu_torch.utils.checkpoint, pql_tpu_torch.utils.logging\n"
        "import pql_tpu_torch.utils.ratio_control\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pql_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
