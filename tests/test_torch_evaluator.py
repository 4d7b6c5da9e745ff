"""The port's Evaluator against the JAX package's, on the CPU.

On Cartpole and PointMass (E = 8 eval envs), the same actor weights (a flax
``TanhMLPPolicy`` converted with ``params_from_jax``) and the same obs
normalizer go through the JAX ``Evaluator`` from a key and through the
port's from that key's draws, rebuilt as the JAX rollout makes them: the
first reset from ``env_keys(split(rng)[1])``, then per step ``k_reset`` of
``split(split(rng, T)[t])`` (pql_tpu/utils/evaluator.py:37-66,
pql_tpu/envs/base.py:102-113). Cartpole's episode limit is cut to 100 steps
on both sides, so that the random policy's falls and a truncation both land
in the rollout without the pole's chaos carrying roundings for 500 steps.

Tolerance: ``eval/return`` and ``eval/episode_length`` within rtol 1e-5
(fp32, matrix products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.envs import make_eval_env as j_make_eval_env
from pql_tpu.models import mlp as jmlp
from pql_tpu.ops.running_norm import RunningMeanStd as JRunningMeanStd
from pql_tpu.utils.evaluator import Evaluator as JEvaluator
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs import make_eval_env
from pql_tpu_torch.models import mlp as tmlp
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.utils.convert import params_from_jax
from pql_tpu_torch.utils.evaluator import Evaluator
from test_torch_rigid import jax_reset_draws

E = 8
MAX_LEN = {"Cartpole": 100, "PointMass": 100}


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_eval_draws(jenv, rng) -> dict[str, torch.Tensor]:
    """The port's ``Evaluator.draw`` layout holding the JAX rollout's draws."""
    task, T = jenv.task, jenv.max_episode_length
    rng, k_reset = jax.random.split(rng)
    init = jax_reset_draws(task, jenv.env_keys(k_reset))
    step_keys = jax.random.split(rng, T)
    reset_keys = jax.vmap(lambda k: jenv.env_keys(jax.random.split(k)[1]))(step_keys)  # [T, E]
    reset = jax_reset_draws(task, reset_keys.reshape(T * jenv.num_envs, -1))
    return {"init": init, "reset": reset.reshape(T, jenv.num_envs, -1)}


def _setup(task: str, seed: int = 0):
    jcfg = j_make_config("pql", task=task, eval_num_envs=E)
    jenv = j_make_eval_env(jcfg)
    jenv.max_episode_length = MAX_LEN[task]
    O, A = jenv.obs_dim, jenv.action_dim
    r = np.random.default_rng(seed)
    jactor = jmlp.TanhMLPPolicy(act_dim=A)
    params = jactor.init(jax.random.PRNGKey(seed), jnp.zeros((1, O)))
    jrms = JRunningMeanStd.create((O,)).update(jnp.asarray(r.normal(0.1, 0.5, size=(64, O)).astype(np.float32)))

    cfg = make_config("pql", task=task, eval_num_envs=E)
    env = make_eval_env(cfg)
    env.max_episode_length = MAX_LEN[task]
    actor = tmlp.TanhMLPPolicy(O, A)
    actor.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rms = RunningMeanStd((O,), device="cpu")
    for k in ("mean", "var", "count"):
        getattr(rms, k).copy_(torch.from_numpy(np.array(getattr(jrms, k))))
    jev = JEvaluator(jcfg, jenv, lambda p, o: jactor.apply(p, o))
    ev = Evaluator(cfg, env, PQL.eval_actor_apply, "cpu")
    return jev, (params, jrms), ev, (actor, rms), jenv


@pytest.mark.parametrize("task", ["Cartpole", "PointMass"])
def test_evaluator_matches_jax(task):
    jev, (params, jrms), ev, (actor, rms), jenv = _setup(task)
    rng = jax.random.PRNGKey(5)
    want = jev.eval_policy(params, jrms, rng)
    got = ev.eval_policy(actor, rms, draws=jax_eval_draws(jenv, rng))
    assert set(got) == set(want) == {"eval/return", "eval/episode_length"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    if task == "Cartpole":  # the random policy falls before the cut limit
        assert got["eval/episode_length"] < MAX_LEN[task]


def test_async_then_resolve_gives_eval_policy_floats():
    _, _, ev, (actor, rms), _ = _setup("Cartpole", seed=1)
    draws = ev.draw(torch.Generator().manual_seed(0))
    handle = ev.eval_policy_async(actor, rms, draws=draws)
    assert all(isinstance(v, torch.Tensor) for v in handle.values())
    assert Evaluator.resolve(handle) == ev.eval_policy(actor, rms, draws=draws)
    # drawn from a generator: the same seed gives the same floats
    a = ev.eval_policy(actor, rms, torch.Generator().manual_seed(3))
    b = ev.eval_policy(actor, rms, torch.Generator().manual_seed(3))
    assert a == b


def test_draw_layout():
    _, _, ev, _, _ = _setup("PointMass")
    d = ev.draw(torch.Generator().manual_seed(0))
    assert set(d) == {"init", "reset"}
    assert d["init"].shape == (E, 4) and d["reset"].shape == (MAX_LEN["PointMass"], E, 4)


@pytest.mark.parametrize("max_step,step,stop", [(100, 100, False), (100, 101, True), (100, None, False)])
def test_check_if_should_stop_on_steps(max_step, step, stop):
    cfg = make_config("pql", max_step=max_step)
    assert Evaluator(cfg, make_eval_env(cfg), PQL.eval_actor_apply, "cpu").check_if_should_stop(step) is stop


def test_check_if_should_stop_on_time():
    cfg = make_config("pql", max_time=0.0)
    ev = Evaluator(cfg, make_eval_env(cfg), PQL.eval_actor_apply, "cpu")
    ev.start_time -= 1.0
    assert ev.check_if_should_stop(0)
