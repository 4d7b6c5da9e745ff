"""The port's BimanualReacher(Sym) obeys its ``EquivarianceSpec``, on the CPU
(as tests/test_equivariant.py:139-168 holds the JAX task).

- the spec and the rep generators the agents build from it
  (``MultiAgentCtx.obs_gen`` / ``act_gen`` / ``joint_obs_gen``) equal the
  JAX package's;
- for the C2 reflection across y = 0 (q ↦ −q, qd ↦ −qd, target ↦ target ·
  (1, −1)) on states reached by random steps: the obs transform by the
  joint generator, obs(g·s) = obs(s) @ G_obs, and the dynamics commute with
  it, dynamics(g·s, a @ G_act) = g·dynamics(s, a), with equal rewards, equal
  ``detailed_reward`` terms and equal success, to 1e-6.
"""

import numpy as np
import pytest
import torch

from pql_tpu.algos import ma_base as j_ma_base
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.envs import make_env as j_make_env
from pql_tpu_torch.algos import ma_base
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs import make_env
from pql_tpu_torch.models.emlp import concat_reps

E = 64
ATOL = 1e-6
TASKS = ["BimanualReacher", "BimanualReacherSym"]


def _mirror(state: dict) -> dict:
    return {"q": -state["q"], "qd": -state["qd"], "target": state["target"] * torch.tensor([1.0, -1.0]),
            "sym": state["sym"]}


def _t(g) -> torch.Tensor:
    return torch.tensor(np.asarray(g, np.float32))


@pytest.mark.parametrize("task", TASKS)
def test_spec_and_generators_match_jax(task):
    env = make_env(make_config("ippo", task=task, num_envs=4))
    jenv = j_make_env(j_make_config("ippo", task=task, num_envs=4))
    assert env.task.equivariance.obs_signs == tuple(map(tuple, jenv.task.equivariance.obs_signs))
    assert tuple(env.task.equivariance.act_signs) == tuple(jenv.task.equivariance.act_signs)
    ma, jma = ma_base.MultiAgentCtx(env), j_ma_base.MultiAgentCtx(jenv)
    assert ma.obs_gen(0) == jma.obs_gen(0) and ma.obs_gen(1) == jma.obs_gen(1)
    assert ma.act_gen() == jma.act_gen() and ma.joint_obs_gen() == jma.joint_obs_gen()


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dynamics_commute_with_the_reflection(task, seed):
    env = make_env(make_config("ippo", task=task, num_envs=E))
    t, ma = env.task, ma_base.MultiAgentCtx(env)
    g_obs, g_act = _t(ma.joint_obs_gen()), _t(concat_reps(ma.act_gen(), ma.act_gen()))
    gen = torch.Generator().manual_seed(seed)
    s = t.init_state(t.draw_reset(gen, E))
    for _ in range(5):  # off the rest state: velocities and tips away from the targets
        s = t.dynamics(s, torch.rand(E, 4, generator=gen) * 2 - 1)[0]
    gs = _mirror(s)
    torch.testing.assert_close(t.get_obs(gs), t.get_obs(s) @ g_obs, rtol=0, atol=ATOL)
    act = torch.rand(E, 4, generator=gen) * 3 - 1.5  # beyond the clip too
    ns, r, d, info = t.dynamics(s, act)
    ns_g, r_g, d_g, info_g = t.dynamics(gs, act @ g_act)
    torch.testing.assert_close(r_g, r, rtol=0, atol=ATOL)
    torch.testing.assert_close(d_g, d)
    for k, v in _mirror(ns).items():
        torch.testing.assert_close(ns_g[k], v, rtol=0, atol=ATOL, msg=k)
    for k, v in info["detailed_reward"].items():
        torch.testing.assert_close(info_g["detailed_reward"][k], v, rtol=0, atol=ATOL, msg=k)
    torch.testing.assert_close(info_g["success"], info["success"])
    torch.testing.assert_close(t.get_obs(ns_g), t.get_obs(ns) @ g_obs, rtol=0, atol=ATOL)
    assert float((t.get_obs(gs) - t.get_obs(s)).abs().max()) > 1e-2  # the reflection moves the obs
