"""Ratios at run time and the replay sampling options, against the JAX package, on the CPU.

- ``set_ratios``: one PQL iteration after ``set_ratios(4, 2)`` matches the
  JAX package's one after its ``set_ratios(4, 2)``, from the same state with
  its draws (test_torch_pql's helpers and tolerances); counters follow
  tests/test_algos.py:67-87;
- ``sample_slots``: the port's window sample equals ``replay_sample(...,
  sample_slots=n)`` on the same ring and draws over field views, the
  iid fallback included (B % n != 0, B/n > E);
- ``prefetch_batches``: iterations with it are bitwise equal to iterations
  without it, from one state with one set of draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import copy_state, state_diffs
from pql_tpu.algos.pql import PQL as JPQL
from pql_tpu.cfg import make_config as j_make_config
from pql_tpu.parallel import make_mesh
from pql_tpu.replay import buffer as jbuf
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.replay import ReplayBuffer
from pql_tpu_torch.replay.buffer import window_fits
from pql_tpu_torch.utils.convert import load_pql_state, pql_state_from_jax
from test_torch_pql import SMALL, TOL, _assert_params, _copy, _jax_draws, _jax_tree


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_iteration_after_set_ratios_matches_jax():
    jcfg = j_make_config("pql", **SMALL)
    jagent = JPQL(jcfg, mesh=make_mesh(1))
    jstate = jagent.init(jax.random.PRNGKey(0))
    jstate, _ = jagent.warmup(jstate)
    jagent.set_ratios(4, 2)
    before = _copy(jstate)
    tree = _jax_tree(jagent, before)
    draws = _jax_draws(jagent, jcfg, jstate.rng)
    jstate, jmetrics = jagent.train_iter(jstate)
    after = _copy(jstate)

    agent = PQL(make_config("pql", **SMALL), device="cpu")
    state = agent.init()
    load_pql_state(state, pql_state_from_jax(tree, before.replay.layout))
    agent.set_ratios(4, 2)
    assert (agent.n_critic, agent.n_actor) == (jagent.n_critic, jagent.n_actor) == (4, 2)
    state, metrics = agent.train_iter(state, draws)
    for name in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(float(metrics[f"train/{name}"]), float(jmetrics[f"train/{name}"]),
                                   err_msg=name, **TOL)
    lr = jcfg.algo.actor_lr
    _assert_params(state.actor, jagent._unravel_a(after.actor_params), "actor", 2 * lr * 2)
    _assert_params(state.critic, jagent._unravel_c(after.critic_params), "critic", 2 * lr * 4)
    assert (state.critic_update_count, state.actor_update_count) == (
        int(after.critic_update_count), int(after.actor_update_count)) == (4, 2)


def test_set_ratios_and_training_continues():
    """tests/test_algos.py:67-87 on the port: 2 iterations at 8:4, then 2 at
    4:2; params move and stay finite."""
    agent = PQL(make_config("pql", **SMALL), device="cpu")
    state, _ = agent.warmup(agent.init(seed=0))
    for _ in range(2):
        state, _ = agent.train_iter(state)
    params_mid = [p.detach().clone() for p in state.actor.parameters()]
    agent.set_ratios(4, 2)
    assert (agent.cfg.algo.critic_sample_ratio, agent.cfg.algo.critic_actor_ratio) == (4, 2)
    for _ in range(2):
        state, metrics = agent.train_iter(state)
    assert state.critic_update_count == 2 * 8 + 2 * 4
    assert state.actor_update_count == 2 * 4 + 2 * 2
    assert any(not torch.equal(p, q) for p, q in zip(state.actor.parameters(), params_mid))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_draws_made_before_set_ratios_are_refused():
    agent = PQL(make_config("pql", **SMALL), device="cpu")
    state, _ = agent.warmup(agent.init(seed=0))
    stale = agent.draw_iteration(state.gen)
    agent.set_ratios(16, 2)
    with pytest.raises(ValueError, match="set_ratios"):
        agent.train_iter(state, stale)


@pytest.mark.parametrize("ratio,factor,max_ratio,rungs", [(8, 2, 32, [16, 32]), (2, 2, 32, [4, 8, 16, 32]),
                                                          (8, 3, 100, [24, 72]), (32, 2, 32, [])])
def test_precompile_ratio_ladder_returns_the_rungs(ratio, factor, max_ratio, rungs):
    agent = PQL(make_config("pql", **SMALL, algo__critic_sample_ratio=ratio), device="cpu")
    assert agent.precompile_ratio_ladder(None, factor=factor, max_ratio=max_ratio) == rungs
    assert agent.cfg.algo.critic_sample_ratio == ratio and agent.n_critic == ratio


# ----------------------------------------------------------------- sampling


@pytest.mark.parametrize("n", [4, 8, 3, 2])
def test_sample_slots_matches_jax(n):
    """B = 64, E = 16: n = 4 and 8 take the window (16 and 8 envs per slot);
    n = 3 (64 % 3 != 0) and n = 2 (32 envs > 16) fall back to iid pairs."""
    r = np.random.default_rng(n)
    slots, E, O, A, B = 6, 16, 4, 1, 64
    jr = jbuf.create_replay(slots, E, O, A, valid_start=2)
    tr = ReplayBuffer(slots, E, O, A, valid_start=2, device="cpu")
    dims = dict(obs=O, action=A, reward=1, next_obs=O, done=1)
    assert window_fits(n, B, E) == (n in (4, 8))
    for step in range(9):  # wraps the ring
        rows = {k: r.normal(size=(1, E, d)).astype(np.float32) for k, d in dims.items()}
        jr = jbuf.replay_add(jr, {k: jnp.asarray(v) for k, v in rows.items()})
        tr.add({k: torch.from_numpy(v) for k, v in rows.items()})
        key = jax.random.PRNGKey(100 + step)
        want = jbuf.replay_sample(jr, key, B, sample_slots=n)
        k_a, k_b = jax.random.split(key)
        if window_fits(n, B, E):
            raw = torch.from_numpy(np.array(jax.random.randint(k_a, (n,), 0, 1 << 30))).long()
            off = torch.from_numpy(np.array(jax.random.randint(k_b, (), 0, E))).long()
            index = tr.window_index(raw, off, B)
        else:
            raw = torch.from_numpy(np.array(jax.random.randint(k_a, (B,), 0, 1 << 30))).long()
            env = torch.from_numpy(np.array(jax.random.randint(k_b, (B,), 0, E))).long()
            index = tr.sample_index(raw, env)
        got = tr.split(tr.rows(index))
        for k in dims:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"{k} step {step}")


@pytest.mark.parametrize("algo,slots", [("pql_d", 0), ("pql", 0), ("pql_d", 4)])
def test_prefetch_batches_bitwise(algo, slots):
    """Two iterations from one state with one set of draws, with and without
    ``prefetch_batches``: every tensor of the states and the losses equal."""
    runs = {}
    base = PQL(make_config(algo, **SMALL, algo__sample_slots=slots), device="cpu")
    state0, _ = base.warmup(base.init(seed=1))
    gen = torch.Generator().manual_seed(2)
    draws = [base.draw_iteration(gen) for _ in range(2)]
    assert ("critic_win_slot" in draws[0]) == bool(slots)
    for prefetch in (False, True):
        agent = PQL(make_config(algo, **SMALL, algo__sample_slots=slots, algo__prefetch_batches=prefetch),
                    device="cpu")
        state = copy_state(state0, agent.init(seed=99))
        losses = []
        for d in draws:
            state, m = agent.train_iter(state, d)
            losses.append((m["train/critic_loss"], m["train/actor_loss"]))
        runs[prefetch] = (state, losses)
    assert state_diffs(runs[False][0], runs[True][0]) == []
    for a, b in zip(runs[False][1], runs[True][1]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_sample_slots_training_runs():
    agent = PQL(make_config("pql_d", **SMALL, algo__sample_slots=8), device="cpu")
    assert agent.sample_slots == 8
    state, _ = agent.warmup(agent.init(seed=3))
    for _ in range(3):
        state, m = agent.train_iter(state)
        assert torch.isfinite(m["train/critic_loss"]) and torch.isfinite(m["train/actor_loss"])
    assert (state.critic_update_count, state.actor_update_count) == (24, 12)
    d = agent.draw_iteration(state.gen)
    assert d["critic_win_slot"].shape == (8, 8) and d["critic_win_off"].shape == (8,)
    assert d["actor_win_slot"].shape == (4, 8) and "critic_slot" not in d
    assert PQL(make_config("pql_d", **SMALL, algo__sample_slots=3), device="cpu").sample_slots == 0
