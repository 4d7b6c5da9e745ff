"""Tests of the port that need a CUDA card (marker ``gpu``); they skip without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed. On the machine with the card:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: tests/conftest.py sets up the JAX CPU mesh.)
"""

import copy

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from chip_smoke import (
    BASELINE_ALGOS,
    C51_CASES,
    EQ_CLASSES,
    EQSD_REF,
    DDPG_THRESHOLD,
    FRANKA_MAX_FLIPS,
    HAND_MAX_FLIPS,
    HAND_TASKS,
    LEARNING_THRESHOLD,
    PHYS_MAX_FLIPS,
    RIGID_TASKS,
    c51_case,
    baseline_reference,
    c51_logit_scale,
    envs_beyond_tol,
    eq_layer_check,
    eq_reference,
    eqsd_reference,
    equivariance_errors,
    learning_gate_return,
    ppo_reference,
    sampler_check,
    state_diffs,
    step_tol,
    two_agent_reference,
    vision_module_check,
    vision_reference,
)
from pql_tpu_torch.algos import get_algo
from pql_tpu_torch.algos.base import set_precision
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.envs import make_eval_env, make_task
from pql_tpu_torch.envs.rigid import GraphedStep
from pql_tpu_torch.physics import dynamics as td
from pql_tpu_torch.ops import kernels
from pql_tpu_torch.ops.kernels import c51_td_target, c51_td_target_plain
from pql_tpu_torch.utils import checkpoint
from pql_tpu_torch.utils.evaluator import Evaluator

ATOL = 1e-5  # kernel vs plain version, fp32: i·Δz + v_min vs linspace support, FMA (chip_smoke.c51_logit_scale)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    set_precision(make_config("pql"))  # fp32: TF32 off for cuBLAS and cuDNN, as train.main sets it
    return torch.device("cuda")


def _inputs(B, A, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p1 = torch.softmax(2.0 * torch.randn(B, A, generator=gen, device=dev), -1)
    p2 = torch.softmax(2.0 * torch.randn(B, A, generator=gen, device=dev), -1)
    reward = 3.0 * torch.randn(B, 1, generator=gen, device=dev)
    done = (torch.rand(B, 1, generator=gen, device=dev) < 0.3).float()
    return p1, p2, reward, done


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8192, 300, 1])
def test_c51_kernel_matches_plain(cuda, B):
    p1, p2, rew, done = _inputs(B, 51, cuda, B)
    n0 = kernels.LAUNCHES["c51_td_target"]
    for q in (p2, None):
        got = c51_td_target(p1, q, rew, done, 0.99 ** 3, -10.0, 10.0)
        want = c51_td_target_plain(p1, q, rew, done, 0.99 ** 3, -10.0, 10.0)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= ATOL
    assert kernels.LAUNCHES["c51_td_target"] == n0 + 2
    mass = c51_td_target(p1, None, rew, done, 0.99, -10.0, 10.0).sum(-1)
    assert float((mass - 1.0).abs().max()) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", C51_CASES)
@pytest.mark.parametrize("A", [2, 21, 51, 101])
@pytest.mark.parametrize("B", [1, 300, 8192])
def test_c51_kernel_edge_cases(cuda, B, A, case):
    """Clipped rows at both ends, done rows (all sources share one pos),
    fractional done, integer pos at atoms 0, A//2 and A-1, gamma = 1; twin
    and single modes (cases: chip_smoke.c51_case)."""
    gen = torch.Generator(device=cuda).manual_seed(B * 1000 + A)
    p1, p2, rew, done, gamma = c51_case(case, B, A, cuda, gen)
    n0 = kernels.LAUNCHES["c51_td_target"]
    for q in (p2, None):
        got = c51_td_target(p1, q, rew, done, gamma, -10.0, 10.0)
        want = c51_td_target_plain(p1, q, rew, done, gamma, -10.0, 10.0)
        torch.cuda.synchronize()
        assert got.shape == (B, A)
        assert float((got - want).abs().max()) <= ATOL
    assert kernels.LAUNCHES["c51_td_target"] == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "done", "clip_low", "clip_high"])
def test_c51_kernel_long_rows_carry_runs_across_passes(cuda, case):
    """A = 512: a row is 74 lane chunks, so a warp walks it in three passes
    and runs carry from one pass to the next (a done row is one run of 512
    sources); a block needs 57,664 B of shared memory, above the 48 KB a
    launch gets without asking. At pos near 511 an fp32 ulp is 3e-5, more
    than the tolerance, so the support is 0..511 (dz = 1), gamma 0.5 and the
    rewards on a 0.5 grid: every pos is exact on both sides, and the kernel
    and its plain version differ only in the order of their sums."""
    A, B = 512, 300
    assert kernels._c51_lib().c51_td_target_smem_bytes(A) > 48 * 1024
    gen = torch.Generator(device=cuda).manual_seed(A)
    p1 = torch.softmax(torch.randn(B, A, generator=gen, device=cuda), -1)
    p2 = torch.softmax(torch.randn(B, A, generator=gen, device=cuda), -1)
    rew = 0.5 * torch.randint(-200, 1200, (B, 1), generator=gen, device=cuda).float()
    done = (torch.rand(B, 1, generator=gen, device=cuda) < 0.3).float()
    if case == "done":
        done = torch.ones_like(done)
    elif case == "clip_low":
        rew = torch.full_like(rew, -600.0)
    elif case == "clip_high":
        rew = torch.full_like(rew, 600.0)
    for q in (p2, None):
        got = c51_td_target(p1, q, rew, done, 0.5, 0.0, A - 1.0)
        want = c51_td_target_plain(p1, q, rew, done, 0.5, 0.0, A - 1.0)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["twin", "single"])
def test_c51_kernel_is_bitwise_deterministic(cuda, mode):
    p1, p2, rew, done = _inputs(8192, 51, cuda, 7)
    q = p2 if mode == "twin" else None
    first = c51_td_target(p1, q, rew, done, 0.99 ** 3, -10.0, 10.0)
    again = c51_td_target(p1, q, rew, done, 0.99 ** 3, -10.0, 10.0)
    assert torch.equal(first, again)


@pytest.mark.gpu
@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(
    B=st.integers(1, 3000), A=st.integers(2, 101), seed=st.integers(0, 2**31 - 1),
    reward_scale=st.floats(0.0, 30.0), done_p=st.floats(0.0, 1.0), frac_done=st.booleans(),
    gamma=st.floats(0.0, 1.0), twin=st.booleans(),
)
def test_c51_kernel_random_sweep(cuda, B, A, seed, reward_scale, done_p, frac_done, gamma, twin):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    s = c51_logit_scale(A)
    p1 = torch.softmax(s * torch.randn(B, A, generator=gen, device=cuda), -1)
    p2 = torch.softmax(s * torch.randn(B, A, generator=gen, device=cuda), -1) if twin else None
    rew = reward_scale * torch.randn(B, 1, generator=gen, device=cuda)
    done = torch.rand(B, 1, generator=gen, device=cuda)
    done = done if frac_done else (done < done_p).float()
    got = c51_td_target(p1, p2, rew, done, gamma, -10.0, 10.0)
    want = c51_td_target_plain(p1, p2, rew, done, gamma, -10.0, 10.0)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.gpu
def test_c51_kernel_rejects_strided_input(cuda):
    p1, p2, _, done = _inputs(64, 51, cuda, 0)
    strided = torch.zeros(64, 2, device=cuda)[:, :1]  # a column view, as the replay's reward field
    with pytest.raises(ValueError):
        c51_td_target(p1, p2, strided, done, 0.99, -10.0, 10.0)


@pytest.mark.gpu
def test_pql_d_iteration_on_card_matches_cpu(cuda):
    """One warm-up and two iterations at a small size on the card and the
    CPU, same initial state and draws. The card's path goes through the
    kernel (8 launches per iteration). fp32 sums run in other orders: the
    critic's parameter change must match to 1% of its norm, losses to 1e-3."""
    cfg = make_config("pql_d", num_envs=64, algo__batch_size=256, algo__memory_size=4096, algo__warm_up=8)
    agents = {d: PQL(cfg, device=d) for d in ("cpu", "cuda")}
    states = {d: a.init() for d, a in agents.items()}
    theta0 = torch.cat([p.detach().flatten() for p in states["cpu"].critic.parameters()])
    gen = torch.Generator().manual_seed(1)
    losses = {d: [] for d in agents}
    n0 = kernels.LAUNCHES["c51_td_target"]
    for it in range(3):
        draws = agents["cpu"].draw_iteration(gen, random=(it == 0))
        for d, agent in agents.items():
            step = agent.warmup if it == 0 else agent.train_iter
            states[d], m = step(states[d], {k: v.to(d) for k, v in draws.items()})
            losses[d].append(float(m["train/critic_loss"]))
    assert kernels.LAUNCHES["c51_td_target"] == n0 + 16
    flat = {d: torch.cat([p.detach().cpu().flatten() for p in s.critic.parameters()]) for d, s in states.items()}
    assert float((flat["cuda"] - flat["cpu"]).norm() / (flat["cpu"] - theta0).norm()) <= 1e-2
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-3 * max(abs(b), 1e-6)


def _task_state(name, E, steps, dev):
    """A task, its state after ``steps`` control steps on ``dev`` from seeded
    draws under uniform actions, the next action, and the next step's draw
    as a tuple (empty for a task without per-step draws)."""
    task = make_task(name)
    gen = torch.Generator().manual_seed(0)
    state = task.init_state(task.draw_reset(gen, E).to(dev))
    actions = (torch.rand(steps + 1, E, task.action_dim, generator=gen) * 2.0 - 1.0).to(dev)
    draws = [(task.draw_step(gen, E).to(dev),) if hasattr(task, "draw_step") else () for _ in range(steps + 1)]
    for t in range(steps):
        state, _, _, _ = task.dynamics(state, actions[t], *draws[t])
    return task, state, actions[steps], draws[steps]


def _fields(res):
    nxt, reward, terminated, info = res
    assert set(info) <= {"success"}
    return dict(nxt, reward=reward, terminated=terminated, **info)


@pytest.mark.gpu
@pytest.mark.parametrize("name", RIGID_TASKS + HAND_TASKS + ("FrankaCubeStack",))
def test_rigid_graphed_step_equals_eager_bitwise(cuda, name):
    """The captured control step and the same function run eagerly on the
    card: no reductions across envs, the same kernels in the same order. The
    outputs, info included, are clones: the next replay leaves them alone."""
    task, state, action, draw = _task_state(name, 512, 10, cuda)
    assert (512, action.device) in task._graphs
    graphed = _fields(task.dynamics(state, action, *draw))
    eager = _fields(task.control_step(state, action, *draw))
    assert set(graphed) == set(eager)
    for k in graphed:
        assert torch.equal(graphed[k], eager[k]), k
    before = {k: v.clone() for k, v in graphed.items()}
    task.dynamics({k: torch.zeros_like(v) for k, v in state.items()}, torch.zeros_like(action),
                  *(torch.zeros_like(x) for x in draw))
    for k in graphed:
        assert torch.equal(graphed[k], before[k]), k


@pytest.mark.gpu
def test_graphed_step_info_not_aliased_across_replays(cuda):
    """A graphed step's info values are clones: the second replay, on other
    inputs, leaves the first step's info as it was."""

    def fn(state, action, draw):
        return {"x": state["x"] + action}, action.sum(-1), action[:, 0] > 0, {"y": action * draw}

    a1, a2 = torch.rand(64, 3, device=cuda), torch.rand(64, 3, device=cuda)
    d1, d2 = torch.rand(64, 3, device=cuda), torch.rand(64, 3, device=cuda)
    graph = GraphedStep(fn, {"x": torch.zeros(64, 3, device=cuda)}, a1, d1)
    first = graph({"x": a2}, a1, d1)
    kept = {k: v.clone() for k, v in first[3].items()}
    second = graph({"x": a1}, a2, d2)
    assert torch.equal(first[3]["y"], kept["y"]) and torch.equal(first[3]["y"], a1 * d1)
    assert torch.equal(second[3]["y"], a2 * d2) and torch.equal(second[0]["x"], a1 + a2)
    assert set(graph.build_s) == {"warmup", "capture", "instantiate"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", RIGID_TASKS + HAND_TASKS + ("FrankaCubeStack",))
def test_rigid_card_matches_cpu(cuda, name):
    """One control step on the card (graphed) against the CPU, from a state
    rolled out on the card (tolerances and flips: chip_smoke.step_tol,
    PHYS_MAX_FLIPS of 4096 envs for the rigid tasks, HAND_MAX_FLIPS and
    FRANKA_MAX_FLIPS of 8192 for the hand and FrankaCubeStack)."""
    E = 1024
    task, state, action, draw = _task_state(name, E, 20, cuda)
    got = _fields(task.dynamics(state, action, *draw))
    want = _fields(task.control_step({k: v.cpu() for k, v in state.items()}, action.cpu(), *(x.cpu() for x in draw)))
    flips, _ = envs_beyond_tol(got, want, step_tol(task), E)
    allowed = {**{n: HAND_MAX_FLIPS for n in HAND_TASKS}, "FrankaCubeStack": FRANKA_MAX_FLIPS}.get(name)
    allowed = allowed * E // 8192 if allowed else PHYS_MAX_FLIPS * E // 4096
    assert len(flips) <= max(allowed, 1), flips


@pytest.mark.gpu
@pytest.mark.parametrize("palm", ["flat", "bowl"])
def test_hand_contact_groups_card_match_cpu(cuda, palm):
    """The hand's contact function of one substep (palm, cube and corner or
    bowl groups, summed) on the card against the CPU from the same state, a
    rollout's last: wrenches rtol 1e-5 with atol kp_max · 4 · 2⁻²³ · 3, new
    anchors rtol 1e-5 with atol 1e-6 · the largest (the CPU tests'
    tolerances, tests/test_torch_contact_hand.py); an env with a pair within
    rounding of a branch threshold may differ, at most 1 of 1024."""
    E = 1024
    task, state, _, _ = _task_state("AllegroHand", E, 20, cuda)
    task.palm = palm
    m = task.model

    def run(dev):
        st = {k: v.to(dev) for k, v in state.items()}
        q, qd, cs = (td._columns(st[k]) for k in ("q", "qd", "contact"))
        R, p, X, S = td._kin_s(m, q)
        f, cs_new = task._contact_fn(task._on(torch.device(dev)))(m, R, p, td._vel_s(m, X, S, qd), cs)
        col = lambda x: x.cpu() if isinstance(x, torch.Tensor) else torch.full((E,), x)  # noqa: E731
        return torch.stack([torch.stack([col(x) for x in row], -1) for row in f], 1), torch.stack(
            [col(x) for x in cs_new], -1)

    (gf, gcs), (cf, ccs) = run(cuda), run("cpu")
    c = task._on(torch.device("cpu"))
    kp_max = max(float(c.cube.pp.kp.max()), float(c.ground.pp.kp.max()), task._pp_corner.kp, task._pp_bowl.kp)
    off = ((gf - cf).abs() > 3 * kp_max * 4 * 2.0**-23 + 1e-5 * cf.abs()).reshape(E, -1).any(-1)
    off |= ((gcs - ccs).abs() > 1e-6 * float(ccs.abs().max()) + 1e-5 * ccs.abs()).any(-1)
    assert int(off.sum()) <= 1, off.nonzero().flatten().tolist()
    assert int((ccs[:, 3::4] > 0.5).sum()) > 0  # the state has engaged pairs


@pytest.mark.gpu
def test_ant_pql_iteration_on_card_matches_cpu(cuda):
    """Warm-up and two PQL iterations on Ant at a small size on the card and
    the CPU, same initial state and draws; the card's sim phase runs the
    graphed control step. As the PQL-D test above: the critic's parameter
    change must match to 1% of its norm, losses to 1e-3."""
    cfg = make_config("pql", task="Ant", num_envs=64, algo__batch_size=256, algo__memory_size=4096,
                      algo__warm_up=8)
    agents = {d: PQL(cfg, device=d) for d in ("cpu", "cuda")}
    states = {d: a.init() for d, a in agents.items()}
    theta0 = torch.cat([p.detach().flatten() for p in states["cpu"].critic.parameters()])
    gen = torch.Generator().manual_seed(1)
    losses = {d: [] for d in agents}
    for it in range(3):
        draws = agents["cpu"].draw_iteration(gen, random=(it == 0))
        for d, agent in agents.items():
            step = agent.warmup if it == 0 else agent.train_iter
            states[d], m = step(states[d], {k: v.to(d) for k, v in draws.items()})
            losses[d].append(float(m["train/critic_loss"]))
    assert len(agents["cuda"].env.task._graphs) == 1
    flat = {d: torch.cat([p.detach().cpu().flatten() for p in s.critic.parameters()]) for d, s in states.items()}
    assert float((flat["cuda"] - flat["cpu"]).norm() / (flat["cpu"] - theta0).norm()) <= 1e-2
    for a, b in zip(losses["cuda"][1:], losses["cpu"][1:]):
        assert abs(a - b) <= 1e-3 * max(abs(b), 1e-6)


@pytest.mark.gpu
def test_learning_gate_on_card(cuda):
    """The JAX package's Cartpole gate (tests/test_learning.py:32-59) on the
    card: PQL seed 0, eval return > 250 after 150 iterations."""
    assert learning_gate_return("pql", seed=0, device=cuda) > LEARNING_THRESHOLD


@pytest.mark.gpu
@pytest.mark.parametrize("algo,task,E", [("pql_d", "Cartpole", 256), ("pql", "Ant", 64)])
def test_kill_and_resume_bitwise_on_card(cuda, tmp_path, algo, task, E):
    """Save after one iteration, continue two; a fresh agent of another seed
    resumes and runs the same two: every tensor of the state bitwise equal,
    the generator's state included. Ant's control step replays its CUDA graph
    on the restored env state (new tensors, copied into the graph's inputs)."""
    cfg = make_config(algo, task=task, num_envs=E, algo__batch_size=256, algo__memory_size=4096, algo__warm_up=8)
    agent = PQL(cfg, device=cuda)
    s, _ = agent.warmup(agent.init(seed=0))
    s, _ = agent.train_iter(s)
    checkpoint.save_checkpoint(str(tmp_path / "state"), s)
    for _ in range(2):
        s, _ = agent.train_iter(s)
    agent2 = PQL(cfg, device=cuda)
    s2 = checkpoint.load_checkpoint(str(tmp_path / "state"), agent2.init(seed=7))
    for _ in range(2):
        s2, _ = agent2.train_iter(s2)
    assert state_diffs(s, s2) == []


@pytest.mark.gpu
def test_evaluator_card_matches_cpu(cuda):
    """PointMass, 32 eval envs, the same weights, normalizer and draws on the
    card and the CPU: eval/return and eval/episode_length within rtol 1e-5
    (fp32; the actor's products sum in another order)."""
    cfg = make_config("pql", task="PointMass", eval_num_envs=32)
    agent = PQL(cfg, device="cpu")
    state = agent.init(seed=0)
    state.obs_rms.update(torch.randn(64, agent.obs_dim, generator=torch.Generator().manual_seed(1)))
    ev_cpu = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply, "cpu")
    draws = ev_cpu.draw(torch.Generator().manual_seed(2))
    want = ev_cpu.eval_policy(state.actor, state.obs_rms, draws=draws)
    actor, rms = copy.deepcopy(state.actor).to(cuda), copy.deepcopy(state.obs_rms)
    for k in ("mean", "var", "count"):
        setattr(rms, k, getattr(rms, k).to(cuda))
    ev = Evaluator(cfg, make_eval_env(cfg), agent.eval_actor_apply, cuda)
    got = ev.eval_policy(actor, rms, draws={k: v.to(cuda) for k, v in draws.items()})
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


@pytest.mark.gpu
@pytest.mark.parametrize("algo", BASELINE_ALGOS)
@pytest.mark.parametrize("task", ["Cartpole", "Ant"])
def test_baselines_iterate_on_card(cuda, algo, task):
    """Warm-up and three iterations on the card: exact counters (8 updates
    and E env steps per iteration, one replay write per step), finite losses
    and episode statistics."""
    E = 256 if task == "Cartpole" else 64
    cfg = make_config(algo, task=task, num_envs=E, algo__batch_size=256, algo__memory_size=4096, algo__warm_up=8)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    s, _ = agent.warmup(agent.init(seed=0))
    for _ in range(3):
        s, m = agent.train_iter(s)
        assert all(bool(torch.isfinite(v)) for v in m.values()), m
    assert (s.update_count, s.env_steps, s.replay.total_writes) == (24, (8 + 3) * E, 8 + 3)
    assert s.replay.data.device.type == "cuda" and s.stats.return_tracker.ring.device.type == "cuda"


@pytest.mark.gpu
def test_baselines_on_card_match_cpu(cuda):
    """chip_smoke's baseline_reference: two iterations of DDPG, SAC and
    CrossQ on the card and the CPU from the same state and draws (it raises
    on a difference beyond its tolerances)."""
    out = baseline_reference(cuda)
    assert set(out["runs"]) == set(BASELINE_ALGOS)


@pytest.mark.gpu
@pytest.mark.parametrize("algo,task,E", [("ddpg", "Cartpole", 256), ("ddpg", "Ant", 64), ("sac", "Cartpole", 256),
                                         ("crossq", "Cartpole", 256)])
def test_baseline_kill_and_resume_bitwise_on_card(cuda, tmp_path, algo, task, E):
    """As the PQL case above, for the baselines' state."""
    cfg = make_config(algo, task=task, num_envs=E, algo__batch_size=256, algo__memory_size=4096, algo__warm_up=8)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    s, _ = agent.warmup(agent.init(seed=0))
    s, _ = agent.train_iter(s)
    checkpoint.save_checkpoint(str(tmp_path / "state"), s)
    for _ in range(2):
        s, _ = agent.train_iter(s)
    agent2 = get_algo(cfg.algo.name)(cfg, device=cuda)
    s2 = checkpoint.load_checkpoint(str(tmp_path / "state"), agent2.init(seed=7))
    for _ in range(2):
        s2, _ = agent2.train_iter(s2)
    assert state_diffs(s, s2) == []


@pytest.mark.gpu
def test_ddpg_learning_gate_on_card(cuda):
    """The JAX package's DDPG gate (tests/test_learning.py:62-84) on the
    card: seed 0, the best eval return at iterations 200, 225 and 250 > 400
    (``chip_smoke.DDPG_EVALS``)."""
    assert learning_gate_return("ddpg", seed=0, device=cuda) > DDPG_THRESHOLD


ON_POLICY = [("ppo", "Cartpole", {}), ("ppo", "Ant", dict(algo__value_norm=True)),
             ("ppo", "FrankaCubeStack", {}), ("ippo", "BimanualReacher", {}),
             ("ippo", "BimanualReacherSym", dict(algo__same_policy=True)), ("mappo", "BimanualReacher", {}),
             ("qtotv1", "BimanualReacher", dict(algo__value_norm=True)), ("qtotv2", "BimanualReacher", {}),
             ("iart", "BimanualReacher", {}), ("ippoteam", "BimanualReacherSym", {}),
             ("ippoteam2", "BimanualReacher", {})]


@pytest.mark.gpu
@pytest.mark.parametrize("algo,task,extra", ON_POLICY, ids=lambda x: x if isinstance(x, str) else "")
def test_onpolicy_iterates_on_card(cuda, algo, task, extra):
    """Three iterations on the card: epochs x minibatches updates and H x E
    env steps per iteration, finite losses and episode statistics, no warm-up."""
    E = 64
    cfg = make_config(algo, task=task, num_envs=E, algo__horizon_len=8, algo__batch_size=128, **extra)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    assert not hasattr(agent, "warmup")
    s = agent.init(seed=0)
    for _ in range(3):
        s, m = agent.train_iter(s)
        assert all(bool(torch.isfinite(v)) for v in m.values()), m
    assert (s.update_count, s.env_steps) == (3 * 4 * agent.rows // 128, 3 * 8 * E)
    assert s.obs.device.type == "cuda" and s.stats.return_tracker.ring.device.type == "cuda"


@pytest.mark.gpu
def test_onpolicy_on_card_matches_cpu(cuda):
    """chip_smoke's ppo_reference: two iterations of PPO, IPPO (both
    same_policy settings) and MAPPO on the card and the CPU from the same
    state and draws (it raises on a difference beyond its tolerances)."""
    assert len(ppo_reference(cuda)["runs"]) == 4


@pytest.mark.gpu
@pytest.mark.parametrize("algo,task,extra", ON_POLICY, ids=lambda x: x if isinstance(x, str) else "")
def test_onpolicy_kill_and_resume_bitwise_on_card(cuda, tmp_path, algo, task, extra):
    """As the PQL case above, for the on-policy states (the value
    normalizers, dones and IPPO's per-network optimizers included)."""
    cfg = make_config(algo, task=task, num_envs=64, algo__horizon_len=8, algo__batch_size=128, **extra)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    s, _ = agent.train_iter(agent.init(seed=0))
    checkpoint.save_checkpoint(str(tmp_path / "state"), s)
    for _ in range(2):
        s, _ = agent.train_iter(s)
    agent2 = get_algo(cfg.algo.name)(cfg, device=cuda)
    s2 = checkpoint.load_checkpoint(str(tmp_path / "state"), agent2.init(seed=7))
    for _ in range(2):
        s2, _ = agent2.train_iter(s2)
    assert state_diffs(s, s2) == []


@pytest.mark.gpu
def test_two_agent_tier_on_card_matches_cpu(cuda):
    """chip_smoke's two_agent_reference: IDDPG's warm-up and two iterations,
    and two iterations of QTOTV1, QTOTV2, IART, IPPOTeam and IPPOTeam2, on
    the card and the CPU from the same state and draws (it raises on a
    difference beyond its tolerances)."""
    assert len(two_agent_reference(cuda)["runs"]) == 6


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["BimanualReacher", "BimanualReacherSym"])
def test_iddpg_iterates_and_resumes_bitwise_on_card(cuda, tmp_path, task):
    """IDDPG on the card: 8 updates and E env steps per iteration, one replay
    write per step, two reward channels in the ring, finite losses; a
    checkpointed state resumed into a fresh agent continues bitwise."""
    E = 64
    cfg = make_config("iddpg", task=task, num_envs=E, algo__batch_size=256, algo__memory_size=4096, algo__warm_up=8)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    s, _ = agent.warmup(agent.init(seed=0))
    s, _ = agent.train_iter(s)
    checkpoint.save_checkpoint(str(tmp_path / "state"), s)
    for _ in range(2):
        s, m = agent.train_iter(s)
        assert all(bool(torch.isfinite(v)) for v in m.values()), m
    assert (s.update_count, s.env_steps, s.replay.total_writes) == (24, (8 + 3) * E, 8 + 3)
    assert s.replay.field("reward").shape[-1] == 2 and s.replay.data.device.type == "cuda"
    agent2 = get_algo(cfg.algo.name)(cfg, device=cuda)
    s2 = checkpoint.load_checkpoint(str(tmp_path / "state"), agent2.init(seed=7))
    for _ in range(2):
        s2, _ = agent2.train_iter(s2)
    assert state_diffs(s, s2) == []


EQ_AGENTS = [("eq", "BimanualReacher", {}), ("eqs", "BimanualReacher", {}), ("eqg", "BimanualReacher", {}),
             ("eqsc", "BimanualReacherSym", dict(algo__value_norm=True)), ("eqsdata", "BimanualReacher", {}),
             ("eqs4", "BimanualReacherSym", {}), ("mp", "BimanualReacher", {}),
             ("ippoteam", "BimanualReacher", EQ_CLASSES), ("iart", "BimanualReacherSym", EQ_CLASSES)]


@pytest.mark.gpu
def test_equivariant_layers_on_card_match_cpu(cuda):
    """chip_smoke's eq_layer_check: the EMLP layers at full width and
    GroupEMLP on C4 and D4, card vs CPU and equivariant on the card (it
    raises beyond 1e-5)."""
    assert len(eq_layer_check(cuda)) == 8


@pytest.mark.gpu
def test_eq_tier_on_card_matches_cpu(cuda):
    """chip_smoke's eq_reference: two iterations of the seven EQ agents and
    of IPPOTeam and IART with the equivariant classes, card vs CPU, then the
    trained networks' equivariance on the card."""
    assert len(eq_reference(cuda)["runs"]) == 9


@pytest.mark.gpu
@pytest.mark.parametrize("algo,task,extra", EQ_AGENTS, ids=lambda x: x if isinstance(x, str) else "")
def test_eq_agents_iterate_on_card(cuda, algo, task, extra):
    """Three iterations on the card at a small size (EMLP at full width):
    epochs x minibatches updates (EQSdata: twice the rows), finite losses,
    and every equivariant network still equivariant within 1e-5."""
    E = 64
    cfg = make_config(algo, task=task, num_envs=E, algo__horizon_len=8, algo__batch_size=128, **extra)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    s = agent.init(seed=0)
    for _ in range(3):
        s, m = agent.train_iter(s)
        assert all(bool(torch.isfinite(v)) for v in m.values()), m
    assert (s.update_count, s.env_steps) == (3 * 4 * agent.rows // 128, 3 * 8 * E)
    equivariance_errors(agent, s)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["eqsc", "eqs4", "eqsdata"])
def test_eq_kill_and_resume_bitwise_on_card(cuda, tmp_path, algo):
    cfg = make_config(algo, task="BimanualReacherSym", num_envs=64, algo__horizon_len=8, algo__batch_size=128)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    s, _ = agent.train_iter(agent.init(seed=0))
    checkpoint.save_checkpoint(str(tmp_path / "state"), s)
    for _ in range(2):
        s, _ = agent.train_iter(s)
    agent2 = get_algo(cfg.algo.name)(cfg, device=cuda)
    s2 = checkpoint.load_checkpoint(str(tmp_path / "state"), agent2.init(seed=7))
    for _ in range(2):
        s2, _ = agent2.train_iter(s2)
    assert state_diffs(s, s2) == []


def _variant_id(ref):
    algo, kwargs = ref
    return algo + ("-diffusion" if kwargs.get("algo__diffusion") else "") + (
        "-plain" if kwargs.get("algo__act_class") == "DiagGaussianMLPPolicy" else "")


@pytest.mark.gpu
def test_eqsd_tier_on_card_matches_cpu(cuda):
    """chip_smoke's eqsd_reference: two iterations of EQSD with each of its
    four team actors and of EQSD2 (equivariant and plain), card vs CPU, the
    trained networks' equivariance on the card (the diffusion team's
    ε-field and sampler among them), and both samplers at 4096 rows card vs
    CPU (it raises beyond its tolerances)."""
    out = eqsd_reference(cuda, "")
    assert len(out["runs"]) == 6 and len(out["sampler"]) == 2


@pytest.mark.gpu
def test_diffusion_samplers_on_card_match_cpu(cuda):
    """chip_smoke's sampler_check: both diffusion policies at full width,
    4096 rows, the same draws on the card and the CPU within 1e-5·(1 + |a|),
    and the equivariant one equivariant on the card."""
    out = sampler_check(cuda)
    assert all(r["card_vs_cpu_rel_err"] <= 1e-5 for r in out.values())


@pytest.mark.gpu
@pytest.mark.parametrize("ref", EQSD_REF, ids=[_variant_id(r) for r in EQSD_REF])
def test_eqsd_agents_iterate_on_card(cuda, ref):
    """Three iterations on the card at a small size (networks at full width):
    epochs x minibatches updates, finite losses, and every equivariant
    network, the diffusion team's ε-field and sampler among them, still
    equivariant within 1e-5."""
    algo, kwargs = ref
    cfg = make_config(algo, **kwargs)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    s = agent.init(seed=0)
    for _ in range(3):
        s, m = agent.train_iter(s)
        assert all(bool(torch.isfinite(v)) for v in m.values()), m
    assert (s.update_count, s.env_steps) == (3 * 2 * agent.rows // 128, 3 * 8 * cfg.num_envs)
    assert "train/actor_loss_team" in m
    equivariance_errors(agent, s)


@pytest.mark.gpu
@pytest.mark.parametrize("algo,extra", [("eqsd", dict(algo__diffusion=True)), ("eqsd2", {})],
                         ids=["eqsd-diffusion", "eqsd2"])
def test_eqsd_kill_and_resume_bitwise_on_card(cuda, tmp_path, algo, extra):
    """A checkpointed EQSD (diffusion team: its draws come from the state's
    generator) or EQSD2 state resumed into a fresh agent continues bitwise."""
    cfg = make_config(algo, task="BimanualReacherSym", num_envs=64, algo__horizon_len=8, algo__batch_size=128,
                      **extra)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    s, _ = agent.train_iter(agent.init(seed=0))
    checkpoint.save_checkpoint(str(tmp_path / "state"), s)
    for _ in range(2):
        s, _ = agent.train_iter(s)
    agent2 = get_algo(cfg.algo.name)(cfg, device=cuda)
    s2 = checkpoint.load_checkpoint(str(tmp_path / "state"), agent2.init(seed=7))
    for _ in range(2):
        s2, _ = agent2.train_iter(s2)
    assert state_diffs(s, s2) == []


@pytest.mark.gpu
def test_vision_modules_on_card_match_cpu(cuda):
    """chip_smoke's vision_module_check: every module of the vision tier and
    the vision tasks' views at 4096 envs, card vs CPU (it raises beyond its
    tolerances)."""
    out = vision_module_check(cuda)
    assert {"ResEncoder", "DINOEncoder", "DiagGaussianMLPVPolicy", "ReacherVision.render"} <= set(out)


@pytest.mark.gpu
def test_vision_tier_on_card_matches_cpu(cuda):
    """chip_smoke's vision_reference: the modules, two iterations of PPOV and
    IPPOV card vs CPU, and the DiffusionPolicy sampler at 4096 rows."""
    out = vision_reference(cuda, "")
    assert len(out["runs"]) == 2 and out["diffusion_policy_sampler"]["card_vs_cpu_rel_err"] <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("algo,task", [("ppov", "ReacherVision"), ("ippov", "BimanualReacherVision")])
def test_vision_agents_iterate_and_resume_bitwise_on_card(cuda, tmp_path, algo, task):
    """Three iterations at a small size (the ResNet encoder at full width):
    finite losses, epochs x minibatches updates; a checkpointed state resumed
    into a fresh agent continues bitwise."""
    cfg = make_config(algo, task=task, num_envs=64, algo__horizon_len=8, algo__batch_size=128)
    agent = get_algo(cfg.algo.name)(cfg, device=cuda)
    s, m = agent.train_iter(agent.init(seed=0))
    assert all(bool(torch.isfinite(v)) for v in m.values()), m
    checkpoint.save_checkpoint(str(tmp_path / "state"), s)
    for _ in range(2):
        s, _ = agent.train_iter(s)
    assert (s.update_count, s.env_steps) == (3 * 4 * 4, 3 * 8 * 64)
    agent2 = get_algo(cfg.algo.name)(cfg, device=cuda)
    s2 = checkpoint.load_checkpoint(str(tmp_path / "state"), agent2.init(seed=7))
    for _ in range(2):
        s2, _ = agent2.train_iter(s2)
    assert state_diffs(s, s2) == []
