"""The PQL learner's phases as CUDA graphs (``algos/base.py::PhaseGraphs``,
``algos/pql.py::PQL._learn``).

On the CPU a stand-in for the graph (``_CpuGraph``: the capture runs
nothing, each replay runs the captured phase and writes its loss into the
one buffer the capture returned, as a graph's replay does) takes the path a
card takes: the keys per phase and update count, the first call eager and
the second captured, the static inputs, the clones out, the graphs dropped
where a checkpoint load gives the optimizers new state, the kernels' launch
counts, AdamW's per-step scalars. The CPU and several ranks stay eager, and
DDPGV keeps the default AdamW.

Every PQL update but each optimizer's first steps through
``kernels.clip_adamw_step``, eager or graphed: on the CPU its plain
version, the default foreach step op for op but for its last op, an
addcmul where the default takes an addcdiv with a host scalar (on the card
the two round alike, bit for bit, the ``gpu`` tests). The CPU tests hold
the graphed run's numbers to ``CPU_TOL`` of the eager run's (a skipped or
doubled update moves them by ~1e-3) and its counts exactly. The ``gpu``
tests hold the real graphs, with the kernel pair, to forced-eager runs on
the card bit for bit.
This file imports nothing of JAX. On the machine with the card:

    python -m pytest tests/test_torch_learner_graph.py -m gpu --noconftest -q
"""

import pytest
import torch

from pql_tpu_torch.algos import base
from pql_tpu_torch.algos import pql as pql_module
from pql_tpu_torch.algos.ddpgv import DDPGV
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.ops import graphs, kernels
from pql_tpu_torch.parallel.mesh import Mesh
from pql_tpu_torch.utils import checkpoint, trace

KERNEL_NODES = 17  # what the stand-in reports as a graph's kernel nodes
CPU_TOL = 1e-5  # of each tensor's largest entry, and of each loss (measured: ≤ 1.5e-6 and 1.1e-7 over 7 iterations)


class _CpuGraph:
    """A captured phase on the CPU: ``replay`` runs it and writes its loss
    into ``out``, the buffer the capture returned."""

    def __init__(self, fn):
        self.fn, self.replays = fn, 0
        self.out = torch.full((), float("nan"))

    def replay(self):
        self.replays += 1
        self.out.copy_(self.fn())


@pytest.fixture
def cpu_graphs(monkeypatch):
    made = []

    def capture(fn, device, *spans):
        graph = _CpuGraph(fn)
        made.append(graph)
        return graph, graph.out, KERNEL_NODES

    monkeypatch.setattr(graphs, "capture_graph", capture)
    trace.reset()
    yield made
    trace.reset()


def _cfg(algo="pql", **kw):
    args = dict(task="Cartpole", num_envs=16, algo__batch_size=32, algo__memory_size=4096, algo__warm_up=4,
                algo__critic_sample_ratio=2, algo__critic_actor_ratio=2)
    return make_config(algo, **{**args, **kw})


def _agent(cfg, capture: bool, device="cpu", seed=0):
    agent = PQL(cfg, device=device)
    agent.capture_phases = capture
    state = agent.init(seed)
    state, _ = agent.warmup(state)
    return agent, state


def _tensors(state) -> dict:
    """Every tensor a phase moves: parameters, the target, both optimizers' state."""
    out = {}
    for name in ("actor", "critic", "critic_target"):
        out.update({f"{name}.{k}": v for k, v in getattr(state, name).named_parameters()})
    for name in ("actor_opt", "critic_opt"):
        opt = getattr(state, name)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            out.update({f"{name}.{i}.{k}": v for k, v in opt.state[p].items()})
    return out


def _assert_same(s1, s2, exact: bool):
    """The tensors of two states equal (``exact``) or within ``CPU_TOL``;
    the optimizers' step counts and the update counters equal."""
    t1, t2 = _tensors(s1), _tensors(s2)
    assert t1.keys() == t2.keys()
    far = []
    for k in t1:
        a, b = t1[k].detach().cpu(), t2[k].detach().cpu()
        if exact or k.endswith(".step"):
            far += [] if torch.equal(a, b) else [k]
        elif float((a - b).abs().max()) > CPU_TOL * float(a.abs().max()):
            far.append(k)
    assert far == []
    assert (s1.critic_update_count, s1.actor_update_count) == (s2.critic_update_count, s2.actor_update_count)


def _assert_losses(got, want, exact: bool):
    got, want = [float(v) for x in got for v in x], [float(v) for x in want for v in x]
    assert got == want if exact else got == pytest.approx(want, rel=CPU_TOL, abs=1e-9)


# the ratio schedule of a run: (critic_sample_ratio, critic_actor_ratio) before each iteration
SCHEDULE = [(2, 2)] * 3 + [(4, 2)] * 3 + [(2, 2)]


def _run(agent, state, schedule=SCHEDULE):
    losses = []
    for ratios in schedule:
        if ratios != (agent.cfg.algo.critic_sample_ratio, agent.cfg.algo.critic_actor_ratio):
            agent.set_ratios(*ratios)
        state, m = agent.train_iter(state)
        losses.append((m["train/critic_loss"], m["train/actor_loss"]))
    return state, losses


@pytest.mark.parametrize("algo,extra", [("pql", {}), ("pql_d", {}), ("pql", {"algo__prefetch_batches": True}),
                                        ("pql_d", {"algo__sample_slots": 4})])
def test_graphed_phases_equal_eager_across_set_ratios(cpu_graphs, algo, extra):
    """Graphed and eager runs from one seed: the same losses, parameters,
    targets and optimizer state over iterations across ``set_ratios(4, 2)``
    and back (to ``CPU_TOL``; the step counts exactly); a graph per phase
    and update count; each key's first call eager, its second captured, the
    rest replayed; every loss its own tensor (a clone of the graph's)."""
    cfg = _cfg(algo, **extra)
    eager, s_eager = _agent(cfg, capture=False)
    graphed, s_graphed = _agent(_cfg(algo, **extra), capture=True)
    trace.reset()
    s_eager, want = _run(eager, s_eager)
    s_graphed, got = _run(graphed, s_graphed)
    _assert_losses(got, want, exact=False)
    _assert_same(s_eager, s_graphed, exact=False)
    assert eager._graphs.graphs == {}
    assert set(graphed._graphs.graphs) == {("critic", 2), ("actor", 1), ("critic", 4), ("actor", 2)}
    assert all(g is not None for g in graphed._graphs.graphs.values())
    assert len(cpu_graphs) == 4 and sorted(g.replays for g in cpu_graphs) == [2, 2, 3, 3]
    iters = [r for r in trace.recent() if r.iteration >= 0][len(SCHEDULE):]  # the graphed run's
    captures = [r.counters.get("learner.graph_captures", 0) for r in iters]
    replays = [r.counters.get("learner.graph_replays", 0) for r in iters]
    assert captures == [0, 2, 0, 0, 2, 0, 0] and replays == [0, 2, 2, 0, 2, 2, 2]
    assert [r.counters.get("learner.graph_kernels", 0) for r in iters] == [KERNEL_NODES * n for n in replays]


def test_train_block_losses_are_not_aliased(cpu_graphs):
    """``iters_per_call`` iterations a block: the block's mean losses, and
    each iteration's, are the eager run's, not the last replay's buffer."""
    blocks = {}
    for capture in (False, True):
        agent, state = _agent(_cfg(algo__iters_per_call=3), capture=capture)
        out = []
        for _ in range(3):
            state, m = agent.train_block(state)
            out.append((m["train/critic_loss"], m["train/actor_loss"]))
        blocks[capture] = out
    assert len(cpu_graphs) == 2
    _assert_losses(blocks[True], blocks[False], exact=False)
    assert len({float(c) for c, _ in blocks[True]}) == 3


def test_checkpoint_load_drops_the_graphs_and_resumes_bitwise(cpu_graphs, tmp_path):
    """A graphed run saved after one iteration and continued; its state
    loaded back in place (new optimizer state) drops every graph, so each
    key runs eagerly once and is captured again, and the continuation
    repeats the first (to ``CPU_TOL``: its first iteration is eager where
    the first run's was graphed); a fresh agent of another seed resumed
    from the same file repeats the continuation bit for bit (the same
    eager and graphed updates in the same order)."""
    agent, state = _agent(_cfg(), capture=True)
    state, _ = agent.train_iter(state)
    checkpoint.save_checkpoint(str(tmp_path / "state"), state)
    state, want = _run(agent, state, [(2, 2)] * 3)
    want_state = {k: v.detach().clone() for k, v in _tensors(state).items()}
    captured = len(cpu_graphs)

    state = checkpoint.load_checkpoint(str(tmp_path / "state"), state)
    state, m = agent.train_iter(state)
    assert agent._graphs.graphs == {("critic", 2): None, ("actor", 1): None} and len(cpu_graphs) == captured
    state, rest = _run(agent, state, [(2, 2)] * 2)
    assert len(cpu_graphs) == captured + 2
    got = [(m["train/critic_loss"], m["train/actor_loss"])] + rest
    _assert_losses(got, want, exact=False)
    assert all(float((v.detach() - want_state[k]).abs().max()) <= CPU_TOL * float(v.detach().abs().max())
               for k, v in _tensors(state).items())

    fresh, s2 = _agent(_cfg(), capture=True, seed=7)
    s2 = checkpoint.load_checkpoint(str(tmp_path / "state"), s2)
    s2, again = _run(fresh, s2, [(2, 2)] * 3)
    _assert_losses(again, got, exact=True)
    _assert_same(s2, state, exact=True)


def test_another_state_drops_the_graphs(cpu_graphs):
    agent, state = _agent(_cfg(), capture=True)
    for _ in range(2):
        state, _ = agent.train_iter(state)
    assert all(g is not None for g in agent._graphs.graphs.values())
    other, _ = agent.warmup(agent.init(3))
    agent.train_iter(other)
    assert agent._graphs.graphs == {("critic", 2): None, ("actor", 1): None}
    assert agent._graphs.bound[0] is other.actor


def test_captured_launches_are_counted_at_each_replay(monkeypatch):
    """The capture runs a kernel's wrapper but not the kernel: its launch
    counts are taken back, and each replay makes them."""

    class _Graph:
        def replay(self):
            pass

    def capture(fn, device, *spans):  # the Python of the phase runs, as in a capture
        return _Graph(), fn(), KERNEL_NODES

    def phase(x):
        kernels.LAUNCHES["c51_td_target"] += 8  # eight launches of the projection
        for _ in range(8):  # eight clip and AdamW steps, two launches each, as the wrapper counts them
            kernels.LAUNCHES["clip_adamw_step"] += 2
            trace.count("learner.clip_adamw_steps", 2)
        return x.sum()

    monkeypatch.setattr(graphs, "capture_graph", capture)
    monkeypatch.setattr(kernels, "LAUNCHES", {**kernels.LAUNCHES, "c51_td_target": 5, "clip_adamw_step": 1})
    trace.reset()
    trace.iteration()
    graph = graphs.StaticGraph(phase, (torch.ones(3),), "learner", capture="setup.learner_capture")
    assert kernels.LAUNCHES["c51_td_target"] == 5 and kernels.LAUNCHES["clip_adamw_step"] == 1
    assert graph.launches == {"c51_td_target": 8, "clip_adamw_step": 16}
    assert "learner.clip_adamw_steps" not in trace.counters() and graph.counts == {"learner.clip_adamw_steps": 16}
    for _ in range(3):
        graph(torch.ones(3))
    assert kernels.LAUNCHES["c51_td_target"] == 5 + 3 * 8 and kernels.LAUNCHES["clip_adamw_step"] == 1 + 3 * 16
    assert trace.counters()["learner.clip_adamw_steps"] == 3 * 16
    trace.reset()
    with pytest.raises(ValueError, match="captured as"):
        graph(torch.ones(4))


def test_adamw_scalars_are_the_default_steps():
    """The host's step sizes and √(1 − β2^t) for the next steps, as
    ``torch.optim.AdamW`` works them out from its step count, in float32;
    a graph's steps advance the host counts; another form is refused."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = base.build_optimizer([p], 5e-4)
    for _ in range(5):
        p.grad = torch.full((3,), 0.5)
        opt.step()
    got = base.adamw_scalars(opt, 3, torch.device("cpu"))
    want = [[(5e-4 / (1 - 0.9 ** t)) * -1, (1 - 0.999 ** t) ** 0.5] for t in (6.0, 7.0, 8.0)]
    assert got.dtype == torch.float32 and torch.equal(got, torch.tensor(want, dtype=torch.float32))
    fused = torch.optim.AdamW([torch.nn.Parameter(torch.ones(3))], lr=5e-4, fused=False, capturable=True)
    with pytest.raises(ValueError, match="default foreach AdamW"):
        base.adamw_scalars(fused, 1, torch.device("cpu"))


def test_cpu_several_ranks_and_ddpgv_stay_eager(monkeypatch):
    """The capture is for one rank on a card: the CPU agent runs its phases
    eagerly and makes no graph, its optimizers the default AdamW; a card
    agent of two ranks does not capture; DDPGV keeps the default AdamW (and
    never calls ``kernels.clip_adamw_step``: test_torch_clip_adamw.py)."""
    agent, state = _agent(_cfg(), capture=False)
    assert PQL(_cfg(), device="cpu").capture_phases is False
    for _ in range(2):
        state, _ = agent.train_iter(state)
    assert agent._graphs.graphs == {}
    for opt in (state.actor_opt, state.critic_opt):
        group = opt.param_groups[0]
        assert (group["capturable"], group["fused"], group["foreach"]) == (False, None, None)
    assert PQL(_cfg(), device="cuda").capture_phases is True
    monkeypatch.setattr(pql_module, "make_mesh", lambda *a: Mesh(size=2, rank=0, axis_name="env"))
    assert PQL(_cfg(), device="cuda").capture_phases is False
    cfg = make_config("ddpgv", task="ReacherVision", num_envs=4, algo__batch_size=8, algo__memory_size=64,
                      algo__horizon_len=1, algo__update_times=1)
    ddpgv = DDPGV(cfg, device="cpu")
    s = ddpgv.init(0)
    for opt in (s.actor_opt, s.critic_opt):
        assert (opt.param_groups[0]["capturable"], opt.param_groups[0]["fused"]) == (False, None)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs are CUDA graphs")
    base.set_precision(make_config("pql"))
    return torch.device("cuda")


def _hand_cfg(algo):
    return make_config(algo, task="AllegroHand", num_envs=256, algo__batch_size=512,
                       algo__memory_size=256 * 32, algo__warm_up=4)


@pytest.mark.gpu
def test_adamw_graph_step_in_a_graph_equals_opt_step_on_card(cuda):
    """The critic's parameter shapes, 30 steps of random gradients over ten
    decades: the default AdamW's ``opt.step()`` against the plain version of
    ``kernels.clip_adamw_step`` (no clip) replayed from one CUDA graph with
    the host's scalars, bit for bit in the parameters and both moments (the
    kernel pair itself: test_torch_clip_adamw.py)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    shapes = [(512, 66), (512,), (256, 512), (256,), (128, 256), (128,), (1, 128), (1,)] * 2
    ref = [torch.nn.Parameter(torch.randn(s, generator=gen, device=cuda)) for s in shapes]
    mine = [torch.nn.Parameter(p.detach().clone()) for p in ref]
    opt_ref, opt = base.build_optimizer(ref, 5e-4), base.build_optimizer(mine, 5e-4)
    grads = [torch.zeros_like(p) for p in mine]
    adam = torch.zeros(2, device=cuda)
    for p, g in zip(mine, grads):  # the state a first eager step leaves
        p.grad = g.clone()
    opt.step()
    for p, g in zip(ref, grads):
        p.grad = g.clone()
    opt_ref.step()
    group = opt.param_groups[0]
    moments = [[opt.state[p][k] for p in mine] for k in ("exp_avg", "exp_avg_sq")]
    graph, _, _ = graphs.capture_graph(lambda: kernels.clip_adamw_step_plain(
        mine, grads, *moments, adam, None, group["lr"], group["betas"], group["eps"], group["weight_decay"]), cuda)
    for _ in range(30):
        scale = 10.0 ** torch.randint(-9, 1, (len(shapes),), generator=gen, device=cuda)
        new = [torch.randn(s, generator=gen, device=cuda) * scale[i] for i, s in enumerate(shapes)]
        for p, g in zip(ref, new):
            p.grad = g.clone()
        opt_ref.step()
        torch._foreach_copy_(grads, new)
        adam.copy_(base.adamw_scalars(opt, 1, cuda)[0])
        graph.replay()
        torch._foreach_add_([opt.state[p]["step"] for p in mine], 1.0)
        for a, b in zip(ref, mine):
            assert torch.equal(a, b)
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(opt_ref.state[a][k], opt.state[b][k])


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["pql", "pql_d"])
def test_graphed_hand_equals_forced_eager_on_card(cuda, algo):
    """PQL and PQL-D AllegroHand at 256 envs, batch 512: graphed against
    forced-eager over three iterations at 8:2, three after
    ``set_ratios(16, 2)`` and one back at 8:2; losses, parameters, targets
    and optimizer state bitwise; ``c51_td_target`` and ``clip_adamw_step``
    launches counted through the replays (the latter two an update, but
    each optimizer's first)."""
    runs = {}
    for capture in (False, True):
        kernels.reset_launches()
        agent, state = _agent(_hand_cfg(algo), capture=capture, device=cuda)
        schedule = [(8, 2)] * 3 + [(16, 2)] * 3 + [(8, 2)]
        state, losses = _run(agent, state, schedule)
        torch.cuda.synchronize()
        runs[capture] = (agent, state, [tuple(map(float, x)) for x in losses], kernels.LAUNCHES["c51_td_target"],
                         kernels.LAUNCHES["clip_adamw_step"])
    (eager, s_e, l_e, c51_e, tail_e), (graphed, s_g, l_g, c51_g, tail_g) = runs[False], runs[True]
    assert l_g == l_e
    _assert_same(s_e, s_g, exact=True)
    assert eager._graphs.graphs == {}
    assert set(graphed._graphs.graphs) == {("critic", 8), ("actor", 4), ("critic", 16), ("actor", 8)}
    assert all(g is not None and g.kernels > 0 for g in graphed._graphs.graphs.values())
    assert c51_g == c51_e == (8 * 4 + 16 * 3 if algo == "pql_d" else 0)
    updates = (8 * 4 + 16 * 3) + (4 * 4 + 8 * 3)  # critic, actor
    assert tail_g == tail_e == 2 * (updates - 2)


@pytest.mark.gpu
@pytest.mark.parametrize("algo,task", [("pql", "AllegroHand"), ("pql_d", "Cartpole")])
def test_resume_then_captured_iterations_equal_an_uninterrupted_run_on_card(cuda, tmp_path, algo, task):
    """Saved after two iterations (the graphs captured), continued four; a
    fresh agent of another seed resumes from the file and runs the same
    four (eager, captured, replayed, replayed): bitwise equal."""
    cfg = _hand_cfg(algo) if task == "AllegroHand" else _cfg(algo, num_envs=256, algo__batch_size=512)
    agent, state = _agent(cfg, capture=True, device=cuda)
    state, _ = _run(agent, state, [(8, 2)] * 2)
    checkpoint.save_checkpoint(str(tmp_path / "state"), state)
    state, want = _run(agent, state, [(8, 2)] * 4)
    fresh, s2 = _agent(cfg, capture=True, device=cuda, seed=7)
    s2 = checkpoint.load_checkpoint(str(tmp_path / "state"), s2)
    s2, got = _run(fresh, s2, [(8, 2)] * 4)
    _assert_losses(got, want, exact=True)
    _assert_same(s2, state, exact=True)
    assert torch.equal(s2.replay.data, state.replay.data) and torch.equal(s2.obs_rms.mean, state.obs_rms.mean)
