"""PQL's optimizer tail as one kernel pair (``ops/kernels.py::clip_adamw_step``,
``csrc/clip_adamw.cu``).

On the CPU the wrapper computes its plain version: ``clip_by_global_norm``
(the gradients left as they are) then the default foreach AdamW step with
its two per-step scalars read from a tensor. It is held bit for bit to the
clip in place (``base.clip_by_global_norm_``) followed by that foreach step
written out here, with clipping on, off and absent; to ``opt.step()`` within
``CPU_STEP_ULPS``; and it refuses what the kernel does not take. PQL steps
every update but each optimizer's first through it, and no other agent does.

On the card (``gpu`` tests) the kernel pair is held to the plain version at
the critic's and the actor's shapes: bit for bit with the norm under the
max; with clipping on, bit for bit once the plain clip takes the kernel's
norm, and that norm within ``NORM_RTOL`` of the plain one. This file imports
nothing of JAX. On the machine with the card:

    python -m pytest tests/test_torch_clip_adamw.py -m gpu --noconftest -q
"""

import pytest
import torch

from pql_tpu_torch.algos import base
from pql_tpu_torch.algos.ddpgv import DDPGV
from pql_tpu_torch.algos.pql import PQL
from pql_tpu_torch.cfg import make_config
from pql_tpu_torch.ops import kernels
from pql_tpu_torch.utils import trace

LR, BETAS, EPS, WD, MAX_NORM = 5e-4, (0.9, 0.999), 1e-8, 0.01, 0.5
# the critic's and the actor's parameter shapes on AllegroHand (400,386 and 193,936 elements)
CRITIC = [(512, 69), (512,), (256, 512), (256,), (128, 256), (128,), (1, 128), (1,)] * 2
ACTOR = [(512, 53), (512,), (256, 512), (256,), (128, 256), (128,), (16, 128), (16,)]
SMALL = [(5, 3), (5,), (2, 5), (1,)]
# On the CPU ``opt.step()`` rounds its last op as p + (s·m)/d where the foreach step on the card
# rounds p + s·(m/d): an ulp of p a step at most, so k steps stay within k ulps of max |p|.
CPU_STEP_ULPS = 1
# Two fp32 summation orders over 4e5 squares (the kernel's per-block sums, PyTorch's tree reductions):
# each sum is within ~1e-7 of the exact one at this size, its square root within half that.
NORM_RTOL = 1e-6


def _state(shapes, gen, device="cpu", grad_scale=1.0):
    """(params, grads, exp_avgs, exp_avg_sqs) as an AdamW some steps in holds them."""
    randn = lambda s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    params = [randn(s) for s in shapes]
    grads = [randn(s) * grad_scale for s in shapes]
    exp_avgs = [randn(s) * 1e-2 for s in shapes]
    exp_avg_sqs = [randn(s).square() * 1e-4 for s in shapes]
    return params, grads, exp_avgs, exp_avg_sqs


def _adam(t: int, device="cpu") -> torch.Tensor:
    b1, b2 = BETAS
    return torch.tensor([(LR / (1 - b1 ** t)) * -1, (1 - b2 ** t) ** 0.5], dtype=torch.float32, device=device)


def _clone(tensors):
    return [[t.clone() for t in ts] for ts in tensors]


def _norm(grads) -> float:
    return float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))


@torch.no_grad()
def _foreach_adamw_step(params, grads, exp_avgs, exp_avg_sqs, adam):
    """The default foreach AdamW step, op for op, its step size and
    √(1 − β2^t) taken from ``adam`` on the device where it takes floats."""
    b1, b2 = BETAS
    torch._foreach_mul_(params, 1 - LR * WD)
    torch._foreach_lerp_(exp_avgs, grads, 1 - b1)
    torch._foreach_mul_(exp_avg_sqs, b2)
    torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - b2)
    denom = torch._foreach_sqrt(exp_avg_sqs)
    torch._foreach_div_(denom, adam[1])
    torch._foreach_add_(denom, EPS)
    torch._foreach_addcmul_(params, torch._foreach_div(exp_avgs, denom), [adam[0]] * len(params))


def _step(params, grads, exp_avgs, exp_avg_sqs, adam, max_norm=MAX_NORM):
    return kernels.clip_adamw_step(params, grads, exp_avgs, exp_avg_sqs, adam, max_norm, LR, BETAS, EPS, WD)


def _equal(got, want) -> bool:
    return all(torch.equal(a, b) for ga, wa in zip(got, want) for a, b in zip(ga, wa))


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("case", ["clipped", "under_max", "no_clip"])
def test_plain_equals_the_clip_then_the_foreach_step(case):
    """The wrapper on the CPU against ``base.clip_by_global_norm_`` then the
    foreach step: parameters and moments bit for bit, the gradients left as
    they were, the global norm returned."""
    gen = torch.Generator().manual_seed(0)
    scale = {"clipped": 1.0, "under_max": 1e-3, "no_clip": 1.0}[case]
    max_norm = None if case == "no_clip" else MAX_NORM
    got = _state(SMALL, gen, grad_scale=scale)
    want = _clone(got)
    grads_before = [g.clone() for g in got[1]]
    norm = _step(*got, _adam(3), max_norm)
    if max_norm is not None:
        base.clip_by_global_norm_(want[1], max_norm)
    _foreach_adamw_step(*want, _adam(3))
    assert _equal([got[0], got[2], got[3]], [want[0], want[2], want[3]])
    assert _equal([got[1]], [grads_before])
    assert norm.shape == () and float(norm) == pytest.approx(_norm(grads_before), rel=1e-6)
    assert (float(norm) > MAX_NORM) == (case != "under_max")


def test_plain_follows_opt_step():
    """Ten steps of the wrapper against ``opt.step()`` on the same gradients,
    with the scalars ``base.adamw_scalars`` works out from the optimizer's
    count: within ``CPU_STEP_ULPS`` a step of each tensor's largest entry."""
    gen = torch.Generator().manual_seed(1)
    ref = [torch.nn.Parameter(torch.randn(s, generator=gen)) for s in SMALL]
    opt = base.build_optimizer(ref, LR)
    params = [p.detach().clone() for p in ref]
    moments = None
    for t in range(1, 11):
        grads = [torch.randn(s, generator=gen) for s in SMALL]
        if t == 1:  # the state a first step leaves, as PQL's first step makes it
            for p, g in zip(ref, grads):
                p.grad = g.clone()
            opt.step()
            params = [p.detach().clone() for p in ref]
            moments = [[opt.state[p][k].clone() for p in ref] for k in ("exp_avg", "exp_avg_sq")]
            continue
        adam = base.adamw_scalars(opt, 1, torch.device("cpu"))[0]
        _step(params, grads, *moments, adam)
        clipped = [g.clone() for g in grads]
        base.clip_by_global_norm_(clipped, MAX_NORM)
        for p, g in zip(ref, clipped):
            p.grad = g
        opt.step()
        for a, b in zip(params, ref):
            ulp = torch.finfo(torch.float32).eps * float(b.detach().abs().max())
            assert float((a - b.detach()).abs().max()) <= CPU_STEP_ULPS * (t - 1) * ulp


@pytest.mark.parametrize("fault", ["dtype", "device", "shape", "lengths", "empty", "too_many", "adam"])
def test_wrapper_refuses(fault):
    """What the kernel does not take is refused on any device: another
    dtype, a tensor on another device, a shape that differs from its
    parameter's, lists of other lengths, none or too many tensors, AdamW
    scalars of another form."""
    gen = torch.Generator().manual_seed(2)
    ps, gs, ms, vs = _state(SMALL, gen)
    adam = _adam(1)
    if fault == "dtype":
        gs[1] = gs[1].double()
    elif fault == "device":
        ms[2] = torch.empty(ms[2].shape, device="meta")
    elif fault == "shape":
        vs[0] = vs[0].reshape(-1)
    elif fault == "lengths":
        gs = gs[:-1]
    elif fault == "empty":
        ps, gs, ms, vs = [], [], [], []
    elif fault == "too_many":
        ps, gs, ms, vs = ([torch.zeros(2)] * (kernels.CLIP_ADAMW_MAX_TENSORS + 1) for _ in range(4))
    else:
        adam = adam[:1]
    with pytest.raises((TypeError, ValueError), match="clip_adamw_step"):
        _step(ps, gs, ms, vs, adam)


def _pql_cfg(algo="pql"):
    return make_config(algo, task="Cartpole", num_envs=16, algo__batch_size=32, algo__memory_size=4096,
                       algo__warm_up=4, algo__critic_sample_ratio=2, algo__critic_actor_ratio=2)


@pytest.mark.parametrize("algo", ["pql", "pql_d"])
def test_pql_steps_through_the_wrapper_after_each_optimizers_first(monkeypatch, algo):
    """Two iterations at 2 critic : 1 actor updates: each optimizer's first
    update is ``opt.step()``, which a wrap of ``opt.step`` sees once, and
    every later update one call of the wrapper; the step counts stand at the
    updates taken."""
    calls = []
    real = kernels.clip_adamw_step
    monkeypatch.setattr(kernels, "clip_adamw_step", lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    agent = PQL(_pql_cfg(algo), device="cpu")
    state, _ = agent.warmup(agent.init(0))
    seen = {}
    for name in ("critic_opt", "actor_opt"):
        opt = getattr(state, name)
        step = opt.step
        opt.step = lambda *a, _s=step, _n=name, **k: seen.setdefault(_n, []).append(1) or _s(*a, **k)
    for _ in range(2):
        state, _ = agent.train_iter(state)
    n_critic, n_actor = len(list(state.critic.parameters())), len(list(state.actor.parameters()))
    assert sorted(calls) == sorted([n_critic] * 3 + [n_actor] * 1)
    assert seen == {"critic_opt": [1], "actor_opt": [1]}
    assert base.step_count(state.critic_opt) == 4 and base.step_count(state.actor_opt) == 2


def test_ddpgv_keeps_the_default_step(monkeypatch):
    """DDPGV's updates keep ``base.optimizer_step`` with ``opt.step()``: the
    wrapper is never called."""

    def refuse(*a, **k):
        raise AssertionError("DDPGV called clip_adamw_step")

    monkeypatch.setattr(kernels, "clip_adamw_step", refuse)
    cfg = make_config("ddpgv", task="ReacherVision", num_envs=8, algo__batch_size=32, algo__memory_size=512,
                      algo__horizon_len=4, algo__update_times=1, algo__warm_up=4)
    agent = DDPGV(cfg, device="cpu")
    state, _ = agent.warmup(agent.init(0))
    state, _ = agent.train_iter(state)
    assert state.update_count == 1 and base.step_count(state.critic_opt) == 1


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: clip_adamw_step's kernels are CUDA kernels")
    return torch.device("cuda")


SHAPES = {"critic": CRITIC, "actor": ACTOR, "small": SMALL}


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", ["critic", "actor", "small"])
def test_kernel_equals_plain_under_the_max_on_card(cuda, shapes):
    """Five steps with the norm under the max: the kernel pair against the
    plain version, parameters and moments bit for bit; the norm within
    ``NORM_RTOL``; two launches from one state agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    got = _state(SHAPES[shapes], gen, cuda, grad_scale=1e-4)
    want = _clone(got)
    assert _norm(got[1]) < MAX_NORM
    for t in range(2, 7):
        again = _clone(got)
        norm = _step(*got, _adam(t, cuda))
        _step(*again, _adam(t, cuda))
        plain = kernels.clip_adamw_step_plain(*want, _adam(t, cuda), MAX_NORM, LR, BETAS, EPS, WD)
        torch.cuda.synchronize()
        assert _equal(got, want) and _equal(got, again)
        assert float(norm) == pytest.approx(float(plain), rel=NORM_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", ["critic", "actor", "small"])
def test_kernel_clips_as_the_plain_version_on_card(cuda, shapes):
    """Gradients of norm ~10³ × the max, and none: the kernel's norm within
    ``NORM_RTOL`` of the plain one, and its step bit for bit the plain step
    of the gradients clipped by the kernel's own norm (the two norms' sums
    take different orders, and nothing else differs)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    for max_norm in (MAX_NORM, None):
        got = _state(SHAPES[shapes], gen, cuda)
        want = _clone(got)
        norm = _step(*got, _adam(5, cuda), max_norm)
        clipped = want[1] if max_norm is None else [torch.where(norm < max_norm, g, g / norm * max_norm)
                                                      for g in want[1]]
        kernels.clip_adamw_step_plain(want[0], clipped, want[2], want[3], _adam(5, cuda), None, LR, BETAS, EPS, WD)
        torch.cuda.synchronize()
        assert _equal([got[0], got[2], got[3]], [want[0], want[2], want[3]])
        assert float(norm) == pytest.approx(_norm(want[1]), rel=NORM_RTOL)


@pytest.mark.gpu
def test_kernel_in_a_graph_equals_opt_step_on_card(cuda):
    """The critic's shapes, 30 steps of gradients over ten decades, all
    under the max: ``opt.step()`` against the kernel pair replayed from one
    CUDA graph with the host's scalars, bit for bit in the parameters and
    both moments; the launches counted once for the capture."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    ref = [torch.nn.Parameter(torch.randn(s, generator=gen, device=cuda)) for s in CRITIC]
    mine = [torch.nn.Parameter(p.detach().clone()) for p in ref]
    opt_ref, opt = base.build_optimizer(ref, LR), base.build_optimizer(mine, LR)
    grads = [torch.zeros_like(p) for p in mine]
    for o, ps in ((opt, mine), (opt_ref, ref)):  # the state a first step leaves
        for p, g in zip(ps, grads):
            p.grad = g.clone()
        o.step()
    adam = torch.zeros(2, device=cuda)
    moments = [[opt.state[p][k] for p in mine] for k in ("exp_avg", "exp_avg_sq")]
    _step(*_state(SMALL, gen, cuda), _adam(1, cuda))  # the library loaded before the capture
    kernels.reset_launches()
    graph, _, nodes = base.capture_graph(lambda: _step(mine, grads, *moments, adam), cuda)
    assert nodes == 2 and kernels.LAUNCHES["clip_adamw_step"] == 2
    for _ in range(30):
        scale = 10.0 ** torch.randint(-9, -3, (len(CRITIC),), generator=gen, device=cuda)
        new = [torch.randn(s, generator=gen, device=cuda) * scale[i] for i, s in enumerate(CRITIC)]
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
def test_kernel_refuses_non_contiguous_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    ps, gs, ms, vs = _state([(4, 6), (6,)], gen, cuda)
    gs[0] = torch.randn(6, 4, generator=gen, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        _step(ps, gs, ms, vs, _adam(1, cuda))


@pytest.mark.gpu
def test_launches_are_counted_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    kernels.reset_launches()
    trace.reset()
    trace.iteration()
    _step(*_state(SMALL, gen, cuda), _adam(1, cuda))
    assert kernels.LAUNCHES["clip_adamw_step"] == 2 and trace.counters()["learner.clip_adamw_steps"] == 2
    trace.reset()
