"""Shared actor-critic machinery (port of pql_tpu/algos/base.py:30-245).

The optimizer is the JAX package's optax chain
``clip_by_global_norm(max_norm)`` then ``adamw(lr, 0.9, 0.999, 1e-8,
weight_decay=0.01)`` over every parameter, biases included. AdamW is
``torch.optim.AdamW``; the clip is written by hand because
``torch.nn.utils.clip_grad_norm_`` scales by max/(norm+1e-6) and always
applies, while optax scales by max/norm and only when norm ≥ max.

The off-policy baselines also share the episode statistics wired to the
task's info keys (``make_stats``), the exploration action, the rollout and
the actor-critic construction.

PQL's updates take their clip and AdamW step (but an optimizer's first)
through ``kernels.clip_adamw_step``, the default step with its per-step
scalars read from the device, a kernel pair on a card; there its learner
phases replay as CUDA graphs (``PhaseGraphs``).
"""

from __future__ import annotations

import torch
from torch import nn

from pql_tpu_torch.envs.base import VecEnv, handle_timeout
from pql_tpu_torch.envs.rigid import collected_gc, graph_kernel_nodes
from pql_tpu_torch.models import get_model
from pql_tpu_torch.ops import kernels
from pql_tpu_torch.ops.noise import add_mixed_normal_noise, add_normal_noise
from pql_tpu_torch.ops.schedules import schedule_value
from pql_tpu_torch.replay.nstep import FIELDS
from pql_tpu_torch.utils import trace
from pql_tpu_torch.utils.trackers import EpisodeStats


class ActorCriticAgent:
    """What the loop and the services take from an agent's state: the
    networks its eval hook runs, and the best-model snapshot's actor and
    critic (scripts/train.py:248-258). An agent whose state keeps its
    networks otherwise overrides both (IPPO)."""

    @staticmethod
    def eval_params(state) -> nn.Module:
        return state.actor

    @staticmethod
    def snapshot_parts(state) -> tuple[nn.Module, nn.Module]:
        return state.actor, state.critic


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.algo.compute_dtype == "bfloat16" else torch.float32


def set_precision(cfg) -> None:
    """The port's numerics on the card, global flags of the process (they
    can be read and set without a card): an fp32 config (``algo.compute_dtype``
    float32, as the JAX package asks) runs cuBLAS matmuls and cuDNN
    convolutions in fp32, not TF32 (PyTorch's cuDNN default is TF32); and
    cuDNN picks deterministic algorithms, so a resumed run repeats an
    uninterrupted one bitwise (by default a convolution's backward may sum
    in a different order on every call)."""
    torch.backends.cudnn.deterministic = True
    if cfg.algo.compute_dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def refuse_equivariant(cfg) -> None:
    """An ``Equivariant`` act_class or cri_class needs the task's reps, which
    only the agents building their networks through ``ma_base.MultiAgentCtx``
    pass (IPPO and the EQ family, QTOT, the team agents); PQL, DDPG, SAC,
    CrossQ, PPO, MAPPO and IDDPG build theirs from dims, as the JAX ones do,
    and refuse one."""
    for field in ("act_class", "cri_class"):
        name = getattr(cfg.algo, field)
        if "Equivariant" in name:
            raise ValueError(f"algo.name={cfg.algo.name!r} takes no equivariant network (algo.{field}={name!r}): "
                             "only the two-agent IPPO family, QTOT and the team agents build one")


def build_actor(cfg, obs_dim: int, act_dim: int, gen: torch.Generator) -> nn.Module:
    """The policy named by cfg.algo.act_class."""
    refuse_equivariant(cfg)
    cls = get_model(cfg.algo.act_class)
    return cls(obs_dim, act_dim, gen=gen, dtype=compute_dtype(cfg))


def build_critic(cfg, obs_dim: int, act_dim: int, gen: torch.Generator) -> nn.Module:
    """The critic named by cfg.algo.cri_class; distl=True prepends
    'Distributional' (reference pql_v_learner.py:30-31). A state-value
    ``MLPCritic`` takes the obs alone."""
    refuse_equivariant(cfg)
    name = cfg.algo.cri_class
    if cfg.algo.distl and "Distributional" not in name:
        name = "Distributional" + name
    if name == "MLPCritic":
        return get_model(name)(obs_dim, gen=gen, dtype=compute_dtype(cfg))
    kwargs = {}
    if "Distributional" in name:
        kwargs = dict(v_min=cfg.algo.v_min, v_max=cfg.algo.v_max, num_atoms=cfg.algo.num_atoms)
    return get_model(name)(obs_dim, act_dim, gen=gen, dtype=compute_dtype(cfg), **kwargs)


def build_optimizer(module: nn.Module | list[torch.Tensor], lr: float) -> torch.optim.AdamW:
    params = module.parameters() if isinstance(module, nn.Module) else module
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


def init_actor_critic(cfg, obs_dim: int, act_dim: int, gen: torch.Generator, device):
    """(actor, critic, actor_opt, critic_opt): the modules drawn on the CPU
    from ``gen`` (actor first), then moved to ``device``; AdamW for each."""
    actor = build_actor(cfg, obs_dim, act_dim, gen).to(device)
    critic = build_critic(cfg, obs_dim, act_dim, gen).to(device)
    return actor, critic, build_optimizer(actor, cfg.algo.actor_lr), build_optimizer(critic, cfg.algo.critic_lr)


def probe_info(task) -> dict:
    """The info dict of one dynamics step of one env, eagerly on the CPU (the
    JAX package takes its shapes by ``eval_shape``): which keys the task reports."""
    gen = torch.Generator().manual_seed(0)
    state = task.init_state(task.draw_reset(gen, 1))
    draw = (task.draw_step(gen, 1),) if hasattr(task, "draw_step") else ()
    return task.dynamics(state, torch.zeros(1, task.action_dim), *draw)[3]


def make_stats(cfg, env: VecEnv, device) -> EpisodeStats:
    """EpisodeStats wired to what the task reports: its detailed_reward terms
    and those of cfg.info_track_keys it has, with cfg.info_track_step's modes
    ('last' for every key when unset)."""
    info = probe_info(env.task)
    detailed = tuple(sorted(info["detailed_reward"])) if "detailed_reward" in info else ()
    keys = cfg.info_track_keys or ()
    keys = (keys,) if isinstance(keys, str) else tuple(keys)
    modes = cfg.info_track_step or ("last",) * len(keys)
    modes = (modes,) if isinstance(modes, str) else tuple(modes)
    tracked = [(k, m) for k, m in zip(keys, modes) if k in info]
    return EpisodeStats(env.num_envs, cfg.algo.tracker_len, detailed_keys=detailed,
                        info_keys=tuple(k for k, _ in tracked), info_modes=tuple(m for _, m in tracked),
                        device=device)


def exploration_action(cfg, actor: nn.Module, obs_n: torch.Tensor, normal: torch.Tensor, step: int):
    """The deterministic action plus exploration noise (pql_tpu/algos/base.py:
    93-133): ``fixed`` N(0, std) or ``mixed`` per-env std on
    linspace(std_min, std, E), clamped to ±1; std is the noise schedule at
    iteration ``step`` (std_max without decay)."""
    noise = cfg.algo.noise
    std_hi = schedule_value(noise, step)
    act = actor(obs_n)
    if noise.type == "fixed":
        return add_normal_noise(act, normal, std_hi, out_bounds=(-1.0, 1.0))
    if noise.type == "mixed":
        return add_mixed_normal_noise(act, normal, noise.std_min, std_hi, out_bounds=(-1.0, 1.0),
                                      num_envs_global=obs_n.shape[0])
    raise ValueError(f"unknown algo.noise.type {noise.type!r}")


def draw_rollout(gen: torch.Generator, task, horizon: int, num_envs: int, act_dim: int,
                 random: bool) -> dict[str, torch.Tensor]:
    """A rollout's draws on ``gen``'s device: ``action_uniform`` [H, E, A]
    U(-1, 1) (warm-up) or ``explore_normal`` [H, E, A] standard normal;
    ``reset`` [H, E, k], the task's fresh-episode draws; ``step`` [H, E, k],
    the per-step draws of a task with ``draw_step`` (drawn after ``reset``,
    so the other tasks' draws are unchanged)."""
    d = {}
    if random:
        d["action_uniform"] = torch.rand(horizon, num_envs, act_dim, generator=gen, device=gen.device) * 2.0 - 1.0
    else:
        d["explore_normal"] = torch.randn(horizon, num_envs, act_dim, generator=gen, device=gen.device)
    d["reset"] = torch.stack([task.draw_reset(gen, num_envs) for _ in range(horizon)])
    if hasattr(task, "draw_step"):
        d["step"] = torch.stack([task.draw_step(gen, num_envs) for _ in range(horizon)])
    return d


def env_rewards(env_state, reward: torch.Tensor, info: dict):
    """A step's reward for the episode statistics and its stored [E, C]
    reward channels (before reward_scale): the env's reward, one channel."""
    return reward, reward[:, None]


@torch.no_grad()
def rollout(env: VecEnv, cfg, state, action_fn, draws: dict, horizon: int,
            rewards=env_rewards) -> dict[str, list[torch.Tensor]]:
    """``horizon`` lockstep steps (pql_tpu/algos/base.py:147-215): update the
    obs-rms, then normalize; ``action_fn(obs_n, t)``; ``VecEnv.step`` with
    step t's reset (and per-step) draws; ``rewards(env state before the step,
    reward, info)`` (``env_rewards`` by default); episode statistics. Moves
    ``state.env_state``, ``obs``, ``obs_rms`` and ``stats`` in place and
    returns the trajectory, rewards scaled by reward_scale and dones through
    handle_timeout, ready for n-step staging."""
    traj = {k: [] for k in FIELDS}
    obs = state.obs
    for t in range(horizon):
        if cfg.algo.obs_norm:
            state.obs_rms.update(obs)
            obs_n = state.obs_rms.normalize(obs)
        else:
            obs_n = obs
        action = action_fn(obs_n, t)
        before = state.env_state
        state.env_state, next_obs, reward, done, info = env.step(
            state.env_state, action, draws["reset"][t], draws["step"][t] if "step" in draws else None
        )
        episode_reward, stored = rewards(before, reward, info)
        state.stats.update(episode_reward, done, info)
        done_b = handle_timeout(done, info) if cfg.algo.handle_timeout else done
        traj["obs"].append(obs)
        traj["action"].append(action)
        traj["reward"].append(cfg.algo.reward_scale * stored)
        traj["next_obs"].append(next_obs)
        traj["done"].append(done_b[:, None])
        obs = next_obs
    state.obs = obs
    return traj


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g ← g / norm · max where
    norm ≥ max, unchanged otherwise. Sync-free on the device."""
    for g, c in zip(grads, kernels.clip_by_global_norm(grads, max_norm)[0]):
        g.copy_(c)


def optimizer_step(opt: torch.optim.Optimizer, params: list[torch.Tensor],
                   grads: list[torch.Tensor], max_grad_norm: float | None, reduce=None,
                   adam: torch.Tensor | None = None) -> None:
    """``reduce(grads)`` in place if given (PQL's mean over the ranks), clip
    (if max_grad_norm is set), then one AdamW step with ``grads``: ``opt.step()``,
    or with ``adam`` (a row of ``adamw_scalars``) the kernel pair
    ``kernels.clip_adamw_step``, which a CUDA graph can hold. An optimizer's
    first step is ``opt.step()`` all the same: it makes the optimizer's state
    as ``torch.optim.AdamW`` makes it, and whoever wraps ``opt.step`` sees it."""
    if reduce is not None:
        reduce(grads)
    # An optimizer's first step stays ``opt.step()``: torch.optim.AdamW makes its state there, and the
    # benchmark's first-gradient recorder (benchmark/reference/recording.py) wraps ``opt.step`` to read it.
    # Once the recorder reads the first moments without that wrap, the state can be made eagerly and
    # every step taken by the kernel pair, without this branch.
    if adam is not None and step_count(opt) > 0:
        group = _adamw_group(opt)
        state = [opt.state[p] for p in params]
        kernels.clip_adamw_step(params, grads, [s["exp_avg"] for s in state], [s["exp_avg_sq"] for s in state],
                                adam, max_grad_norm, group["lr"], group["betas"], group["eps"],
                                group["weight_decay"])
        return
    if max_grad_norm is not None:
        clip_by_global_norm_(grads, max_grad_norm)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def descend(opt: torch.optim.Optimizer, params: list[torch.Tensor], loss: torch.Tensor,
            max_grad_norm: float | None, reduce=None, adam: torch.Tensor | None = None) -> torch.Tensor:
    """One optimizer step on ``loss``'s gradients w.r.t. ``params`` alone
    (other parameters the loss reads get none); returns the detached loss."""
    optimizer_step(opt, params, list(torch.autograd.grad(loss, params)), max_grad_norm, reduce, adam)
    return loss.detach()


def target_policy_actions(cfg, actor: nn.Module, next_obs: torch.Tensor, normal: torch.Tensor):
    """Target-policy smoothing: actor(next_obs) + clip(std·normal, ±b),
    clamped to ±1 (reference ddpg.py:71-79)."""
    b = cfg.algo.noise.tgt_pol_noise_bound
    return add_normal_noise(
        actor(next_obs), normal, cfg.algo.noise.tgt_pol_std, noise_bounds=(-b, b), out_bounds=(-1.0, 1.0)
    )


# ------------------------------------------------------ learner phases as graphs


def _adamw_group(opt: torch.optim.Optimizer) -> dict:
    """The one parameter group of a default ``build_optimizer`` AdamW, the
    form ``kernels.clip_adamw_step`` repeats; any other is refused."""
    (group,) = opt.param_groups
    form = {k: group.get(k) for k in ("amsgrad", "maximize", "capturable", "fused", "differentiable")}
    if not isinstance(opt, torch.optim.AdamW) or any(form.values()) or group.get("foreach") is False:
        raise ValueError(f"a graphed step repeats the default foreach AdamW, not {type(opt).__name__} {form}")
    return group


def step_count(opt: torch.optim.AdamW) -> float:
    """The optimizer's steps so far (every parameter's count is the same; 0
    before its first step)."""
    return float(opt.state.get(opt.param_groups[0]["params"][0], {}).get("step", 0.0))


def adamw_scalars(opt: torch.optim.AdamW, steps: int, device: torch.device) -> torch.Tensor:
    """[steps, 2] float32 on ``device``: the step size −lr/(1 − β1^t) and
    √(1 − β2^t) of the optimizer's next ``steps`` steps, worked out on the
    host in float64 from its step count as ``torch.optim.AdamW`` works them
    out, rounded to float32 as its kernels take them; copied without a wait."""
    group = _adamw_group(opt)
    lr, (b1, b2) = group["lr"], group["betas"]
    t0 = step_count(opt)
    rows = [((lr / (1 - b1 ** t)) * -1, (1 - b2 ** t) ** 0.5) for t in (t0 + k for k in range(1, steps + 1))]
    host = torch.tensor(rows, dtype=torch.float32)
    return (host.pin_memory() if device.type == "cuda" else host).to(device, non_blocking=True)


def capture_graph(fn, device: torch.device):
    """``fn()`` captured in a CUDA graph on ``device``, not run: (the graph,
    fn's output, the graph's kernel nodes as libcuda counts them)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # instantiated below, after its nodes can be counted
    with torch.cuda.device(device), collected_gc(), torch.cuda.graph(graph):
        out = fn()
    graph.instantiate()
    return graph, out, graph_kernel_nodes(graph)[0]


def _take_back(counts: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    """What ``counts`` gained since it read ``before``, taken back out of it."""
    made = {k: n - before.get(k, 0) for k, n in counts.items() if n != before.get(k, 0)}
    counts.clear()
    counts.update(before)
    return made


class PhaseGraph:
    """One learner phase ``fn(*inputs) -> loss`` captured as a CUDA graph.
    ``inputs`` are copied into static buffers before each replay; everything
    else the phase reads and writes (parameters, optimizer state, the
    replay ring, the normalizer) is read in place, so it must keep its
    storage. Each call returns a clone of the loss: the next replay
    overwrites the graph's own.

    The capture runs the phase's Python but none of its kernels, so the
    launch counts the kernels' wrappers made during it (``kernels.LAUNCHES``,
    and the tracer's counters of the iteration) are taken back and made by
    each replay instead."""

    def __init__(self, fn, inputs: tuple[torch.Tensor, ...]):
        self.inputs = [x.clone() for x in inputs]
        launched, counted = dict(kernels.LAUNCHES), dict(trace.counters())
        with trace.span("setup.learner_capture") as span:
            self.graph, self.out, self.kernels = capture_graph(lambda: fn(*self.inputs), inputs[0].device)
        self.launches = _take_back(kernels.LAUNCHES, launched)
        self.counts = _take_back(trace.counters(), counted)
        self.capture_s = span.seconds  # host seconds of the capture and instantiation (None with the tracer off)
        trace.count("learner.graph_captures")

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        with trace.span("learner.graph_in"):
            for buf, x in zip(self.inputs, inputs, strict=True):
                if x.shape != buf.shape:
                    raise ValueError(f"a phase input of shape {tuple(x.shape)}, captured as {tuple(buf.shape)}")
                buf.copy_(x)
        with trace.span("learner.graph_replay"):
            self.graph.replay()
        for name, n in self.launches.items():
            kernels.LAUNCHES[name] += n
        for name, n in self.counts.items():
            trace.count(name, n)
        trace.count("learner.graph_replays")
        trace.count("learner.graph_kernels", self.kernels)
        return self.out.clone()


class PhaseGraphs:
    """An agent's learner phases, each ``fn(*inputs, adam)`` with ``adam`` the
    ``adamw_scalars`` of its steps, so that every update's step (after an
    optimizer's first) is the kernel pair ``kernels.clip_adamw_step``.

    With ``capture`` (a card with one rank) they run as CUDA graphs, one per
    phase and update count (so every update ratio gets its own). A key's
    first call runs the phase eagerly, on a side stream as capture requires
    (it is that iteration's real update); its second captures the phase and
    replays it, and every later call replays. No update runs twice or is
    skipped, and a replay does the eager arithmetic bit for bit. Without
    ``capture`` every call runs eagerly. After a phase the optimizer's step
    counts (host tensors) stand at the steps it took.

    ``bound`` names the objects whose tensors the graphs read in place (the
    modules, the optimizers and their state dicts, the ring, the
    normalizer's moments). Where any differs from those of the last call,
    because a checkpoint load gave an optimizer new state or another state
    came in, every graph is dropped and each key starts again eagerly."""

    def __init__(self):
        self.graphs: dict[tuple[str, int], PhaseGraph | None] = {}  # None: the key ran once, eagerly
        self.bound: tuple = ()

    def run(self, phase: str, steps: int, bound: tuple, fn, inputs: tuple[torch.Tensor, ...],
            opt: torch.optim.AdamW, capture: bool = True) -> torch.Tensor:
        """The loss of a phase of ``steps`` steps of ``opt``."""
        t0 = step_count(opt)
        inputs = (*inputs, adamw_scalars(opt, steps, inputs[0].device))
        if not capture:
            loss = fn(*inputs)
        else:
            if len(bound) != len(self.bound) or any(a is not b for a, b in zip(bound, self.bound)):
                self.graphs.clear()
                self.bound = bound
            key = (phase, steps)
            if key not in self.graphs:
                self.graphs[key] = None
                loss = self._eager(fn, inputs)
            else:
                graph = self.graphs[key]
                if graph is None:
                    graph = self.graphs[key] = PhaseGraph(fn, inputs)
                loss = graph(*inputs)
        if step_count(opt) > 0:  # (an ``opt.step`` that made no state leaves none to count)
            counts = [opt.state[p]["step"] for p in opt.param_groups[0]["params"]]
            torch._foreach_add_(counts, t0 + steps - step_count(opt))  # an eager first step counted its own
        return loss

    @staticmethod
    def _eager(fn, inputs: tuple[torch.Tensor, ...]) -> torch.Tensor:
        dev = inputs[0].device
        if dev.type != "cuda":
            return fn(*inputs)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(*inputs)
        main.wait_stream(side)
        out.record_stream(main)
        return out
