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
"""

from __future__ import annotations

import torch
from torch import nn

from pql_tpu_torch.envs.base import VecEnv, handle_timeout
from pql_tpu_torch.models import get_model
from pql_tpu_torch.ops.noise import add_mixed_normal_noise, add_normal_noise
from pql_tpu_torch.ops.schedules import schedule_value
from pql_tpu_torch.replay.nstep import FIELDS
from pql_tpu_torch.utils.trackers import EpisodeStats


def check_one_device(cfg) -> None:
    """Refuse a multi-device run: the port runs on one device so far."""
    if (cfg.num_devices or 1) != 1:
        raise NotImplementedError(f"num_devices={cfg.num_devices!r} is not ported yet (only 1)")


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
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def optimizer_step(opt: torch.optim.Optimizer, params: list[torch.Tensor],
                   grads: list[torch.Tensor], max_grad_norm: float | None) -> None:
    """Clip (if max_grad_norm is set), then one AdamW step with ``grads``."""
    if max_grad_norm is not None:
        clip_by_global_norm_(grads, max_grad_norm)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def descend(opt: torch.optim.Optimizer, params: list[torch.Tensor], loss: torch.Tensor,
            max_grad_norm: float | None) -> torch.Tensor:
    """One optimizer step on ``loss``'s gradients w.r.t. ``params`` alone
    (other parameters the loss reads get none); returns the detached loss."""
    optimizer_step(opt, params, list(torch.autograd.grad(loss, params)), max_grad_norm)
    return loss.detach()


def target_policy_actions(cfg, actor: nn.Module, next_obs: torch.Tensor, normal: torch.Tensor):
    """Target-policy smoothing: actor(next_obs) + clip(std·normal, ±b),
    clamped to ±1 (reference ddpg.py:71-79)."""
    b = cfg.algo.noise.tgt_pol_noise_bound
    return add_normal_noise(
        actor(next_obs), normal, cfg.algo.noise.tgt_pol_std, noise_bounds=(-b, b), out_bounds=(-1.0, 1.0)
    )
