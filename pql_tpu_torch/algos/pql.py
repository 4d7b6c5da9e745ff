"""PQL and PQL-D on one GPU or several (port of pql_tpu/algos/pql.py:103-121,
365-620).

One iteration, exactly as the JAX package's fused step orders it:

- sim phase, ``horizon`` steps: update the obs-rms, then normalize; actor
  action plus mixed exploration noise (uniform actions in warm-up);
  ``VecEnv.step`` with auto-reset; episode accounting into the trackers;
- n-step staging, then one ring-replay write; ``env_steps`` counts steps
  per env;
- critic phase, ``critic_sample_ratio × horizon`` updates: sample a batch
  (iid pairs, or the slot-stratified window with ``algo.sample_slots``;
  with ``algo.prefetch_batches`` every batch of the phase in one row
  gather before it, bitwise the same batches, since the ring is static
  through the learner phases);
  target from the live actor (as it stood before this iteration's actor
  phase) plus smoothing noise, evaluated on ``critic_target`` as it stood
  when the phase began (the JAX package's semantics); for PQL-D
  the C51 projection with γ^nstep as min(proj(p1_t), proj(p2_t)) under
  no_grad, through the hand-written CUDA kernel ``c51_td_target`` when
  ``algo.use_pallas`` is set (its plain version on CPU tensors) and the
  dense plain path otherwise; BCE of both heads; clip, AdamW, polyak;
- actor phase, ``max(n_critic // critic_actor_ratio, 1) × horizon``
  updates of -mean(q_min) against the post-critic-phase critic, whose
  parameters receive no gradient.

Warm-up is one call of ``warm_up`` steps with uniform actions and no
updates. ``iters_per_call`` is a Python loop. ``set_ratios`` changes the
update counts between iterations (the adaptive ratio controller's lever).

Every random number of one call comes from ``draw_iteration``; ``warmup``
and ``train_iter`` take such a dict (the parity tests hand in the JAX
package's draws) or draw from the state's own ``torch.Generator``.

**Several ranks** (``num_devices`` = the world size of a process group made
by ``parallel.initialize``; one process per GPU): each rank holds the slice
[rank·e_local, (rank+1)·e_local) of the env axis (``parallel.ENV_AXIS_FIELDS``:
env state, obs, n-step FIFO, replay ring, episode accumulators) and a
replica of the rest. The sim-phase draws are made for the global env axis
on every rank's generator and sliced, and the mixed noise's std ladder runs
over global env indices, so the simulated stream does not depend on the
world size; the obs-rms merges the ranks' moments (``update_sharded``). The
learner draws are made at the global batch, and each rank takes its own
columns (index draws over its e_local envs; with ``sample_slots`` every rank
takes the same window draws over its own envs), so every generator stays
level. Each rank samples its own replay at ``batch_local`` rows (the C51
kernel at [batch_local, 51]); gradients are averaged over the ranks before
the clip and the AdamW step, and the phases' losses after them; the episode
events are gathered before the trackers. One rank runs exactly the one-GPU
path, without a collective.

**On a card with one rank** the critic and actor phases replay as CUDA
graphs (``base.PhaseGraphs``), one per phase and update count, where the
eager phases are ~190 launches an update that the host issues one at a
time: a key's first call runs eagerly, its second captures and replays.
The graphs read the draws' row indices (worked out eagerly from the ring's
host pointers), the smoothing normals and AdamW's two per-step scalars
(worked out on the host as ``opt.step()`` works them out) from static
buffers, and everything else in place; a graphed AdamW step is the default
one op for op (``base.adamw_graph_step``), so a replay equals the eager
phase bit for bit. The CPU and several ranks run the phases eagerly.
"""

from __future__ import annotations

import copy
import functools
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from pql_tpu_torch.algos import base
from pql_tpu_torch.envs import make_task
from pql_tpu_torch.envs.base import VecEnv, VecEnvState, handle_timeout
from pql_tpu_torch.ops.distributional import binary_cross_entropy
from pql_tpu_torch.ops.kernels import c51_td_target, c51_td_target_plain
from pql_tpu_torch.ops.noise import add_mixed_normal_noise, add_normal_noise
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.ops.schedules import schedule_value
from pql_tpu_torch.ops.soft_update import soft_update
from pql_tpu_torch.parallel import make_mesh, replicate
from pql_tpu_torch.replay import NStepState, ReplayBuffer, create_nstep, nstep_scan, replay_slots
from pql_tpu_torch.replay.buffer import draw_sample_indices, draw_window_indices, window_fits
from pql_tpu_torch.replay.nstep import FIELDS
from pql_tpu_torch.utils import trace
from pql_tpu_torch.utils.trackers import Tracker


@dataclass
class PQLState:
    actor: nn.Module
    actor_opt: torch.optim.Optimizer
    critic: nn.Module
    critic_opt: torch.optim.Optimizer
    critic_target: nn.Module
    obs_rms: RunningMeanStd
    env_state: VecEnvState
    obs: torch.Tensor
    nstep: NStepState
    replay: ReplayBuffer
    cur_returns: torch.Tensor  # [E_local]
    cur_lengths: torch.Tensor  # [E_local]
    return_tracker: Tracker  # replicated: fed the gathered episode events
    len_tracker: Tracker
    success_tracker: Tracker
    gen: torch.Generator
    env_steps: int  # sim steps per env, warm-up included
    critic_update_count: int
    actor_update_count: int


def check_supported(cfg) -> None:
    """Fail on another algorithm's config and on options the port does not implement yet."""
    if cfg.algo.name != "PQL":
        raise ValueError(f"PQL runs algo.name='PQL', not {cfg.algo.name!r} (algos.get_algo picks the agent)")
    if cfg.algo.noise.type not in ("mixed", "fixed"):
        raise ValueError(f"unknown algo.noise.type {cfg.algo.noise.type!r}")


class PQL(base.ActorCriticAgent):
    """PQL / PQL-D trainer on one device, or on this rank's share of the env mesh."""

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = make_mesh(cfg.num_devices, cfg.mesh_axis)
        self.num_envs = cfg.num_envs  # global
        self.e_local = self.mesh.local(cfg.num_envs, "num_envs")
        self.batch_local = self.mesh.local(cfg.algo.batch_size, "batch_size")
        self.env = VecEnv(make_task(cfg.task), self.e_local)
        self.obs_dim = self.env.obs_dim
        self.action_dim = self.env.action_dim
        self.set_ratios(cfg.algo.critic_sample_ratio, cfg.algo.critic_actor_ratio)
        # the slot-stratified window, where it fits (else iid pairs, as buffer.py:219)
        self.sample_slots = cfg.algo.sample_slots if window_fits(
            cfg.algo.sample_slots, self.batch_local, self.e_local) else 0
        self.iters_per_call = max(int(cfg.algo.iters_per_call), 1)
        self._target_copy: nn.Module | None = None
        # On a card with one rank the learner phases replay as CUDA graphs
        # (``base.PhaseGraphs``); a test may set ``capture_phases`` False to
        # run the same arithmetic eagerly.
        self.capture_phases = self.device.type == "cuda" and self.mesh.size == 1
        self._graphs = base.PhaseGraphs()

    def set_ratios(self, critic_sample_ratio: int, critic_actor_ratio: int) -> None:
        """Update ratios from the next iteration on (pql_tpu/algos/pql.py:268-293):
        ``n_critic`` = critic_sample_ratio × horizon_len critic updates and
        ``n_actor`` = max(critic_sample_ratio // critic_actor_ratio, 1) ×
        horizon_len actor updates per iteration. Params, optimizer, replay,
        generator and counters carry over. ``draw_iteration`` sizes its batch
        draws from these counts, so a draw dict made before a change does not
        fit an iteration after it."""
        self.cfg.algo.critic_sample_ratio = int(critic_sample_ratio)
        self.cfg.algo.critic_actor_ratio = int(critic_actor_ratio)
        horizon = self.cfg.algo.horizon_len
        self.n_critic = int(critic_sample_ratio) * horizon
        self.n_actor = max(int(critic_sample_ratio) // int(critic_actor_ratio), 1) * horizon

    def precompile_ratio_ladder(self, state: PQLState, factor: int = 2, max_ratio: int = 32) -> list[int]:
        """The escalation rungs (critic_sample_ratio × factor^k <= max_ratio)
        that the JAX package compiles ahead of time (pql_tpu/algos/pql.py:295-321).
        Eager PyTorch compiles nothing, so this only returns them."""
        rungs, rung = [], int(self.cfg.algo.critic_sample_ratio) * factor
        while rung <= max_ratio:
            rungs.append(rung)
            rung *= factor
        return rungs

    # ---------------------------------------------------------------- init

    def init(self, seed: int | None = None) -> PQLState:
        """Fresh state. Params and the first env states are drawn on the CPU
        from ``seed`` (so they do not depend on the device); the loop's
        generator lives on the device."""
        cfg, dev, E = self.cfg, self.device, self.e_local
        seed = cfg.seed if seed is None else seed
        g_init = torch.Generator().manual_seed(seed)
        actor = base.build_actor(cfg, self.obs_dim, self.action_dim, g_init).to(dev)
        critic = base.build_critic(cfg, self.obs_dim, self.action_dim, g_init).to(dev)
        replicate([*actor.parameters(), *critic.parameters()])  # the same draws on every rank; rank 0's rule
        critic_target = copy.deepcopy(critic).requires_grad_(False)
        draw = self.mesh.shard(self.env.task.draw_reset(g_init, self.num_envs), self.num_envs)
        env_state, obs = self.env.reset(draw.to(dev))
        slots = replay_slots(cfg.algo.memory_size, cfg.num_envs, cfg.algo.horizon_len)
        replay_dtype = torch.bfloat16 if cfg.algo.replay_dtype == "bfloat16" else torch.float32
        zeros = lambda: torch.zeros(E, dtype=torch.float32, device=dev)  # noqa: E731
        return PQLState(
            actor=actor,
            actor_opt=base.build_optimizer(actor, cfg.algo.actor_lr),
            critic=critic,
            critic_opt=base.build_optimizer(critic, cfg.algo.critic_lr),
            critic_target=critic_target,
            obs_rms=RunningMeanStd((self.obs_dim,), device=dev),
            env_state=env_state,
            obs=obs,
            nstep=create_nstep(E, self.obs_dim, self.action_dim, cfg.algo.nstep, cfg.algo.gamma, device=dev),
            replay=ReplayBuffer(slots, E, self.obs_dim, self.action_dim, replay_dtype,
                                valid_start=cfg.algo.nstep - 1, device=dev),
            cur_returns=zeros(),
            cur_lengths=zeros(),
            return_tracker=Tracker(cfg.algo.tracker_len, dev),
            len_tracker=Tracker(cfg.algo.tracker_len, dev),
            success_tracker=Tracker(cfg.algo.tracker_len, dev),
            gen=torch.Generator(device=dev).manual_seed(seed),
            env_steps=0,
            critic_update_count=0,
            actor_update_count=0,
        )

    # --------------------------------------------------------------- draws

    def draw_iteration(self, gen: torch.Generator, random: bool = False) -> dict[str, torch.Tensor]:
        """Every random number of one call: warm-up (``random=True``) or one
        training iteration. Drawn on ``gen``'s device, returned on the
        agent's device. On several ranks: the env axis is this rank's slice
        of the global draw, and the batch axis its columns of a global-batch
        draw over its own envs (a window draw is the same on every rank).

        - ``action_uniform`` [H, E, A] U(-1, 1) (warm-up) or
          ``explore_normal`` [H, E, A] standard normal;
        - ``reset`` [H, E, k]: the task's fresh-episode draws;
        - ``step`` [H, E, k]: the task's per-step draws, only for a task
          with ``draw_step`` (drawn after ``reset``, so the other tasks'
          draws are unchanged);
        - ``critic_slot`` / ``critic_env`` [n_critic, B]: raw slot draws on
          [0, 2^30) and env indices; ``target_normal`` [n_critic, B, A];
        - ``actor_slot`` / ``actor_env`` [n_actor, B];
        - with the slot-stratified window (``sample_slots`` = n) in place of
          the slot and env draws: ``critic_win_slot`` [n_critic, n] raw slot
          draws and ``critic_win_off`` [n_critic] env offsets on [0, E), and
          ``actor_win_slot`` / ``actor_win_off``.
        """
        cfg, E, A, mesh = self.cfg, self.num_envs, self.action_dim, self.mesh
        horizon = cfg.algo.warm_up if random else cfg.algo.horizon_len
        d = {k: mesh.shard(v, E, axis=1) for k, v in base.draw_rollout(gen, self.env.task, horizon, E, A,
                                                                        random).items()}
        if not random:
            B, cols = cfg.algo.batch_size, mesh.env_slice(cfg.algo.batch_size)
            for phase, count in (("critic", self.n_critic), ("actor", self.n_actor)):
                if self.sample_slots:
                    idx = draw_window_indices(gen, count, self.sample_slots, self.e_local)
                    d[f"{phase}_win_slot"], d[f"{phase}_win_off"] = idx
                else:
                    slot, env = draw_sample_indices(gen, count, B, self.e_local)
                    d[f"{phase}_slot"], d[f"{phase}_env"] = slot[:, cols], env[:, cols]
                if phase == "critic":
                    d["target_normal"] = torch.randn(self.n_critic, B, A, generator=gen, device=gen.device)[:, cols]
        return {k: v.to(self.device) for k, v in d.items()}

    # ----------------------------------------------------------- public API

    def warmup(self, state: PQLState, draws: dict | None = None):
        """``warm_up`` steps of uniform actions, no updates."""
        draws = self.draw_iteration(state.gen, random=True) if draws is None else draws
        return self._step(state, draws, random=True)

    def train_iter(self, state: PQLState, draws: dict | None = None):
        """One iteration: sim phase, replay write, critic phase, actor phase."""
        trace.iteration(self.device)
        draws = self.draw_iteration(state.gen) if draws is None else draws
        return self._step(state, draws, random=False)

    def train_block(self, state: PQLState):
        """``iters_per_call`` iterations; losses averaged over them."""
        losses = []
        for _ in range(self.iters_per_call):
            state, metrics = self.train_iter(state)
            losses.append((metrics["train/critic_loss"], metrics["train/actor_loss"]))
        metrics["train/critic_loss"] = torch.stack([c for c, _ in losses]).mean()
        metrics["train/actor_loss"] = torch.stack([a for _, a in losses]).mean()
        return state, metrics

    # ------------------------------------------------------------ one call

    def _step(self, state: PQLState, draws: dict, random: bool):
        cfg = self.cfg
        horizon = cfg.algo.warm_up if random else cfg.algo.horizon_len
        with trace.span("env.sim"):
            traj = self._sim_phase(state, draws, horizon, random)
        with trace.span("replay.nstep"):
            state.nstep, emitted, _valid = nstep_scan(state.nstep, traj)
        with trace.span("replay.add"):
            state.replay.add(emitted)
        state.env_steps += horizon

        zero = torch.zeros((), device=self.device)
        critic_loss = actor_loss = zero
        if not random:
            with trace.span("learner.critic"):
                critic_loss = self._critic_phase(state, draws)
            with trace.span("learner.actor"):
                actor_loss = self._actor_phase(state, draws)
        metrics = {
            "train/critic_loss": critic_loss,
            "train/actor_loss": actor_loss,
            "train/return": state.return_tracker.mean(),
            "train/episode_length": state.len_tracker.mean(),
            "train/success_rate": state.success_tracker.mean(),
        }
        return state, metrics

    @torch.no_grad()
    def _sim_phase(self, state: PQLState, draws: dict, horizon: int, random: bool):
        cfg = self.cfg
        noise = cfg.algo.noise
        std_hi = schedule_value(noise, state.env_steps // cfg.algo.horizon_len)
        start = self.mesh.rank * self.e_local  # this rank's first global env index
        traj = {k: [] for k in ("obs", "action", "reward", "next_obs", "done")}
        events = []
        obs = state.obs
        for t in range(horizon):
            with trace.span("env.actor"):
                if cfg.algo.obs_norm:
                    if self.mesh.size > 1:
                        state.obs_rms.update_sharded(obs)
                    else:
                        state.obs_rms.update(obs)
                    obs_n = state.obs_rms.normalize(obs)
                else:
                    obs_n = obs
                if random:
                    action = draws["action_uniform"][t]
                elif noise.type == "mixed":
                    action = add_mixed_normal_noise(
                        state.actor(obs_n), draws["explore_normal"][t], noise.std_min, std_hi,
                        out_bounds=(-1.0, 1.0), num_envs_global=self.num_envs, global_start=start,
                    )
                else:
                    action = add_normal_noise(
                        state.actor(obs_n), draws["explore_normal"][t], std_hi, out_bounds=(-1.0, 1.0)
                    )
            state.env_state, next_obs, reward, done, info = self.env.step(
                state.env_state, action, draws["reset"][t], draws["step"][t] if "step" in draws else None
            )

            # episode accounting (reference pql_actor.update_tracker, :129-147)
            with trace.span("env.track"):
                cur_ret = state.cur_returns + reward
                cur_len = state.cur_lengths + 1.0
                done_mask = done > 0.5
                success = info["success"].float() if "success" in info else torch.zeros_like(reward)
                events.append(torch.stack([cur_ret, cur_len, done, success]))
                state.cur_returns = torch.where(done_mask, torch.zeros_like(cur_ret), cur_ret)
                state.cur_lengths = torch.where(done_mask, torch.zeros_like(cur_len), cur_len)

            done_b = handle_timeout(done, info) if cfg.algo.handle_timeout else done
            traj["obs"].append(obs)
            traj["action"].append(action)
            traj["reward"].append((cfg.algo.reward_scale * reward)[:, None])
            traj["next_obs"].append(next_obs)
            traj["done"].append(done_b[:, None])
            obs = next_obs
        state.obs = obs
        with trace.span("env.track"):
            self._update_trackers(state, torch.stack(events), "success" in info)
        return traj

    def _update_trackers(self, state: PQLState, events: torch.Tensor, has_success: bool) -> None:
        """Fold the [H, 4, E_local] episode events (return, length, done,
        success), gathered over the ranks in global env order, into the
        replicated trackers, step by step (pql_tpu/algos/pql.py:624-636)."""
        if self.mesh.size > 1:
            parts = [torch.empty_like(events) for _ in range(self.mesh.size)]
            dist.all_gather(parts, events.contiguous())
            events = torch.cat(parts, dim=2)
        for ret, length, done, success in events:
            done_mask = done > 0.5
            state.return_tracker.update(ret, done_mask)
            state.len_tracker.update(length, done_mask)
            if has_success:
                state.success_tracker.update(success, done_mask)

    def _mean_over_ranks(self, tensors: list[torch.Tensor]) -> None:
        """Average tensors over the ranks in place: one all-reduce of their
        concatenation (the JAX package's pmean)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        flat /= self.mesh.size
        torch._foreach_copy_(tensors, [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)])

    def _grad_reduce(self):
        return self._mean_over_ranks if self.mesh.size > 1 else None

    def _phase_loss(self, losses: list[torch.Tensor]) -> torch.Tensor:
        loss = torch.stack(losses).mean()
        if self.mesh.size > 1:
            self._mean_over_ranks([loss])
        return loss

    def _normalize_clip(self, state: PQLState, x: torch.Tensor) -> torch.Tensor:
        return state.obs_rms.normalize_clip(x) if self.cfg.algo.obs_norm else x

    def _phase_index(self, state: PQLState, draws: dict, phase: str, count: int) -> torch.Tensor:
        """The flat replay rows [count, B] of a learner phase's batches, one
        row of indices per update (on the host's pointers, so never in a graph)."""
        replay = state.replay
        if f"{phase}_win_slot" in draws:
            index = replay.window_index(draws[f"{phase}_win_slot"], draws[f"{phase}_win_off"], self.batch_local)
        else:
            index = replay.sample_index(draws[f"{phase}_slot"], draws[f"{phase}_env"])
        if index.shape[0] != count:
            raise ValueError(f"{index.shape[0]} {phase} batches drawn for {count} updates: "
                             "draws made before a set_ratios do not fit the iterations after it")
        return index

    def _phase_batches(self, state: PQLState, index: torch.Tensor, fields):
        """The batches of a learner phase, one per update: each a row gather
        at its update, or all of them in one gather now with
        ``prefetch_batches`` (the same rows: the ring does not change during
        the learner phases)."""
        replay = state.replay
        if self.cfg.algo.prefetch_batches:
            rows = replay.rows(index)
            return (replay.split(r, fields) for r in rows)
        return (replay.split(replay.rows(i), fields) for i in index)

    def _learn(self, state: PQLState, phase: str, updates, opt, index: torch.Tensor, *inputs: torch.Tensor):
        """``updates(state, index, *inputs)``, a phase's device work, which
        steps ``opt`` once an update: eagerly, or through the phase's CUDA
        graph for its update count."""
        if not self.capture_phases:
            return updates(state, index, *inputs)
        rms = state.obs_rms
        bound = (state.actor, state.critic, state.critic_target, state.actor_opt, state.critic_opt,
                 state.actor_opt.state, state.critic_opt.state, state.replay.data, rms.mean, rms.var, rms.count)
        return self._graphs.run(phase, index.shape[0], bound, functools.partial(updates, state), (index, *inputs), opt)

    def _critic_phase(self, state: PQLState, draws: dict) -> torch.Tensor:
        index = self._phase_index(state, draws, "critic", self.n_critic)
        loss = self._learn(state, "critic", self._critic_updates, state.critic_opt, index, draws["target_normal"])
        state.critic_update_count += self.n_critic
        return loss

    def _critic_updates(self, state: PQLState, index: torch.Tensor, target_normal: torch.Tensor,
                        adam: torch.Tensor | None = None) -> torch.Tensor:
        """The critic phase's updates; ``adam``: the AdamW scalars of a graph's steps."""
        cfg = self.cfg
        gamma_n = cfg.algo.gamma ** cfg.algo.nstep
        params = list(state.critic.parameters())
        project = c51_td_target if cfg.algo.use_pallas else c51_td_target_plain
        # As in the JAX package (pql.py:468-481, which reads state.critic_target
        # from before its update scan), every target of this phase comes from
        # the target net as it stood when the phase began; polyak steps go to
        # state.critic_target and are seen from the next iteration on.
        target_net = self._frozen_target(state)
        losses = []
        for u, batch in enumerate(self._phase_batches(state, index, FIELDS)):
            obs_n = self._normalize_clip(state, batch["obs"])
            next_obs_n = self._normalize_clip(state, batch["next_obs"])
            reward, done = batch["reward"].contiguous(), batch["done"].contiguous()
            with torch.no_grad():
                next_actions = base.target_policy_actions(cfg, state.actor, next_obs_n, target_normal[u])
                if cfg.algo.distl:
                    p1_t, p2_t = target_net(next_obs_n, next_actions)
                    target = project(p1_t, p2_t, reward, done, gamma_n, cfg.algo.v_min, cfg.algo.v_max)
                else:
                    q_next = target_net.q_min(next_obs_n, next_actions)
                    target = reward + (1.0 - done) * gamma_n * q_next
            out1, out2 = state.critic(obs_n, batch["action"])
            if cfg.algo.distl:
                loss = binary_cross_entropy(out1, target) + binary_cross_entropy(out2, target)
            else:
                loss = torch.mean(torch.square(out1 - target)) + torch.mean(torch.square(out2 - target))
            losses.append(base.descend(state.critic_opt, params, loss, cfg.algo.max_grad_norm, self._grad_reduce(),
                                       None if adam is None else adam[u]))
            soft_update(state.critic_target, state.critic, cfg.algo.tau)
        return self._phase_loss(losses)

    @torch.no_grad()
    def _frozen_target(self, state: PQLState) -> nn.Module:
        """A copy of state.critic_target, refreshed in place each phase."""
        if self._target_copy is None:
            self._target_copy = copy.deepcopy(state.critic_target)
        else:
            torch._foreach_copy_(list(self._target_copy.parameters()), list(state.critic_target.parameters()))
        return self._target_copy

    def _actor_phase(self, state: PQLState, draws: dict) -> torch.Tensor:
        index = self._phase_index(state, draws, "actor", self.n_actor)
        loss = self._learn(state, "actor", self._actor_updates, state.actor_opt, index)
        state.actor_update_count += self.n_actor
        return loss

    def _actor_updates(self, state: PQLState, index: torch.Tensor, adam: torch.Tensor | None = None) -> torch.Tensor:
        """The actor phase's updates; ``adam``: the AdamW scalars of a graph's steps."""
        cfg = self.cfg
        params = list(state.actor.parameters())
        losses = []
        for u, batch in enumerate(self._phase_batches(state, index, ("obs",))):
            obs_n = self._normalize_clip(state, batch["obs"])
            # grads w.r.t. the actor only: the critic's parameters get none
            loss = -torch.mean(state.critic.q_min(obs_n, state.actor(obs_n)))
            losses.append(base.descend(state.actor_opt, params, loss, cfg.algo.max_grad_norm, self._grad_reduce(),
                                       None if adam is None else adam[u]))
        return self._phase_loss(losses)

    # ------------------------------------------------------------ eval hook

    @staticmethod
    def eval_actor_apply(actor: nn.Module, obs_n: torch.Tensor) -> torch.Tensor:
        """The deterministic action for the evaluator (pql_tpu/algos/pql.py:640-642)."""
        return actor(obs_n)
