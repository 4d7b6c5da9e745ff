"""DDPGV, visual DDPG through the host replay ring, on one device (port of
pql_tpu/algos/ddpgv.py).

- **Actor**: ``DiagGaussianMLPVPolicy`` on the task's camera frames
  (``ResEncoder``), proprio and point cloud, feature and hidden width 256;
  it acts as tanh(mean). **Critic**: ``algo.cri_class`` (Double-Q) on the
  privileged flat obs, with a soft-updated target.
- **Ring**: ``native.HostReplay`` with max(memory_size // E, 2) slots and 11
  fields: the frames before and after the step as uint8 (round(x·255),
  half to even), proprio, point cloud and obs before and after, the action,
  reward_scale·reward and done as fp16.
- **Collect**, ``horizon_len`` steps: obs-rms update from the pre-step obs;
  uniform actions (``random``) or tanh(mean) plus mixed noise on
  linspace(std_min, std_max, E); ``VecEnv.step``; the frames rendered from
  the state after the step (the auto-reset frame after a done), which are
  also the next step's frames before it; episode trackers; then one
  device-to-host copy per field and one ring write.
- **Update**, ``update_times`` per iteration: a batch gathered on the host
  into pinned staging buffers and copied to the card, one copy per field;
  frames decoded with /255, obs normalized and clipped; the target
  reward + (1 − done)·γ·q_min of the target critic at the target policy's
  smoothed action (one step: no n-step); the sum of the twin MSEs; polyak;
  then −mean(q_min) of the updated critic through the actor.

Two staging sets alternate, each with a CUDA event recorded after its
copies; a set is gathered into again only after its event has completed,
so the host gathers the next batch while the card computes this one.

Warm-up is one collect of ``horizon_len`` uniform-action steps. The ring's
sampler is its own ``default_rng(0)`` (the JAX package's); every other draw
of a call comes from ``draw_iteration``, which tests may replace with the
JAX package's. ``DDPGVState`` holds no ring, as the JAX state holds none: a
resumed run starts from an empty ring and a fresh sampler.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from pql_tpu_torch.algos import base
from pql_tpu_torch.algos.ppov import visual_actor
from pql_tpu_torch.envs import make_env
from pql_tpu_torch.envs.base import VecEnvState
from pql_tpu_torch.native import HostReplay
from pql_tpu_torch.ops.noise import add_mixed_normal_noise, add_normal_noise
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.ops.soft_update import soft_update
from pql_tpu_torch.utils import trace
from pql_tpu_torch.utils.trackers import Tracker

STAGING_SETS = 2


@dataclass
class DDPGVState:
    actor: nn.Module
    actor_opt: torch.optim.Optimizer
    critic: nn.Module
    critic_opt: torch.optim.Optimizer
    critic_target: nn.Module
    obs_rms: RunningMeanStd
    env_state: VecEnvState
    obs: torch.Tensor
    cur_returns: torch.Tensor  # [E]
    cur_lengths: torch.Tensor  # [E]
    return_tracker: Tracker
    len_tracker: Tracker
    gen: torch.Generator
    env_steps: int  # total env steps, warm-up included
    update_count: int


def quantize(x: torch.Tensor) -> torch.Tensor:
    """[E, ...] frames in [0, 1] → [E, n] uint8 round(x·255), half to even."""
    return torch.round(x * 255.0).to(torch.uint8).reshape(x.shape[0], -1)


class DDPGV(base.ActorCriticAgent):
    """Visual DDPG with host-RAM replay."""

    name = "DDPGV"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.env = make_env(cfg)
        task = self.env.task
        if not hasattr(task, "render"):
            raise ValueError("DDPGV needs a camera task (render/proprio/pointcloud)")
        self.num_envs = cfg.num_envs
        self.obs_dim = self.env.obs_dim
        self.action_dim = self.env.action_dim
        self.update_times = int(cfg.algo.update_times)
        spec = task.visual_spec
        self.img_shape = tuple(spec["img"])  # [cams, T, H, W, 3]
        self.pc_shape = tuple(spec["pc"])
        img_dim, pc_dim, proprio_dim = int(np.prod(self.img_shape)), int(np.prod(self.pc_shape)), int(spec["proprio"])
        fields = dict(img=img_dim, next_img=img_dim, proprio=proprio_dim, next_proprio=proprio_dim, pc=pc_dim,
                      next_pc=pc_dim, obs=self.obs_dim, next_obs=self.obs_dim, action=self.action_dim, reward=1,
                      done=1)
        dtypes = {k: np.float16 for k in fields}
        dtypes["img"] = dtypes["next_img"] = np.uint8
        slots = max(int(cfg.algo.memory_size) // self.num_envs, 2)
        self.replay = HostReplay(slots, self.num_envs, fields, dtypes)
        self._staging: list | None = None

    # ---------------------------------------------------------------- init

    def init(self, seed: int | None = None) -> DDPGVState:
        """Fresh state. Params and the first env states are drawn on the CPU
        from ``seed`` (actor, critic, env); the loop's generator lives on the device."""
        cfg, dev, E = self.cfg, self.device, self.num_envs
        seed = cfg.seed if seed is None else seed
        g_init = torch.Generator().manual_seed(seed)
        actor = visual_actor(cfg, self.env.task, self.action_dim, g_init, camera=True).to(dev)
        critic = base.build_critic(cfg, self.obs_dim, self.action_dim, g_init).to(dev)
        env_state, obs = self.env.reset(self.env.task.draw_reset(g_init, E).to(dev))
        zeros = lambda: torch.zeros(E, dtype=torch.float32, device=dev)  # noqa: E731
        return DDPGVState(
            actor=actor,
            actor_opt=base.build_optimizer(actor, cfg.algo.actor_lr),
            critic=critic,
            critic_opt=base.build_optimizer(critic, cfg.algo.critic_lr),
            critic_target=copy.deepcopy(critic).requires_grad_(False),
            obs_rms=RunningMeanStd((self.obs_dim,), device=dev),
            env_state=env_state,
            obs=obs,
            cur_returns=zeros(),
            cur_lengths=zeros(),
            return_tracker=Tracker(cfg.algo.tracker_len, dev),
            len_tracker=Tracker(cfg.algo.tracker_len, dev),
            gen=torch.Generator(device=dev).manual_seed(seed),
            env_steps=0,
            update_count=0,
        )

    # --------------------------------------------------------------- draws

    def draw_iteration(self, gen: torch.Generator, random: bool = False) -> dict[str, torch.Tensor]:
        """Every draw of one call but the ring's sampler: ``action_uniform``
        (warm-up) or ``explore_normal`` [H, E, A], ``reset`` [H, E, k] (and a
        task's ``step``), and for an iteration ``target_normal`` [U, B, A],
        the target-policy smoothing of each update. Drawn on ``gen``'s device,
        returned on the agent's."""
        cfg = self.cfg
        d = base.draw_rollout(gen, self.env.task, cfg.algo.horizon_len, self.num_envs, self.action_dim, random)
        if not random:
            d["target_normal"] = torch.randn(self.update_times, cfg.algo.batch_size, self.action_dim, generator=gen,
                                             device=gen.device)
        return {k: v.to(self.device) for k, v in d.items()}

    # ----------------------------------------------------------- public API

    def warmup(self, state: DDPGVState, draws: dict | None = None):
        """One collect of ``horizon_len`` uniform-action steps into the ring."""
        draws = self.draw_iteration(state.gen, random=True) if draws is None else draws
        self.ring_write(self.collect(state, draws, random=True))
        return state, {}

    def train_iter(self, state: DDPGVState, draws: dict | None = None):
        """Collect and write, then ``update_times`` sampled updates."""
        trace.iteration(self.device)
        draws = self.draw_iteration(state.gen) if draws is None else draws
        with trace.span("env.collect"):
            traj = self.collect(state, draws)
        with trace.span("replay.ring_write"):
            self.ring_write(traj)
        losses = []
        for u in range(self.update_times):
            with trace.span("replay.fetch_batch"):
                batch = self.fetch_batch(u)
            with trace.span("learner.update"):
                losses.append(self.update(state, batch, draws["target_normal"][u]))
        metrics = {
            "train/critic_loss": torch.stack([c for c, _ in losses]).mean(),
            "train/actor_loss": torch.stack([a for _, a in losses]).mean(),
            "train/return": state.return_tracker.mean(),
            "train/episode_length": state.len_tracker.mean(),
            "train/success_rate": torch.zeros((), device=self.device),
        }
        return state, metrics

    # -------------------------------------------------------------- collect

    def visual_obs(self, env_state: VecEnvState):
        """(img [E, cams, T, H, W, 3], proprio, pc) rendered from the physics state."""
        task = self.env.task
        st = env_state.state
        with trace.span("env.render"):
            return task.render(st), task.proprio(st), task.pointcloud(st)

    @staticmethod
    def act(actor: nn.Module, img, proprio, pc) -> torch.Tensor:
        return torch.tanh(actor(img, proprio, pc)[0])

    @torch.no_grad()
    def collect(self, state: DDPGVState, draws: dict, random: bool = False) -> dict[str, torch.Tensor]:
        """``horizon_len`` steps; returns the ring's fields [H, E, dim] on the device."""
        cfg, E = self.cfg, self.num_envs
        noise = cfg.algo.noise
        traj = {k: [] for k in self.replay.fields}
        img, proprio, pc = self.visual_obs(state.env_state)
        for t in range(cfg.algo.horizon_len):
            obs = state.obs
            if cfg.algo.obs_norm:
                state.obs_rms.update(obs)
            if random:
                action = draws["action_uniform"][t]
            else:
                action = add_mixed_normal_noise(self.act(state.actor, img, proprio, pc), draws["explore_normal"][t],
                                                noise.std_min, noise.std_max, out_bounds=(-1.0, 1.0),
                                                num_envs_global=E)
            state.env_state, next_obs, reward, done, _info = self.env.step(
                state.env_state, action, draws["reset"][t], draws["step"][t] if "step" in draws else None)
            n_img, n_proprio, n_pc = self.visual_obs(state.env_state)
            cur_ret, cur_len = state.cur_returns + reward, state.cur_lengths + 1.0
            done_mask = done > 0.5
            state.return_tracker.update(cur_ret, done_mask)
            state.len_tracker.update(cur_len, done_mask)
            state.cur_returns = torch.where(done_mask, torch.zeros_like(cur_ret), cur_ret)
            state.cur_lengths = torch.where(done_mask, torch.zeros_like(cur_len), cur_len)
            half = lambda x: x.to(torch.float16).reshape(E, -1)  # noqa: E731
            for k, v in (("img", quantize(img)), ("next_img", quantize(n_img)), ("proprio", half(proprio)),
                         ("next_proprio", half(n_proprio)), ("pc", half(pc)), ("next_pc", half(n_pc)),
                         ("obs", half(obs)), ("next_obs", half(next_obs)), ("action", half(action)),
                         ("reward", half(cfg.algo.reward_scale * reward)), ("done", half(done))):
                traj[k].append(v)
            state.obs = next_obs
            img, proprio, pc = n_img, n_proprio, n_pc
        state.env_steps += cfg.algo.horizon_len * E
        return {k: torch.stack(v) for k, v in traj.items()}

    @staticmethod
    def to_host(traj: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One device-to-host copy per field."""
        return {k: v.cpu() for k, v in traj.items()}

    def ring_write(self, traj: dict[str, torch.Tensor]) -> None:
        with trace.span("replay.to_host"):
            host = self.to_host(traj)
        with trace.span("replay.ring_add"):
            self.replay.add(host)

    # --------------------------------------------------------------- update

    def _staging_set(self, u: int):
        """Staging set u % 2: pinned [batch, dim] buffers per field and the
        event recorded after their last copy to the card."""
        if self._staging is None:
            B = self.cfg.algo.batch_size
            self._staging = [
                ({k: torch.empty(B, dim, dtype=self.replay.torch_dtype(k), pin_memory=True)
                  for k, dim in self.replay.fields.items()}, torch.cuda.Event())
                for _ in range(STAGING_SETS)]
        return self._staging[u % STAGING_SETS]

    def fetch_batch(self, u: int) -> dict[str, torch.Tensor]:
        """Update u's batch on the agent's device: gathered on the host, then
        one copy per field (from pinned staging on the card)."""
        B = self.cfg.algo.batch_size
        if self.device.type != "cuda":
            with trace.span("replay.gather"):
                return {k: torch.from_numpy(v) for k, v in self.replay.sample(B).items()}
        host, copied = self._staging_set(u)
        with trace.span("replay.staging_wait"):
            copied.synchronize()  # this set's previous copies have landed
        with trace.span("replay.gather"):
            self.replay.sample(B, out=host)
        with trace.span("replay.h2d"):
            batch = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
            copied.record()
        return batch

    def update(self, state: DDPGVState, batch: dict[str, torch.Tensor], normal: torch.Tensor):
        """One critic step, polyak, one actor step; returns the two losses."""
        cfg = self.cfg
        f = lambda k: batch[k].float()  # noqa: E731
        norm = (lambda x: state.obs_rms.normalize_clip(x)) if cfg.algo.obs_norm else (lambda x: x)  # noqa: E731
        img = f("img").reshape((-1,) + self.img_shape) / 255.0
        n_img = f("next_img").reshape((-1,) + self.img_shape) / 255.0
        pc, n_pc = f("pc").reshape((-1,) + self.pc_shape), f("next_pc").reshape((-1,) + self.pc_shape)
        obs, next_obs = norm(f("obs")), norm(f("next_obs"))
        with torch.no_grad():
            b = cfg.algo.noise.tgt_pol_noise_bound
            next_action = add_normal_noise(self.act(state.actor, n_img, f("next_proprio"), n_pc), normal,
                                           cfg.algo.noise.tgt_pol_std, noise_bounds=(-b, b), out_bounds=(-1.0, 1.0))
            target = f("reward") + (1.0 - f("done")) * cfg.algo.gamma * state.critic_target.q_min(next_obs, next_action)
        q1, q2 = state.critic(obs, f("action"))
        loss = torch.mean(torch.square(q1 - target)) + torch.mean(torch.square(q2 - target))
        critic_loss = base.descend(state.critic_opt, list(state.critic.parameters()), loss, cfg.algo.max_grad_norm)
        soft_update(state.critic_target, state.critic, cfg.algo.tau)
        # against the critic this update's step left; only the actor gets
        # gradients, zero for the unused logstd (AdamW still decays it, as optax does)
        params = list(state.actor.parameters())
        actor_loss = -torch.mean(state.critic.q_min(obs, self.act(state.actor, img, f("proprio"), pc)))
        grads = torch.autograd.grad(actor_loss, params, allow_unused=True, materialize_grads=True)
        base.optimizer_step(state.actor_opt, params, list(grads), cfg.algo.max_grad_norm)
        state.update_count += 1
        return critic_loss, actor_loss.detach()

    # ------------------------------------------------------------ eval hook

    def eval_actor_apply(self, actor: nn.Module, obs_n: torch.Tensor, env_state: VecEnvState) -> torch.Tensor:
        """tanh(mean) on the views rendered from ``env_state``."""
        return self.act(actor, *self.visual_obs(env_state))

    eval_actor_apply.needs_env_state = True
