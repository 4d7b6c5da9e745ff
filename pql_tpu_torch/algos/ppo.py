"""PPO on one device (port of pql_tpu/algos/ppo.py).

One iteration, as the JAX package orders it:

- rollout, ``horizon_len`` steps: obs-rms update, then normalize; the
  Gaussian policy's action (``mean + std · normal``, unclipped: it goes to
  ``env.step`` and into the trajectory as drawn, the tasks clip), its
  log-prob, and the critic's value (with ``value_norm`` the value-rms is
  updated with the raw value, then the value unnormalized); ``VecEnv.step``
  with auto-reset; episode statistics. The trajectory keeps the raw obs and
  ``dones[t]``, the done flag that *produced* obs[t];
- advantages: the bootstrap value of the last obs (value-rms updated with it,
  then unnormalized), GAE through timeouts (``ma_base.gae``); with
  ``value_norm`` the value-rms is updated with the returns, which are then
  normalized, then with the old values, which are then normalized;
- ``update_times`` epochs, each over one permutation of the H·E rows, in
  minibatches of ``batch_size``: obs normalized by the rms the rollout left,
  advantages whitened per minibatch (population std), one AdamW step of the
  clipped surrogate minus the entropy bonus, then one of the (clipped)
  value loss.

PPO has no warm-up. ``horizon_len · num_envs`` must be a multiple of
``batch_size``. Every random number of an iteration comes from
``draw_iteration``; ``train_iter`` takes such a dict (the parity tests hand
in the JAX package's draws) or draws from the state's ``torch.Generator``.
IPPO and MAPPO (``algos/ippo.py``, ``algos/mappo.py``) reuse this class's
skeleton.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from pql_tpu_torch.algos import base, ma_base
from pql_tpu_torch.envs import make_env
from pql_tpu_torch.envs.base import VecEnvState
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.utils.trackers import EpisodeStats


@dataclass
class PPOState:
    actor: nn.Module
    actor_opt: torch.optim.Optimizer
    critic: nn.Module
    critic_opt: torch.optim.Optimizer
    obs_rms: RunningMeanStd
    value_rms: RunningMeanStd
    env_state: VecEnvState
    obs: torch.Tensor
    dones: torch.Tensor  # [E] the done flag that produced obs
    stats: EpisodeStats
    gen: torch.Generator
    env_steps: int  # total env steps
    update_count: int


def critic_value(cfg, critic: nn.Module, obs_n: torch.Tensor, value_rms: RunningMeanStd) -> torch.Tensor:
    """V(obs_n) [B]; with ``value_norm`` the value-rms is updated with the raw
    value, which is returned unnormalized."""
    v = critic(obs_n)[..., 0]
    if cfg.algo.value_norm:
        value_rms.update(v[:, None])
        v = value_rms.unnormalize(v[:, None])[:, 0]
    return v


def value_targets(cfg, value_rms: RunningMeanStd, returns: torch.Tensor, values: torch.Tensor):
    """Flat (returns, old values) for the value loss; with ``value_norm`` the
    value-rms is updated with the returns, which are normalized, then with
    the values, which are normalized."""
    if not cfg.algo.value_norm:
        return ma_base.flat(returns), ma_base.flat(values)
    ret, val = returns.reshape(-1, 1), values.reshape(-1, 1)
    value_rms.update(ret)
    b_ret = value_rms.normalize(ret)[:, 0]
    value_rms.update(val)
    return b_ret, value_rms.normalize(val)[:, 0]


class PPO(base.ActorCriticAgent):
    name = "PPO"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.env = make_env(cfg)
        self.num_envs = cfg.num_envs
        self.obs_dim = self.env.obs_dim
        self.action_dim = self.env.action_dim
        self._check_batches()

    def _check_batches(self) -> None:
        rows = self.cfg.algo.horizon_len * self.num_envs
        if rows % self.cfg.algo.batch_size:
            raise ValueError(f"horizon_len*num_envs={rows} must be divisible by batch_size={self.cfg.algo.batch_size}")

    @property
    def rows(self) -> int:
        """Trajectory rows per iteration, which one epoch permutes."""
        return self.cfg.algo.horizon_len * self.num_envs

    # ---------------------------------------------------------------- init

    def _models(self, g: torch.Generator) -> dict:
        actor, critic, actor_opt, critic_opt = base.init_actor_critic(
            self.cfg, self.obs_dim, self.action_dim, g, self.device)
        return dict(actor=actor, actor_opt=actor_opt, critic=critic, critic_opt=critic_opt)

    def _state_cls(self):
        return PPOState

    def init(self, seed: int | None = None):
        """Fresh state. Params and the first env states are drawn on the CPU
        from ``seed``; the loop's generator lives on the device."""
        cfg, dev, E = self.cfg, self.device, self.num_envs
        seed = cfg.seed if seed is None else seed
        g_init = torch.Generator().manual_seed(seed)
        models = self._models(g_init)
        env_state, obs = self.env.reset(self.env.task.draw_reset(g_init, E).to(dev))
        return self._state_cls()(
            **models, obs_rms=RunningMeanStd((self.obs_dim,), device=dev), **self._value_norms(),
            env_state=env_state, obs=obs, dones=torch.zeros(E, device=dev),
            stats=base.make_stats(cfg, self.env, dev), gen=torch.Generator(device=dev).manual_seed(seed),
            env_steps=0, update_count=0,
        )

    def _value_norms(self) -> dict:
        return dict(value_rms=RunningMeanStd((1,), device=self.device))

    # --------------------------------------------------------------- draws

    def _action_normals(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        H, E, A = self.cfg.algo.horizon_len, self.num_envs, self.action_dim
        return {"action_normal": torch.randn(H, E, A, generator=gen, device=gen.device)}

    def draw_iteration(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        """Every random number of one iteration, drawn on ``gen``'s device and
        returned on the agent's: the policy's standard normals
        (``action_normal`` [H, E, A]); ``reset`` [H, E, k], the task's
        fresh-episode draws, and ``step`` [H, E, k] for a task with
        ``draw_step``; ``perm`` [update_times, rows], one permutation per epoch."""
        H, E = self.cfg.algo.horizon_len, self.num_envs
        task = self.env.task
        d = self._action_normals(gen)
        d["reset"] = torch.stack([task.draw_reset(gen, E) for _ in range(H)])
        if hasattr(task, "draw_step"):
            d["step"] = torch.stack([task.draw_step(gen, E) for _ in range(H)])
        d["perm"] = torch.stack([torch.randperm(self.rows, generator=gen, device=gen.device)
                                 for _ in range(self.cfg.algo.update_times)])
        return {k: v.to(self.device) for k, v in d.items()}

    # ----------------------------------------------------------- public API

    def train_iter(self, state, draws: dict | None = None):
        """One iteration: rollout, advantages, ``update_times`` epochs."""
        draws = self.draw_iteration(state.gen) if draws is None else draws
        traj = self._rollout(state, draws)
        data = self._advantages(state, traj)
        losses: dict[str, list] = {}
        first_update = state.update_count
        for e, perm in enumerate(draws["perm"]):
            mb = ma_base.epoch_minibatches(perm, data, self.cfg.algo.batch_size)
            for m in range(mb[0].shape[0]):
                batch = tuple(x[m] for x in mb) + self._minibatch_extra(draws, first_update, e, m)
                for k, v in self._minibatch_update(state, batch).items():
                    losses.setdefault(k, []).append(v)
                state.update_count += 1
        return state, {**ma_base.loss_metrics(losses), **state.stats.metrics()}

    def _minibatch_extra(self, draws: dict, first_update: int, epoch: int, index: int) -> tuple:
        """Inputs of minibatch ``index`` of ``epoch`` beside its rows, appended
        to the batch (EQSD's team draws, EQSD2's KL weight at the iteration's
        ``first_update``); none here."""
        return ()

    # -------------------------------------------------------------- rollout

    def _normalize(self, state, obs: torch.Tensor) -> torch.Tensor:
        return state.obs_rms.normalize(obs) if self.cfg.algo.obs_norm else obs

    def _observe(self, state, obs: torch.Tensor) -> torch.Tensor:
        """The rollout's obs-rms update, then the normalized obs."""
        if self.cfg.algo.obs_norm:
            state.obs_rms.update(obs)
        return self._normalize(state, obs)

    @torch.no_grad()
    def _rollout(self, state, draws: dict) -> dict[str, torch.Tensor]:
        """``horizon_len`` steps; moves the env state, obs, dones, the
        normalizers and the statistics in place; returns the trajectory
        stacked [H, E, ...]."""
        cfg = self.cfg
        traj: dict[str, list] = {}
        for t in range(cfg.algo.horizon_len):
            obs_n = self._observe(state, state.obs)
            action, record = self._act(state, obs_n, draws, t)
            step_draw = draws["step"][t] if "step" in draws else None
            state.env_state, next_obs, reward, done, info = self.env.step(state.env_state, action, draws["reset"][t],
                                                                          step_draw)
            self._record_step(state, record, reward, done, info)
            for k, v in record.items():
                traj.setdefault(k, []).append(v)
            state.obs, state.dones = next_obs, done
        state.env_steps += cfg.algo.horizon_len * self.num_envs
        return {k: torch.stack(v) for k, v in traj.items()}

    def _act(self, state, obs_n: torch.Tensor, draws: dict, t: int):
        """(the env's action, this step's record): obs, action, logp, value."""
        action, logp, _ = state.actor.sample(obs_n, draws["action_normal"][t])
        value = critic_value(self.cfg, state.critic, obs_n, state.value_rms)
        return action, dict(obs=state.obs, action=action, logp=logp, value=value)

    def _record_step(self, state, record: dict, reward: torch.Tensor, done: torch.Tensor, info: dict) -> None:
        """Episode statistics; the step's scaled reward, the done flag that
        produced its obs, and its timeouts into ``record``."""
        state.stats.update(reward, done, info)
        record.update(reward=self.cfg.algo.reward_scale * reward, dones=state.dones,
                      truncated=info["truncated"].float())

    # ----------------------------------------------------------- advantage

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """(obs_n, action, logp, adv, returns, values), flat [H·E, ...]; obs
        normalized by the rms the rollout left (elementwise, so before the
        minibatch gather as after it)."""
        cfg, f = self.cfg, ma_base.flat
        next_value = critic_value(cfg, state.critic, self._normalize(state, state.obs), state.value_rms)
        adv, ret = ma_base.gae(traj["reward"], traj["dones"], traj["value"], traj["truncated"], next_value,
                               state.dones, cfg.algo.gamma, cfg.algo.lambda_gae_adv, cfg.algo.use_gae)
        b_ret, b_val = value_targets(cfg, state.value_rms, ret, traj["value"])
        return (self._normalize(state, f(traj["obs"])), f(traj["action"]), f(traj["logp"]), f(adv), b_ret, b_val)

    # -------------------------------------------------------------- update

    def _losses(self, actor, critic, obs_n, critic_obs, actions, logp_old, adv, returns, v_old):
        """(actor loss, critic loss) of one minibatch; the actor reads
        ``obs_n`` (a tuple: its several inputs, the visual agents' views), the
        critic ``critic_obs``."""
        cfg = self.cfg
        adv = ma_base.normalize_advantages(adv)
        logp_new, entropy = actor.logprob_entropy(*(obs_n if isinstance(obs_n, tuple) else (obs_n,)), actions)
        a_loss = ma_base.ppo_actor_loss(logp_new, logp_old, adv, entropy, cfg.algo.ratio_clip, cfg.algo.lambda_entropy)
        c_loss = ma_base.ppo_value_loss(critic(critic_obs)[..., 0], returns, v_old, cfg.algo.ratio_clip,
                                        cfg.algo.value_clip)
        return a_loss, c_loss

    def _minibatch_update(self, state, batch: tuple) -> dict:
        obs_n, *rest = batch
        return self._step_actor_critic(state, *self._losses(state.actor, state.critic, obs_n, obs_n, *rest))

    def _step_actor_critic(self, state, a_loss, c_loss) -> dict:
        """One AdamW step of the actor, then one of the critic."""
        g = self.cfg.algo.max_grad_norm
        return {"actor": base.descend(state.actor_opt, list(state.actor.parameters()), a_loss, g),
                "critic": base.descend(state.critic_opt, list(state.critic.parameters()), c_loss, g)}

    # ------------------------------------------------------------ eval hook

    @staticmethod
    def eval_actor_apply(actor: nn.Module, obs_n: torch.Tensor) -> torch.Tensor:
        """The policy's mean."""
        return actor(obs_n)[0]
