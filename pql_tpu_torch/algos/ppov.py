"""The visual PPO agents on one device (port of pql_tpu/algos/ppov.py:57-434).

- **PPOV**: PPO whose actor, ``DiagGaussianMLPVPolicy`` (feature and hidden
  width 256), reads the task's rendered views: the camera frames through
  ``ResEncoder`` on a task with ``render`` (``encoder_type=None`` without
  one), and proprio + point cloud through the point-state ``Encoder``; the
  critic, ``algo.cri_class``, reads the privileged flat obs. The trajectory
  keeps the views, and the update recomputes the actor's features from
  them. No value normalization, as the JAX agent (its state has no
  value-rms). ``algo.encoder_weights`` merges a local weight file into the
  fresh actor (``models/pretrained.py``) and fails when it matches nothing.
- **IPPOV**: IPPO with per-hand actors on (that hand's proprio, the shared
  cloud), no camera, and per-hand critics on the privileged views: always
  four networks (the JAX agent has no ``same_policy``), IPPO's state, and
  IPPO's reward routing; no value normalization. The right actor reads
  proprio row 0 and the left row 1, whatever the mirrored-episode tracker.

Both refuse a task without ``proprio`` and ``pointcloud``. Every draw of an
iteration comes from ``draw_iteration`` (PPO's, IPPO's). The eval hooks
take the eval env's state (``needs_env_state``), which they render from.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from pql_tpu_torch.algos import base, ma_base
from pql_tpu_torch.algos.ippo import IPPO
from pql_tpu_torch.algos.ppo import PPO
from pql_tpu_torch.envs.base import VecEnv, VecEnvState
from pql_tpu_torch.models.pretrained import merge_pretrained
from pql_tpu_torch.models.visual import DiagGaussianMLPVPolicy
from pql_tpu_torch.ops.running_norm import RunningMeanStd
from pql_tpu_torch.utils.trackers import EpisodeStats

FEATURE_DIM = HIDDEN_DIM = 256  # the JAX agents' actor widths (ppov.py:73-74)


@dataclass
class PPOVState:
    actor: nn.Module
    actor_opt: torch.optim.Optimizer
    critic: nn.Module
    critic_opt: torch.optim.Optimizer
    obs_rms: RunningMeanStd  # of the privileged obs
    env_state: VecEnvState
    obs: torch.Tensor
    dones: torch.Tensor
    stats: EpisodeStats
    gen: torch.Generator
    env_steps: int
    update_count: int


def require_visual(env: VecEnv, name: str) -> None:
    for attr in ("proprio", "pointcloud"):
        if not hasattr(env.task, attr):
            raise ValueError(f"{name} needs a vision task exposing proprio/pointcloud (e.g. task=ReacherVision); "
                             f"got {type(env.task).__name__}")


def visual_actor(cfg, task, act_dim: int, gen: torch.Generator, camera: bool) -> DiagGaussianMLPVPolicy:
    """The visual Gaussian policy on the task's proprio and cloud, and its
    camera with ``camera``."""
    spec = task.visual_spec
    return DiagGaussianMLPVPolicy(
        task.proprio_dim, act_dim, img_shape=spec["img"] if camera else None, feature_dim=FEATURE_DIM,
        hidden_dim=HIDDEN_DIM, encoder_type="resnet" if camera else None, pc_dim=spec["pc"][-1], gen=gen,
        dtype=base.compute_dtype(cfg))


class PPOV(PPO):
    name = "PPOV"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        require_visual(self.env, self.name)
        self.has_camera = hasattr(self.env.task, "render")

    def _models(self, g: torch.Generator) -> dict:
        cfg = self.cfg
        actor = visual_actor(cfg, self.env.task, self.action_dim, g, self.has_camera)
        if cfg.algo.encoder_weights:
            report = merge_pretrained(actor, cfg.algo.encoder_weights)
            if not report["loaded"]:
                raise ValueError(f"encoder_weights={cfg.algo.encoder_weights} matched no params: {report}")
        critic = base.build_critic(cfg, self.obs_dim, self.action_dim, g)
        actor, critic = actor.to(self.device), critic.to(self.device)
        return dict(actor=actor, actor_opt=base.build_optimizer(actor, cfg.algo.actor_lr), critic=critic,
                    critic_opt=base.build_optimizer(critic, cfg.algo.critic_lr))

    def _state_cls(self):
        return PPOVState

    def _value_norms(self) -> dict:
        return {}

    def visual_obs(self, env_state: VecEnvState):
        """(img or None, proprio, pc) rendered from the physics state."""
        task = self.env.task
        img = task.render(env_state.state) if self.has_camera else None
        return img, task.proprio(env_state.state), task.pointcloud(env_state.state)

    def _act(self, state, obs_n, draws: dict, t: int):
        img, proprio, pc = self.visual_obs(state.env_state)
        action, logp, _ = state.actor.sample(img, proprio, pc, draws["action_normal"][t])
        record = dict(obs=state.obs, proprio=proprio, pc=pc, action=action, logp=logp,
                      value=state.critic(obs_n)[..., 0])
        if img is not None:
            record["img"] = img
        return action, record

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """(obs_n, proprio, pc, action, logp, adv, returns, values[, img]), flat [H·E, ...]."""
        cfg, f = self.cfg, ma_base.flat
        next_value = state.critic(self._normalize(state, state.obs))[..., 0]
        adv, ret = ma_base.gae(traj["reward"], traj["dones"], traj["value"], traj["truncated"], next_value,
                               state.dones, cfg.algo.gamma, cfg.algo.lambda_gae_adv, cfg.algo.use_gae)
        data = (self._normalize(state, f(traj["obs"])), f(traj["proprio"]), f(traj["pc"]), f(traj["action"]),
                f(traj["logp"]), f(adv), f(ret), f(traj["value"]))
        return data + ((f(traj["img"]),) if self.has_camera else ())

    def _minibatch_update(self, state, batch: tuple) -> dict:
        obs_n, proprio, pc, *rest = batch[:8]
        views = (batch[8] if self.has_camera else None, proprio, pc)
        return self._step_actor_critic(state, *self._losses(state.actor, state.critic, views, obs_n, *rest))

    def eval_actor_apply(self, actor: nn.Module, obs_n: torch.Tensor, env_state: VecEnvState) -> torch.Tensor:
        """The policy's mean on the views rendered from ``env_state``."""
        return actor(*self.visual_obs(env_state))[0]

    eval_actor_apply.needs_env_state = True


class IPPOV(IPPO):
    name = "IPPOV"

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device)
        require_visual(self.env, self.name)
        self.same_policy = False

    def _nets(self, g: torch.Generator) -> dict:
        cfg, ma, task = self.cfg, self.ma, self.env.task
        return {"actor": visual_actor(cfg, task, ma.action_dim, g, False),
                "actor_left": visual_actor(cfg, task, ma.action_dim, g, False),
                "critic": ma.make_critic(cfg, g, 0), "critic_left": ma.make_critic(cfg, g, 1)}

    def visual_obs(self, env_state: VecEnvState):
        """(proprio [E, 2, d], pc [E, N, 3])."""
        task = self.env.task
        return task.proprio(env_state.state), task.pointcloud(env_state.state)

    def _act(self, state, obs_n, draws: dict, t: int):
        nets = state.nets
        tracker = self.env.symmetry_tracker(state.env_state)
        ob_r, ob_l = self.ma.split_obs(obs_n, tracker)
        proprio, pc = self.visual_obs(state.env_state)
        act_r, logp_r, _ = nets["actor"].sample(None, proprio[:, 0], pc, draws["action_normal"][t])
        act_l, logp_l, _ = nets["actor_left"].sample(None, proprio[:, 1], pc, draws["action_normal_left"][t])
        record = dict(obs_r=ob_r, obs_l=ob_l, proprio=proprio, pc=pc, act_r=act_r, act_l=act_l, logp_r=logp_r,
                      logp_l=logp_l, val_r=nets["critic"](ob_r)[..., 0], val_l=nets["critic_left"](ob_l)[..., 0],
                      tracker=tracker)
        return self.ma.merge_actions(act_r, act_l, tracker), record

    @torch.no_grad()
    def _advantages(self, state, traj: dict) -> tuple:
        """Per hand (obs, proprio, action, logp, adv, returns, values), the
        right hand's then the left's, and the shared cloud, flat [H·E, ...]."""
        cfg, f = self.cfg, ma_base.flat
        last = self.ma.split_obs(self._normalize(state, state.obs), self.env.symmetry_tracker(state.env_state))
        data = ()
        for i, (s, ob, critic) in enumerate((("r", last[0], "critic"), ("l", last[1], "critic_left"))):
            next_value = state.nets[critic](ob)[..., 0]
            adv, ret = ma_base.gae(traj[f"rew_{s}"], traj["dones"], traj[f"val_{s}"], traj["truncated"], next_value,
                                   state.dones, cfg.algo.gamma, cfg.algo.lambda_gae_adv, cfg.algo.use_gae)
            data += (f(traj[f"obs_{s}"]), f(traj["proprio"][:, :, i]), f(traj[f"act_{s}"]), f(traj[f"logp_{s}"]),
                     f(adv), f(ret), f(traj[f"val_{s}"]))
        return data + (f(traj["pc"]),)

    def _minibatch_losses(self, state, batch: tuple) -> dict:
        nets, pc, losses = state.nets, batch[-1], {}
        for side, (ob, proprio, *rest) in (("", batch[:7]), ("_left", batch[7:14])):
            losses[f"actor{side}"], losses[f"critic{side}"] = self._losses(
                nets[f"actor{side}"], nets[f"critic{side}"], (None, proprio, pc), ob, *rest)
        return losses

    def eval_actor_apply(self, nets: nn.ModuleDict, obs_n: torch.Tensor, env_state: VecEnvState) -> torch.Tensor:
        """Each hand's policy mean on its views, merged without mirroring."""
        proprio, pc = self.visual_obs(env_state)
        return self.ma.merge_actions(nets["actor"](None, proprio[:, 0], pc)[0],
                                     nets["actor_left"](None, proprio[:, 1], pc)[0], None)

    eval_actor_apply.needs_env_state = True
