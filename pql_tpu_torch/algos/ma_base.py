"""What the PPO family shares, and the two-agent machinery (port of
pql_tpu/algos/ma_base.py:30-191).

- ``MultiAgentCtx``: a task's ``MultiAgentSpec`` bound to a
  ``SymmetryManager``, with the per-hand model builders and the C2 rep
  generators of the task's ``EquivarianceSpec``;
- ``NetsDictAgent``: what the loop takes from a state whose networks sit in
  one ``nn.ModuleDict`` (IPPO, QTOT, IDDPG, the team agents, the EQ
  family), and the step of each network on its own loss;
- ``gae``: GAE with the timeout XOR mask, or plain discounted returns;
- ``normalize_advantages``, ``ppo_actor_loss``, ``ppo_value_loss``: the
  per-minibatch whitening (population std) and the clipped losses;
- ``epoch_minibatches``, ``flat``, ``loss_metrics``.

The C2 rep helpers ``sign_rep``, ``perm_sign_rep`` and ``concat_reps``
come from ``models/emlp.py``. ``make_actor`` / ``make_critic`` build an
``Equivariant`` class from the task's reps (pql_tpu/algos/ma_base.py:82-96):
an actor on ``obs_gen(side)`` → ``act_gen()``, a critic on ``obs_gen(side)``
or, ``central``, ``joint_obs_gen()``; ``DoubleQEquivariant`` on the obs and
action reps.
"""

from __future__ import annotations

import torch
from torch import nn

from pql_tpu_torch.algos.base import build_optimizer, compute_dtype, descend
from pql_tpu_torch.envs.base import VecEnv
from pql_tpu_torch.models import get_model
from pql_tpu_torch.models.emlp import concat_reps, perm_sign_rep, sign_rep
from pql_tpu_torch.utils.symmetry import EquivarianceSpec, MultiAgentSpec, SymmetryManager


class NetsDictAgent:
    """The eval hook and the best-model snapshot of a state that keeps its
    networks in one ``nn.ModuleDict`` ``nets``, as the JAX package's params
    dict: the eval hook takes all of them and picks the actors; the
    snapshot's actor is all of them, its critic the critics (and IDDPG's
    targets; scripts/train.py:248-258). Listed before the agent's base class."""

    @staticmethod
    def eval_params(state) -> nn.ModuleDict:
        return state.nets

    @staticmethod
    def snapshot_parts(state) -> tuple[nn.ModuleDict, nn.ModuleDict]:
        return state.nets, nn.ModuleDict({k: m for k, m in state.nets.items() if k.startswith("critic")})

    def _build(self, nets: dict) -> dict:
        """The networks as one ``nn.ModuleDict`` on the agent's device, and an
        AdamW each (the actor or critic learning rate by name)."""
        nets = nn.ModuleDict(nets).to(self.device)
        algo = self.cfg.algo
        opts = {k: build_optimizer(m, algo.actor_lr if k.startswith("actor") else algo.critic_lr)
                for k, m in nets.items()}
        return dict(nets=nets, opts=opts)

    def _step_all(self, state, losses: dict) -> dict:
        """One AdamW step of each network on its loss, in the dict's order;
        returns the detached losses."""
        g = self.cfg.algo.max_grad_norm
        return {k: descend(state.opts[k], list(state.nets[k].parameters()), loss, g) for k, loss in losses.items()}


class MultiAgentCtx:
    """A two-agent task's spec and manager, and its per-hand models."""

    def __init__(self, env: VecEnv, symmetric_envs: bool | None = None):
        spec: MultiAgentSpec | None = env.multi
        if spec is None:
            raise ValueError(f"Task '{type(env.task).__name__}' has no MultiAgentSpec; multi-agent algorithms "
                             "need a bimanual task (e.g. task=BimanualReacher)")
        if symmetric_envs is None:
            symmetric_envs = bool(getattr(env.task, "symmetric", False))
        self.spec = spec
        self.manager = SymmetryManager(spec, symmetric_envs)
        self.obs_dims = spec.single_agent_obs_dim
        self.action_dim = spec.single_agent_action_dim
        self.shared_obs_dim = spec.shared_obs_dim
        self.eq: EquivarianceSpec | None = getattr(env.task, "equivariance", None)

    def _require_eq(self) -> EquivarianceSpec:
        if self.eq is None:
            raise ValueError("this task provides no EquivarianceSpec")
        return self.eq

    def obs_gen(self, side: int) -> tuple:
        eq = self._require_eq()
        if eq.obs_perms is not None:
            return perm_sign_rep(eq.obs_perms[side], eq.obs_signs[side])
        return sign_rep(eq.obs_signs[side])

    def act_gen(self) -> tuple:
        eq = self._require_eq()
        return perm_sign_rep(eq.act_perm, eq.act_signs) if eq.act_perm is not None else sign_rep(eq.act_signs)

    def joint_obs_gen(self) -> tuple:
        """The rep on the joint obs: right block ⊕ left block."""
        return concat_reps(self.obs_gen(0), self.obs_gen(1))

    def make_actor(self, cfg, gen: torch.Generator, side: int = 0):
        cls, dtype = get_model(cfg.algo.act_class), compute_dtype(cfg)
        if "Equivariant" in cfg.algo.act_class:
            return cls(gen_in=self.obs_gen(side), gen_out=self.act_gen(), gen=gen, dtype=dtype)
        return cls(self.obs_dims[side], self.action_dim, gen=gen, dtype=dtype)

    def make_critic(self, cfg, gen: torch.Generator, side: int = 0, central: bool = False):
        """A state-value critic on one hand's view, or on the joint obs (``central``)."""
        cls, dtype = get_model(cfg.algo.cri_class), compute_dtype(cfg)
        if "Equivariant" in cfg.algo.cri_class:
            rep = self.joint_obs_gen() if central else self.obs_gen(side)
            if cfg.algo.cri_class == "DoubleQEquivariant":
                return cls(gen_obs=rep, gen_act=self.act_gen(), gen=gen, dtype=dtype)
            return cls(gen_in=rep, gen=gen, dtype=dtype)
        return cls(self.shared_obs_dim if central else self.obs_dims[side], gen=gen, dtype=dtype)

    def split_obs(self, obs, tracker):
        return self.manager.get_multi_agent_obs(obs, tracker)

    def merge_actions(self, act_right, act_left, tracker):
        return self.manager.get_execute_action(act_right, act_left, tracker)

    def split_reward(self, info, tracker):
        return self.manager.get_multi_agent_rew(info["detailed_reward"], tracker)


@torch.no_grad()
def gae(rewards, dones, values, truncated, next_value, next_done, gamma: float, lam: float, use_gae: bool = True):
    """(advantages, returns), both [T, B]. ``dones[t]`` is the done flag that
    produced obs[t]; a reverse loop over t carries (lastgaelam, next value,
    1 − done[t+1]) from (0, next_value, 1 − next_done). The bootstrap is
    masked by XOR(1 − done[t+1], truncated[t]), so it runs through a
    timeout. Without ``use_gae``, plain discounted returns."""
    out = torch.empty_like(rewards)
    lastgaelam, nextvalues, nextnonterminal = torch.zeros_like(next_value), next_value, 1.0 - next_done
    for t in reversed(range(rewards.shape[0])):
        if use_gae:
            nextnonterminal2 = ((nextnonterminal > 0.5) ^ (truncated[t] > 0.5)).float()
            delta = rewards[t] + gamma * nextvalues * nextnonterminal2 - values[t]
            lastgaelam = delta + gamma * lam * nextnonterminal * lastgaelam
            nextvalues = values[t]
        else:
            lastgaelam = nextvalues = rewards[t] + gamma * nextnonterminal * nextvalues
        out[t] = lastgaelam
        nextnonterminal = 1.0 - dones[t]
    if use_gae:
        return out, out + values
    return out - values, out


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    """Whitened by the population std (ddof 0, as ``jnp.std``)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def ppo_actor_loss(logp_new, logp_old, adv, entropy, ratio_clip: float, lambda_entropy: float):
    """The clipped-ratio surrogate minus the entropy bonus."""
    ratio = torch.exp(logp_new - logp_old)
    l1 = -adv * ratio
    l2 = -adv * torch.clamp(ratio, 1.0 - ratio_clip, 1.0 + ratio_clip)
    return torch.mean(torch.maximum(l1, l2)) - lambda_entropy * torch.mean(entropy)


def ppo_value_loss(v_new, returns, v_old, ratio_clip: float, value_clip: bool):
    """½ MSE to the returns; with ``value_clip`` the max of it and the loss of
    the value moved at most ``ratio_clip`` from the old one."""
    unclipped = torch.square(v_new - returns)
    if value_clip:
        v_clipped = v_old + torch.clamp(v_new - v_old, -ratio_clip, ratio_clip)
        return 0.5 * torch.mean(torch.maximum(unclipped, torch.square(v_clipped - returns)))
    return 0.5 * torch.mean(unclipped)


def epoch_minibatches(perm: torch.Tensor, data: tuple, batch_size: int) -> tuple:
    """Each tensor of ``data`` [N, ...] shuffled by ``perm`` and cut into
    [N // batch_size, batch_size, ...] (a remainder is dropped)."""
    n_mb = data[0].shape[0] // batch_size
    idx = perm[: n_mb * batch_size]
    return tuple(x[idx].reshape((n_mb, batch_size) + x.shape[1:]) for x in data)


def flat(x: torch.Tensor) -> torch.Tensor:
    """[T, B, ...] → [T·B, ...]."""
    return x.reshape((-1,) + x.shape[2:])


def loss_metrics(losses: dict) -> dict:
    """Mean of each loss list, named as the reference: 'actor' →
    'train/actor_loss', 'actor_left' → 'train/actor_loss_left'."""
    out = {}
    for k, v in losses.items():
        head, _, tail = k.partition("_")
        out[f"train/{head}_loss" + (f"_{tail}" if tail else "")] = torch.stack(v).mean()
    return out
