"""N-step transition staging (port of pql_tpu/replay/nstep.py).

Depth-n FIFO over the env axis, oldest first. For each env, over the
window: obs/action from the oldest entry, reward = Σ_{i≤k} γ^i·r_i with k
the first done (or n-1), next_obs at step k, done if any step was done
(reference nstep_replay.py:74-92). With nstep == 1 a push is a
passthrough. Emissions while the FIFO fills are flagged invalid; PQL
ignores the flag and relies on the replay's ``valid_start`` watermark.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

FIELDS = ("obs", "action", "reward", "next_obs", "done")


@dataclass
class NStepState:
    obs: torch.Tensor  # [n, E, obs_dim]
    action: torch.Tensor  # [n, E, act_dim]
    reward: torch.Tensor  # [n, E, C]: C reward channels (IDDPG's two hands), one by default
    next_obs: torch.Tensor  # [n, E, obs_dim]
    done: torch.Tensor  # [n, E, 1]
    count: int  # total pushes so far
    nstep: int
    gamma: float


def create_nstep(num_envs, obs_dim, action_dim, nstep=3, gamma=0.99, device="cuda", reward_dim=1) -> NStepState:
    """``reward_dim`` channels are discounted alike, each on its own; the
    done flag stays one column (nstep.py:41-60)."""
    z = lambda d: torch.zeros(nstep, num_envs, d, dtype=torch.float32, device=device)  # noqa: E731
    return NStepState(
        obs=z(obs_dim), action=z(action_dim), reward=z(reward_dim), next_obs=z(obs_dim), done=z(1),
        count=0, nstep=nstep, gamma=gamma,
    )


def nstep_return(state: NStepState):
    """The n-step reduction over the current window."""
    n = state.nstep
    dones = state.done[..., 0] > 0.5  # [n, E]
    any_done = dones.any(dim=0)
    first_done = torch.argmax(dones.to(torch.int8), dim=0)  # first True; 0 when none
    k = torch.where(any_done, first_done, torch.full_like(first_done, n - 1))
    steps = torch.arange(n, device=k.device)[:, None, None]
    mask = (steps <= k[None, :, None]).to(state.reward.dtype)  # [n, E, 1]
    gammas = torch.pow(
        state.gamma, torch.arange(n, dtype=state.reward.dtype, device=k.device)
    )[:, None, None]
    reward = torch.sum(state.reward * gammas * mask, dim=0)  # [E, C]
    idx = k[None, :, None].expand(1, -1, state.next_obs.shape[-1])
    next_obs = torch.gather(state.next_obs, 0, idx)[0]
    done = torch.maximum(state.done[-1], any_done[:, None].to(state.done.dtype))
    return reward, next_obs, done


def nstep_push(state: NStepState, obs, action, reward, next_obs, done):
    """Push one env-step; emit the n-step transition of the oldest entry.
    Returns (state, out dict, valid)."""
    reward = reward.reshape(reward.shape[0], -1)
    done = done.reshape(done.shape[0], 1).float()
    if state.nstep == 1:
        state.count += 1
        return state, dict(obs=obs, action=action, reward=reward, next_obs=next_obs, done=done), True
    new = dict(obs=obs, action=action, reward=reward, next_obs=next_obs, done=done)
    for name in FIELDS:
        buf = getattr(state, name)
        setattr(state, name, torch.cat([buf[1:], new[name][None]], dim=0))
    state.count += 1
    n_reward, n_next_obs, n_done = nstep_return(state)
    out = dict(obs=state.obs[0], action=state.action[0], reward=n_reward, next_obs=n_next_obs, done=n_done)
    return state, out, state.count >= state.nstep


def nstep_scan(state: NStepState, traj: dict[str, list[torch.Tensor]]):
    """Push T steps (``traj[field][t]`` is [E, ...]); returns the state, the
    emissions stacked [T, E, ...] and the per-step validity flags."""
    outs, valids = {k: [] for k in FIELDS}, []
    for t in range(len(traj["obs"])):
        state, out, valid = nstep_push(state, *(traj[k][t] for k in FIELDS))
        for k in FIELDS:
            outs[k].append(out[k])
        valids.append(valid)
    return state, {k: torch.stack(v) for k, v in outs.items()}, valids
