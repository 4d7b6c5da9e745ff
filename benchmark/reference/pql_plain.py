"""PQL's first iterations, recorded from the program and followed by a
plain reference (PQL with a Double-Q critic; supersglzc/pql
``pql/algo/pql_actor.py``, ``pql_p_learner.py``, ``pql_v_learner.py``).

What the recorder keeps of the program's set-up (all copied to the host):

- the draws of the warm-up and of each followed iteration, as the agent's
  ``draw_iteration`` returned them (the random numbers: uniform actions,
  exploration and smoothing normals, reset and goal draws, raw slot draws
  and env indices);
- every env step: the action the program sent, and what the env answered
  (next obs, reward, done, truncation, success);
- the losses of each followed iteration, each optimizer's first gradient
  (from its state after its first step), and the parameters after the last.

The reference starts from the benchmark's weights and the same draws, and
works out again what the program's own state held: the running obs
moments, the actions, the n-step staging, the replay ring and the rows each
update samples, the targets, losses, gradients, AdamW and polyak steps. It
takes the env's answers as inputs; each configuration's own file judges
those answers, and starts the envs (``reset_envs``), in its task's terms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import plain, recording

FAULTS = ("half_batch", "frozen_step", "reward_altered", "frozen_env")


def networks(state) -> dict:
    return {"actor": state.actor, "critic": state.critic}


@torch.no_grad()
def load_weights(state, w: dict) -> None:
    """The critic's weights into the target too (a fresh target equals its critic)."""
    for name, t in state.critic_target.named_parameters():
        t.copy_(w[f"critic.{name}"])


def env_steps_per_iter(cfg) -> int:
    return cfg.num_envs * cfg.algo.horizon_len


class Recorder:
    """Wraps the agent's ``draw_iteration``, its env's ``step`` and its
    optimizers' ``step`` until ``close``."""

    def __init__(self, agent, state):
        self.agent = agent
        self.data = {"obs0": state.obs.clone(), "draws": [], "steps": [], "losses": []}
        self.first = recording.FirstSteps({"actor": (state.actor_opt, state.actor),
                                           "critic": (state.critic_opt, state.critic)})
        draw, step = agent.draw_iteration, agent.env.step

        def recorded_draw(gen, random=False):
            d = draw(gen, random)
            self.data["draws"].append({k: v.clone() for k, v in d.items()})
            return d

        def recorded_step(s, action, reset_draw, step_draw=None):
            out = step(s, action, reset_draw, step_draw)
            _, obs, reward, done, info = out
            self.data["steps"].append(dict(action=action.clone(), next_obs=obs.clone(), reward=reward.clone(),
                                           done=done.clone(), truncated=info["truncated"].float(),
                                           success=info.get("success", torch.zeros_like(reward)).clone()))
            return out

        agent.draw_iteration, agent.env.step = recorded_draw, recorded_step

    def after_iter(self, i: int, state, metrics: dict) -> None:
        self.data["losses"].append((metrics["train/critic_loss"].clone(), metrics["train/actor_loss"].clone()))
        self.data["params"] = recording.params({"actor": state.actor, "critic": state.critic,
                                                "target": state.critic_target})

    def close(self) -> None:
        del self.agent.draw_iteration, self.agent.env.step
        self.data["g1"] = self.first.close()
        self.data = recording.host(self.data)
        self.data["losses"] = [(float(c), float(a)) for c, a in self.data["losses"]]


def install_spans(agent, state, record_function):
    """``_sim_phase`` as env; the n-step scan and the ring write as replay;
    the critic and actor phases as learner. Returns (the ranges' names, the
    undo)."""
    import pql_tpu_torch.algos.pql as pql_module

    def wrap(fn, name):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    scan, add = pql_module.nstep_scan, state.replay.add
    agent._sim_phase = wrap(agent._sim_phase, "env.sim")
    agent._critic_phase = wrap(agent._critic_phase, "learner.critic")
    agent._actor_phase = wrap(agent._actor_phase, "learner.actor")
    pql_module.nstep_scan = wrap(scan, "replay.nstep")
    state.replay.add = wrap(add, "replay.add")

    def undo():
        del agent._sim_phase, agent._critic_phase, agent._actor_phase, state.replay.add
        pql_module.nstep_scan = scan
    return ("env.sim", "learner.critic", "learner.actor", "replay.nstep", "replay.add"), undo


# ------------------------------------------------------------- reference


def hyper(config: dict, traffic: dict) -> dict:
    a = {**config["args"], **traffic["args"]}
    return dict(E=int(a["num_envs"]), H=int(a["algo.horizon_len"]), B=int(a["algo.batch_size"]),
                n_critic=int(a["algo.critic_sample_ratio"]) * int(a["algo.horizon_len"]),
                n_actor=max(int(a["algo.critic_sample_ratio"]) // int(a["algo.critic_actor_ratio"]), 1)
                * int(a["algo.horizon_len"]),
                memory=int(a["algo.memory_size"]), nstep=int(a["algo.nstep"]), gamma=float(a["algo.gamma"]),
                tau=float(a["algo.tau"]), actor_lr=float(a["algo.actor_lr"]), critic_lr=float(a["algo.critic_lr"]),
                max_norm=a["algo.max_grad_norm"], reward_scale=float(a["algo.reward_scale"]),
                std_max=float(a["algo.noise.std_max"]), std_min=float(a["algo.noise.std_min"]),
                tgt_std=float(a["algo.noise.tgt_pol_std"]), tgt_bound=float(a["algo.noise.tgt_pol_noise_bound"]),
                warm_up=int(a["algo.warm_up"]))


class Ring:
    """The replay ring as PQL defines it: ``memory // E`` slots (rounded to
    the write length) of E rows; while the n-step FIFO fills, its first
    nstep − 1 slots are not sampled; a raw slot draw r maps to
    valid_start + r mod (filled − valid_start)."""

    def __init__(self, hp: dict):
        self.slots = max((max(hp["memory"] // hp["E"], 1) // hp["H"]) * hp["H"], hp["H"])
        self.valid_start0 = hp["nstep"] - 1
        self.rows = []  # written slots in order: [E, D]
        self.writes = 0

    def add(self, row: torch.Tensor) -> None:
        if self.writes >= self.slots:
            raise ValueError("the followed iterations do not wrap the ring")
        self.rows.append(row)
        self.writes += 1

    def sample(self, raw_slot: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
        lo = 0 if self.writes > self.slots else self.valid_start0
        span = max(min(self.writes, self.slots) - lo, 1)
        slot = lo + torch.remainder(raw_slot, span)
        return torch.stack(self.rows)[slot, env]


class NStep:
    """Depth-n staging per env: obs/action of the oldest step, Σ γ^i r_i up
    to the first done (or n − 1), next_obs at that step, done if any."""

    def __init__(self, hp: dict):
        self.n, self.gamma, self.buf = hp["nstep"], hp["gamma"], []

    def push(self, obs, action, reward, next_obs, done):
        self.buf = (self.buf + [(obs, action, reward, next_obs, done)])[-self.n:]
        while len(self.buf) < self.n:  # the zero-filled FIFO of the first pushes
            z = tuple(torch.zeros_like(x) for x in self.buf[-1])
            self.buf = [z] + self.buf
        ret = torch.zeros_like(reward)
        alive = torch.ones_like(done)
        next_o, any_done = self.buf[-1][3].clone(), torch.zeros_like(done)
        for i, (_, _, r, no, d) in enumerate(self.buf):
            ret = ret + alive * (self.gamma ** i) * r
            first = alive * d  # this step ends the window
            next_o = torch.where((first > 0.5) | ((alive > 0.5) & (i == self.n - 1)), no, next_o)
            any_done = torch.maximum(any_done, d)
            alive = alive * (1.0 - d)
        return self.buf[0][0], self.buf[0][1], ret, next_o, torch.maximum(self.buf[-1][4], any_done)


def actor_forward(w: dict, obs_n: torch.Tensor) -> torch.Tensor:
    return torch.tanh(plain.mlp(plain.sub(w, "actor.net"), obs_n))


def follow(rec: dict, weights: dict, hp: dict, device, fault: str | None = None) -> dict:
    """Run the warm-up and the followed iterations; returns what the program
    is judged on: per-step actions, losses, first moments, final params."""
    E, H = hp["E"], hp["H"]
    w = {k: v.detach().to(device).clone() for k, v in weights.items()}
    actor = plain.sub(w, "actor")
    critic = plain.sub(w, "critic")
    target = {k: v.clone() for k, v in critic.items()}
    for p in (*actor.values(), *critic.values()):
        p.requires_grad_(True)
    opt_a = plain.AdamW(actor, hp["actor_lr"], hp["max_norm"])
    opt_c = plain.AdamW(critic, hp["critic_lr"], hp["max_norm"])
    rms = plain.RunningMoments(rec["obs0"].shape[1], device)
    ring, nstep = Ring(hp), NStep(hp)
    steps = [{k: v.to(device) for k, v in s.items()} for s in rec["steps"]]
    draws = [{k: v.to(device) for k, v in d.items()} for d in rec["draws"]]
    obs = rec["obs0"].to(device)
    out = {"actions": [], "losses": []}
    at = 0

    def sim(count: int, d: dict, random: bool):
        nonlocal obs, at
        for t in range(count):
            s = steps[at]
            rms.update(obs)
            with torch.no_grad():
                if random:
                    action = d["action_uniform"][t]
                else:
                    action = plain.mixed_noise_action(actor_forward({"actor." + k: v for k, v in actor.items()},
                                                                    rms.normalize(obs)),
                                                      d["explore_normal"][t], hp["std_min"], hp["std_max"])
            out["actions"].append(action)
            reward = s["reward"] * (1.1 if fault == "reward_altered" else 1.0)
            done_b = s["done"] * (1.0 - s["truncated"])
            row = nstep.push(obs, action, hp["reward_scale"] * reward[:, None], s["next_obs"], done_b[:, None])
            ring.add(torch.cat(row, -1))
            obs = s["next_obs"]
            at += 1

    def fields(rows):
        d, a = obs.shape[1], steps[0]["action"].shape[1]
        return (rows[:, :d], rows[:, d:d + a], rows[:, d + a:d + a + 1], rows[:, d + a + 1:2 * d + a + 1],
                rows[:, 2 * d + a + 1:])

    def batch(slot, env):
        if slot.shape[-1] != hp["B"] or env.shape[-1] != hp["B"]:
            raise ValueError(f"the program drew {slot.shape[-1]} rows for a batch of {hp['B']}")
        if fault == "half_batch":
            slot, env = slot[: slot.shape[0] // 2], env[: env.shape[0] // 2]
        return ring.sample(slot, env)

    sim(hp["warm_up"], draws[0], True)
    gamma_n = hp["gamma"] ** hp["nstep"]
    for it in range(1, len(draws)):
        d = draws[it]
        sim(H, d, False)
        frozen = {k: v.detach().clone() for k, v in target.items()}
        c_losses = []
        for u in range(hp["n_critic"]):
            o, a, r, no, dn = fields(batch(d["critic_slot"][u], d["critic_env"][u]))
            o_n, no_n = rms.normalize_clip(o), rms.normalize_clip(no)
            with torch.no_grad():
                na = plain.smoothed_target_action(actor_forward({"actor." + k: v for k, v in actor.items()}, no_n),
                                                  d["target_normal"][u][: no.shape[0]], hp["tgt_std"],
                                                  hp["tgt_bound"])
                y = r + (1.0 - dn) * gamma_n * plain.q_min(frozen, no_n, na)
            q1, q2 = plain.double_q(critic, o_n, a)
            loss = F.mse_loss(q1, y) + F.mse_loss(q2, y)
            opt_c.step(critic, plain.grads_of(loss, critic), apply=fault != "frozen_step")
            plain.polyak(target, critic, hp["tau"])
            c_losses.append(float(loss.detach()))
        a_losses = []
        for u in range(hp["n_actor"]):
            o = fields(batch(d["actor_slot"][u], d["actor_env"][u]))[0]
            o_n = rms.normalize_clip(o)
            loss = -plain.q_min({k: v.detach() for k, v in critic.items()}, o_n,
                                actor_forward({"actor." + k: v for k, v in actor.items()}, o_n)).mean()
            opt_a.step(actor, plain.grads_of(loss, actor), apply=fault != "frozen_step")
            a_losses.append(float(loss.detach()))
        out["losses"].append((sum(c_losses) / len(c_losses), sum(a_losses) / len(a_losses)))
    out["g1"] = {**{f"actor.{k}": v for k, v in (opt_a.first or {}).items()},
                 **{f"critic.{k}": v for k, v in (opt_c.first or {}).items()}}
    out["params"] = {**{f"actor.{k}": v.detach() for k, v in actor.items()},
                     **{f"critic.{k}": v.detach() for k, v in critic.items()},
                     **{f"target.{k}": v for k, v in target.items()}}
    return out


def learner_numbers(side: dict, ref: dict, weights: dict, hp: dict, details: dict | None = None) -> dict:
    """``plain.learner_numbers`` and the actions the sim phase sent, on what
    is steady from seed to seed. The actor descends min(Q1, Q2) row by row;
    where a row's two heads all but tie (a few 1e-7 apart), rounding decides
    on either side which head its gradient goes through, and the Adam steps
    after it carry that on to every later actor output. So the losses
    compared are every iteration's critic loss and the first iteration's
    actor loss; the actor's change is taken by its median leaf, the
    critic's and the target's by their worst; ``action_gap`` is the actions
    up to the first followed iteration's (the warm-up's and those from the
    benchmark's weights). ``details`` gets every loss and every step's
    action gap besides."""
    steady = lambda d: dict(d, losses=[tuple(d["losses"][0])] + [(c,) for c, _ in d["losses"][1:]])  # noqa: E731
    numbers = plain.learner_numbers(steady(side), steady(ref), weights, details=details, median_nets=("actor",))
    gaps = [float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(side["actions"], ref["actions"])]
    numbers["action_gap"] = max(gaps[:hp["warm_up"] + hp["H"]])
    if details is not None:
        details["losses_all"] = [[x for pair in d["losses"] for x in pair] for d in (side, ref)]
        details["action_gaps"] = gaps[hp["warm_up"]:]
    return numbers


def program_side(rec: dict) -> dict:
    return {"losses": rec["losses"], "g1": rec["g1"], "params": rec["params"],
            "actions": [s["action"] for s in rec["steps"]]}
