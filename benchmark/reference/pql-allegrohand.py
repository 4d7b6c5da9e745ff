"""``pql-allegrohand``: PQL on the AllegroHand task. The plain reference of
its learner is ``pql_plain``; this file adds the check of the env's answers,
from the task's definition in the configuration file (``task_constants``:
reward constants, reset pose, obs layout; ``physics``: the hand's model):

- the physics: every env step of the recorded ones (the warm-up's and the
  followed iterations'), started from the program's own state before it
  (angles, rates, contact anchors), is stepped again by the plain engine of
  ``hand_physics`` in float64 with the program's action, and the angles,
  rates and the cube's pose and velocity after it are compared with the
  next obs the program answered, in every env that did not end its episode;
- for every env that did not end its episode: the reward recomputed from the
  cube's orientation after the step and the goal before it (1/(d + ε), the
  action penalty, the goal bonus), the success flag, the goal re-sampled
  from the step's draw where it was reached and kept otherwise;
- for every env that ended it: the next obs equal to the fresh episode's
  first obs, built from the step's reset draw;
- for every env: the obs's relative rotation equal to cube ∘ goal⁻¹, and
  the first obs of all equal to the episodes the benchmark drew;
- the share of live env steps in which no finger moved (a physics step
  that returned its state unchanged).
"""

from __future__ import annotations

import math

import torch

from reference import hand_physics, pql_plain
from reference.pql_plain import env_steps_per_iter, install_spans, load_weights, networks  # noqa: F401

FAULTS = pql_plain.FAULTS + ("contacts_dropped",)
OFF_GAP = 1e-2  # a physics answer this far from the reference's is off (``physics_off_share``)
CHUNK = 65536  # env steps the plain engine steps at once


class Recorder(pql_plain.Recorder):
    """PQL's recorder, and the env's own state before each step: the
    hand's angles, rates and contact anchors, where the physics starts."""

    def __init__(self, agent, state):
        super().__init__(agent, state)
        self.data["pre"] = []
        step = agent.env.step

        def pre_step(s, *a, **k):
            self.data["pre"].append({key: s.state[key].clone() for key in ("q", "qd", "contact")})
            return step(s, *a, **k)

        agent.env.step = pre_step

# --------------------------------------------------------- quaternions (w, x, y, z)


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_inv(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def rot_dist(q1, q2):
    """Angle of the relative rotation of two unit quaternions."""
    return 2.0 * torch.arcsin(torch.clamp(torch.linalg.vector_norm(quat_mul(q1, quat_inv(q2))[..., 1:], dim=-1),
                                          0.0, 1.0))


def uniform_quat(u):
    """Shoemake's uniform unit quaternion from u [..., 3] on [0, 1)."""
    u1, u2, u3 = u.unbind(-1)
    a, b = torch.sqrt(1.0 - u1), torch.sqrt(u1)
    return torch.stack([a * torch.sin(2 * math.pi * u2), a * torch.cos(2 * math.pi * u2),
                        b * torch.sin(2 * math.pi * u3), b * torch.cos(2 * math.pi * u3)], -1)


# ------------------------------------------------------------------- env


def start_draw(gen, num_envs: int, task: dict):
    """[E, n_dof + 6], the task's ``draw_reset`` layout: finger offsets
    U(±finger_noise), then the cube's and the goal's quaternion uniforms."""
    u = torch.rand(num_envs, task["n_dof"] + 6, generator=gen, device=gen.device)
    n, a = task["n_dof"], task["finger_noise"]
    return torch.cat([u[:, :n] * (2.0 * a) - a, u[:, n:]], -1)


def reset_envs(agent, state, gen, config: dict):
    """Start every env from the benchmark's draw; returns it."""
    draw = start_draw(gen, agent.num_envs, config["task_constants"])
    state.env_state, state.obs = agent.env.reset(draw)
    return draw


def fresh_obs(draw: torch.Tensor, task: dict) -> torch.Tensor:
    """The first obs of episodes drawn by ``draw`` [E, n_dof + 6]: finger
    offsets, then the cube's and the goal's quaternion uniforms."""
    n = task["n_dof"]
    links = task["links_per_finger"]
    q0 = torch.tensor([task["finger_q0_abduction"] if i % links == 0 else task["finger_q0_curl"] for i in range(n)],
                      device=draw.device)
    quat, goal = uniform_quat(draw[:, n:n + 3]), uniform_quat(draw[:, n + 3:n + 6])
    e = draw.shape[0]
    zeros = lambda k: torch.zeros(e, k, device=draw.device)  # noqa: E731
    pos = torch.tensor(task["cube_q0"], device=draw.device).expand(e, 3)
    return torch.cat([q0 + draw[:, :n], zeros(n), pos, quat, zeros(6), goal, quat_mul(quat, quat_inv(goal))], -1)


def env_parts(rec: dict, task: dict, fault: str | None = None) -> dict:
    """The worst gap of each part of the env's answers (see ``env_numbers``)."""
    n = task["n_dof"]
    o = task["obs"]
    sl = lambda x, k: x[:, o[k][0]:o[k][1]]  # noqa: E731
    draws = rec["draws"]
    resets = [r for d in draws for r in d["reset"]]
    goals = [g for d in draws for g in d["step"]]
    prev = rec["obs0"]
    parts = dict(first=float((prev - fresh_obs(rec["start_draw"], task)).abs().max()), reward=0.0, success=0.0,
                 goal=0.0, rel=0.0, fresh=0.0, frozen=0, live=0)
    for t, s in enumerate(rec["steps"]):
        nxt, reward, done = s["next_obs"], s["reward"], s["done"] > 0.5
        if fault == "reward_altered":
            reward = reward * 1.1
        if fault == "frozen_env":
            nxt = torch.where(done[:, None], nxt, prev)
        live = ~done
        goal_before = sl(prev, "goal")
        dist = rot_dist(sl(nxt, "quat"), goal_before)
        success = dist < task["success_tolerance"]
        clear = live & ((dist - task["success_tolerance"]).abs() > 1e-5)  # a flag rounding could flip is not judged
        want = (1.0 / (dist + task["rot_eps"]) - task["action_penalty"] * (s["action"] ** 2).sum(-1)
                + torch.where(success, task["reach_goal_bonus"], 0.0))
        if clear.any():
            parts["reward"] = max(parts["reward"], float(((reward - want).abs() / (1.0 + want.abs()))[clear].max()))
            if bool(((s["success"] > 0.5) != success)[clear].any()):
                parts["success"] = 1.0
            goal_want = torch.where(success[:, None], uniform_quat(goals[t]), goal_before)
            parts["goal"] = max(parts["goal"], float((sl(nxt, "goal") - goal_want).abs()[clear].max()))
        rel = quat_mul(sl(nxt, "quat"), quat_inv(sl(nxt, "goal")))
        parts["rel"] = max(parts["rel"], float((sl(nxt, "rel") - rel).abs().max()))
        if done.any():
            parts["fresh"] = max(parts["fresh"], float((nxt - fresh_obs(resets[t], task)).abs()[done].max()))
        parts["frozen"] += int(((nxt[:, :2 * n] == prev[:, :2 * n]).all(-1) & live).sum())
        parts["live"] += int(live.sum())
        prev = nxt
    return parts


def env_numbers(rec: dict, task: dict, fault: str | None = None) -> dict:
    """``env_gap``: the worst of the first obs's gap, the reward's relative
    gap, a success flag that disagrees (1), and the goal, relative rotation
    and fresh-episode obs gaps; ``env_frozen_share``: live env steps in which
    no finger joint moved. ``fault`` alters the recorded answers as a broken
    env would (``reward_altered``: rewards × 1.1; ``frozen_env``: the obs
    left as it was)."""
    p = env_parts(rec, task, fault)
    gap = max(p[k] for k in ("first", "reward", "success", "goal", "rel", "fresh"))
    return {"env_gap": gap, "env_frozen_share": p["frozen"] / max(p["live"], 1)}


# --------------------------------------------------------------- physics


def obs_state(obs: torch.Tensor, task: dict) -> torch.Tensor:
    """The engine's (q, qd) [E, 45] read from the obs: the hinge angles, the
    cube's position and quaternion, the hinge rates, the cube's body-frame
    angular and linear velocity."""
    o = task["obs"]
    sl = lambda k: obs[:, o[k][0]:o[k][1]]  # noqa: E731
    return torch.cat([sl("angles"), sl("pos"), sl("quat"), sl("rates"), sl("ang_vel"), sl("lin_vel")], -1)


def physics_gaps(rec: dict, config: dict, device, control: bool = False, fault: str | None = None) -> torch.Tensor:
    """Per live env step, the worst of |program − reference| / (1 + |reference|)
    over the state after the step. ``control`` puts the engine in TF32 in the
    program's place; ``fault``: ``frozen_env`` the state left as it was,
    ``contacts_dropped`` the engine without its contacts."""
    phys, task = config["physics"], config["task_constants"]
    ref = hand_physics.HandEngine(phys, device)
    side = hand_physics.HandEngine(phys, device, tf32=True) if control else None
    f64 = lambda x: x.to(torch.float64)  # noqa: E731
    gaps = []
    for pre, s in zip(rec["pre"], rec["steps"]):
        live = s["done"] < 0.5
        for lo in range(0, live.shape[0], CHUNK):
            keep = live[lo:lo + CHUNK].to(device)
            if not bool(keep.any()):
                continue
            pick = lambda x: x[lo:lo + CHUNK].to(device)[keep]  # noqa: E731
            q, qd, cs, act = pick(pre["q"]), pick(pre["qd"]), pick(pre["contact"]), pick(s["action"])
            rq, rqd, _ = ref.control_step(f64(q), f64(qd), f64(act), f64(cs))
            want = torch.cat([rq, rqd], -1)
            if control:
                got = torch.cat(side.control_step(q, qd, act, cs)[:2], -1)
            elif fault == "contacts_dropped":
                got = torch.cat(ref.control_step(f64(q), f64(qd), f64(act), f64(cs), contacts=False)[:2], -1)
            elif fault == "frozen_env":
                got = torch.cat([q, qd], -1)
            else:
                got = obs_state(pick(s["next_obs"]), task)
            gaps.append(((f64(got) - want).abs() / (1.0 + want.abs())).amax(-1).cpu())
    if not gaps:
        return torch.zeros(0, dtype=torch.float64)
    return torch.cat(gaps)


def physics_numbers(rec: dict, config: dict, device, control: bool = False, fault: str | None = None) -> dict:
    """``physics_gap``: the median over live env steps of the state's gap
    after the step; ``physics_off_share``: the share of them whose gap
    passes ``OFF_GAP``. The median is steady where a contact that rounding
    switches on in one substep and not in the other parts a few env steps."""
    g = physics_gaps(rec, config, device, control, fault)
    if g.numel() == 0:
        return {"physics_gap": math.inf, "physics_off_share": math.inf}
    return {"physics_gap": float(g.median()), "physics_off_share": float((g > OFF_GAP).double().mean())}


# ----------------------------------------------------------------- check


def readings(rec: dict, weights: dict, config: dict, traffic: dict, device, control: bool = False,
             fault: str | None = None, details: dict | None = None) -> dict:
    """The numbers compared for the program (``control`` False, no
    ``fault``), or for the reference put in its place: in TF32
    (``control``) or with a fault planted. ``details`` gets the parts
    behind the numbers."""
    from reference import plain

    hp = pql_plain.hyper(config, traffic)
    with plain.matmul_precision(False):
        ref = pql_plain.follow(rec, weights, hp, device)
        if control or fault in ("half_batch", "frozen_step", "reward_altered"):
            with plain.matmul_precision(control):
                side = pql_plain.follow(rec, weights, hp, device, fault=fault)
        else:
            side = pql_plain.program_side(rec)
        numbers = pql_plain.learner_numbers(side, ref, weights, hp, details)
        numbers.update(env_numbers(rec, config["task_constants"], fault))
        numbers.update(physics_numbers(rec, config, device, control, fault))
    if details is not None:
        details["env_parts"] = env_parts(rec, config["task_constants"], fault)
    return numbers


def check(rec: dict, weights: dict, config: dict, traffic: dict, device) -> dict:
    return readings(rec, weights, config, traffic, device)
