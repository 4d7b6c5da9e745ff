"""``ddpgv-reachervision``: visual DDPG on ReacherVision, recorded from the
program and followed by a plain reference (supersglzc/pql
``pql/models/visual.py:206-352``, ``ResEncoder`` and
``DiagGaussianMLPVPolicy``, its PointNet encoder, and its visual DDPG agent).

The recorder keeps the draws of the warm-up and of each followed iteration,
every env step (the action the program sent and what the env answered), the
rows the program wrote to its host ring (frames as uint8, the rest as fp16),
the (slot, env) indices the ring drew for each update, the losses, Adam's
first moments after the first iteration and the parameters after the last.

The reference follows everything else itself from the benchmark's weights
and first episodes: the Reacher's dynamics and auto-reset, the rendered
frames, proprio and point cloud, the running obs moments, the actions, the
ring's contents, the updates (the ResNet-18 trunk through layer2 with
GroupNorm, the PointNet, the MLPs, the Double-Q critic), AdamW and polyak.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import plain, recording

FAULTS = ("half_batch", "frozen_step", "reward_altered", "frozen_env")


def networks(state) -> dict:
    return {"actor": state.actor, "critic": state.critic}


@torch.no_grad()
def load_weights(state, w: dict) -> None:
    for name, t in state.critic_target.named_parameters():
        t.copy_(w[f"critic.{name}"])


def env_steps_per_iter(cfg) -> int:
    return cfg.num_envs * cfg.algo.horizon_len


def start_draw(gen, num_envs: int, task: dict):
    """[E, 4]: the joint offsets U(±q_noise), the target's angle U(−π, π)
    and its radius U(r_lo, r_hi) (the task's ``draw_reset`` layout)."""
    u = torch.rand(num_envs, 4, generator=gen, device=gen.device)
    a, (lo, hi) = task["q_noise"], task["target_radius"]
    return torch.cat([u[:, :2] * (2 * a) - a, u[:, 2:3] * (2 * math.pi) - math.pi, u[:, 3:4] * (hi - lo) + lo], -1)


def reset_envs(agent, state, gen, config: dict):
    draw = start_draw(gen, agent.num_envs, config["task_constants"])
    state.env_state, state.obs = agent.env.reset(draw)
    return draw


class Recorder:
    """Wraps the agent's ``draw_iteration``, its env's ``step``, its
    ``ring_write``, its ring's ``draw_index`` and its optimizers' ``step``
    until ``close``."""

    def __init__(self, agent, state):
        self.agent = agent
        self.data = {"obs0": state.obs.clone(), "draws": [], "steps": [], "written": [], "index": [], "losses": [],
                     "update_losses": []}
        self.first = recording.FirstSteps({"actor": (state.actor_opt, state.actor),
                                           "critic": (state.critic_opt, state.critic)})
        draw, step, write, index = agent.draw_iteration, agent.env.step, agent.ring_write, agent.replay.draw_index
        update = agent.update

        def recorded_draw(gen, random=False):
            d = draw(gen, random)
            self.data["draws"].append({k: v.clone() for k, v in d.items()})
            return d

        def recorded_step(s, action, reset_draw, step_draw=None):
            out = step(s, action, reset_draw, step_draw)
            _, obs, reward, done, _ = out
            self.data["steps"].append(dict(action=action.clone(), next_obs=obs.clone(), reward=reward.clone(),
                                           done=done.clone()))
            return out

        def recorded_write(traj):
            self.data["written"].append({k: v.clone() for k, v in traj.items()})
            return write(traj)

        def recorded_index(batch_size):
            slot, env = index(batch_size)
            self.data["index"].append((torch.from_numpy(slot.copy()), torch.from_numpy(env.copy())))
            return slot, env

        def recorded_update(st, batch, normal):
            losses = update(st, batch, normal)
            self.data["update_losses"].append(tuple(x.clone() for x in losses))
            return losses

        agent.draw_iteration, agent.env.step, agent.ring_write = recorded_draw, recorded_step, recorded_write
        agent.replay.draw_index, agent.update = recorded_index, recorded_update

    def after_iter(self, i: int, state, metrics: dict) -> None:
        self.data["losses"].append((metrics["train/critic_loss"].clone(), metrics["train/actor_loss"].clone()))
        self.data["params"] = recording.params({"actor": state.actor, "critic": state.critic,
                                                "target": state.critic_target})

    def close(self) -> None:
        del self.agent.draw_iteration, self.agent.env.step, self.agent.ring_write, self.agent.replay.draw_index
        del self.agent.update
        self.data["g1"] = self.first.close()
        self.data = recording.host(self.data)
        for k in ("losses", "update_losses"):
            self.data[k] = [(float(c), float(a)) for c, a in self.data[k]]


def install_spans(agent, state, record_function):
    """``collect`` as env; ``ring_write`` and ``fetch_batch`` as replay (the
    host ring); ``update`` as learner. Returns (the ranges' names, the undo).

    The ring's ranges open after a ``synchronize``: ``ring_write`` starts
    with a copy of the collect's fields to the host, and ``fetch_batch``
    waits for its staging set's last copy, which would otherwise wait
    inside the range for the render or the updates queued before them.
    The traced window is not the timed one: the waits the ``synchronize``
    adds there cost the end-to-end metrics nothing."""
    import torch

    def wrap(fn, name, sync=False):
        def wrapped(*a, **k):
            if sync:
                torch.cuda.synchronize()
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    agent.collect = wrap(agent.collect, "env.collect")
    agent.ring_write = wrap(agent.ring_write, "replay.ring_write", sync=True)
    agent.fetch_batch = wrap(agent.fetch_batch, "replay.fetch_batch", sync=True)
    agent.update = wrap(agent.update, "learner.update")

    def undo():
        del agent.collect, agent.ring_write, agent.fetch_batch, agent.update
    return ("env.collect", "replay.ring_write", "replay.fetch_batch", "learner.update"), undo


# ------------------------------------------------------------------- env


class Reacher:
    """The two-link planar Reacher with its camera, point cloud and proprio
    (the task's constants in the configuration's ``task_constants``)."""

    def __init__(self, task: dict, draw: torch.Tensor):
        self.c = task
        self.q, self.qd, self.target = self._fresh(draw)
        self.q_prev = self.q.clone()
        self.time = torch.zeros(draw.shape[0], dtype=torch.int64, device=draw.device)

    def _fresh(self, draw):
        angle, radius = draw[:, 2:3], draw[:, 3:4]
        return draw[:, 0:2], torch.zeros_like(draw[:, 0:2]), radius * torch.cat([torch.cos(angle), torch.sin(angle)], -1)

    def fingertip(self, q):
        l1, l2 = self.c["link1"], self.c["link2"]
        a, b = q[:, 0], q[:, 0] + q[:, 1]
        return torch.stack([l1 * torch.cos(a) + l2 * torch.cos(b), l1 * torch.sin(a) + l2 * torch.sin(b)], -1)

    def obs(self):
        return torch.cat([torch.cos(self.q), torch.sin(self.q), self.qd, self.target,
                          self.fingertip(self.q) - self.target], -1)

    def step(self, action, reset_draw, fault=None):
        c = self.c
        torque = c["max_torque"] * torch.clamp(action, -1.0, 1.0)
        qd = torch.clamp(self.qd * c["damping"] + c["dt"] * torque / c["inertia"], -c["max_speed"], c["max_speed"])
        q = self.q + c["dt"] * qd
        dist = torch.linalg.vector_norm(self.fingertip(q) - self.target, dim=-1)
        reward = -dist - c["action_cost"] * (action ** 2).sum(-1)
        if fault == "frozen_env":
            q, qd = self.q, self.qd
        time = self.time + 1
        done = time >= c["episode_length"]
        fq, fqd, ft = self._fresh(reset_draw)
        keep = lambda new, fresh: torch.where(done[:, None], fresh, new)  # noqa: E731
        self.q_prev = keep(self.q, fq)
        self.q, self.qd, self.target = keep(q, fq), keep(qd, fqd), keep(self.target, ft)
        self.time = torch.where(done, torch.zeros_like(time), time)
        return reward, done.float()

    # views: arm points (2 links × n points), target ring, splat frames
    def link_points(self, q):
        l1, l2, n = self.c["link1"], self.c["link2"], self.c["link_points"]
        a, b = q[:, 0], q[:, 0] + q[:, 1]
        elbow = l1 * torch.stack([torch.cos(a), torch.sin(a)], -1)
        tip = elbow + l2 * torch.stack([torch.cos(b), torch.sin(b)], -1)
        t = torch.linspace(0.0, 1.0, n, device=q.device)[:, None]
        return torch.cat([t * elbow[:, None], elbow[:, None] + t * (tip - elbow)[:, None]], 1)

    def target_points(self):
        k = self.c["target_points"]
        ang = torch.arange(k, dtype=torch.float32, device=self.q.device) * (2.0 * math.pi / k)
        return self.target[:, None] + self.c["target_ring"] * torch.stack([torch.cos(ang), torch.sin(ang)], -1)

    def frame(self, q):
        view, h, w = self.c["view"], self.c["height"], self.c["width"]
        gy, gx = torch.meshgrid(torch.linspace(-view, view, h, device=q.device),
                                torch.linspace(-view, view, w, device=q.device), indexing="ij")
        sigma = 2.0 * view / h

        def splat(pts):
            d2 = (gx - pts[..., 0, None, None]) ** 2 + (gy - pts[..., 1, None, None]) ** 2
            return torch.clamp(torch.exp(-d2 / (2.0 * sigma ** 2)).sum(1), 0.0, 1.0)

        arm, tgt = splat(self.link_points(q)), splat(self.target_points())
        return torch.stack([arm, tgt, torch.zeros_like(arm)], -1)

    def views(self):
        """(frames [E, 1, 2, H, W, 3] of the previous and the current pose,
        proprio [E, 6], point cloud [E, 2n + k, 3])."""
        img = torch.stack([self.frame(self.q_prev), self.frame(self.q)], 1)[:, None]
        proprio = torch.cat([torch.cos(self.q), torch.sin(self.q), self.qd], -1)
        pts = torch.cat([self.link_points(self.q), self.target_points()], 1)
        return img, proprio, torch.cat([pts, torch.zeros_like(pts[..., :1])], -1)


# -------------------------------------------------------------- networks


def same_pad(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(w, name, x, stride):
    """A bias-free conv with flax ``SAME`` padding: the conv's own padding
    where it is symmetric, an explicit pad where it is not (stride 2)."""
    k = w[f"{name}.weight"].shape[-1]
    (hl, hh), (wl, wh) = same_pad(x.shape[-2], k, stride), same_pad(x.shape[-1], k, stride)
    if hl == hh == wl == wh:
        return F.conv2d(x, w[f"{name}.weight"], None, stride=stride, padding=hl)
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w[f"{name}.weight"], None, stride=stride)


def group_norm(w, name, x):
    return F.group_norm(x, min(32, x.shape[1]), w[f"{name}.scale"], w[f"{name}.bias"], 1e-6)


def block(w, x, stride):
    y = F.relu(group_norm(w, "gns.0", conv(w, "convs.0", x, stride)))
    y = group_norm(w, "gns.1", conv(w, "convs.1", y, 1))
    skip = group_norm(w, "gns.2", conv(w, "convs.2", x, stride)) if "convs.2.weight" in w else x
    return F.relu(skip + y)


def trunk(w, x):
    """ResNet-18's stem, layer1 and layer2 on NCHW frames."""
    x = F.relu(group_norm(w, "gns.0", conv(w, "convs.0", x, 2)))
    (hl, hh), (wl, wh) = same_pad(x.shape[-2], 3, 2), same_pad(x.shape[-1], 3, 2)
    x = F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=float("-inf")), 3, 2)
    for i, stride in enumerate((1, 1, 2, 1)):
        x = block(plain.sub(w, f"blocks.{i}"), x, stride)
    return x


def res_encoder(w, img):
    """[B, cams, T, H, W, C] → [B, cams·repr]: the trunk per frame, then
    conv[t] and conv[t] − stop_grad(conv[t−1]) for t ≥ 1, channel-last,
    fc, LayerNorm. Frame 0 enters only through a stopped gradient."""
    b, cams, t, h, wd, c = img.shape
    x = img.reshape(b * cams * t, h, wd, c).permute(0, 3, 1, 2).reshape(b * cams, t, c, h, wd)
    tw = plain.sub(w, "trunk")
    if torch.is_grad_enabled():  # frame 0 apart, as no gradient reaches it
        with torch.no_grad():
            first = trunk(tw, x[:, 0].contiguous())
        rest = trunk(tw, x[:, 1:].reshape(-1, c, h, wd))
        conv_out = torch.cat([first[:, None], rest.reshape((b * cams, t - 1) + rest.shape[1:])], 1)
    else:
        conv_out = trunk(tw, x.reshape(-1, c, h, wd))
        conv_out = conv_out.reshape((b * cams, t) + conv_out.shape[1:])
    conv_out = conv_out.permute(0, 1, 3, 4, 2)
    cur = conv_out[:, 1:]
    feats = torch.cat([cur, cur - conv_out[:, :t - 1].detach()], 1).reshape(b * cams, -1)
    return plain.layer_norm(plain.linear(w, "layers.0", feats), w["norm.scale"], w["norm.bias"]).reshape(b, -1)


def pointnet(w, pc):
    act = lambda x: F.leaky_relu(x, 0.01)  # noqa: E731
    y = act(plain.linear(w, "conv_in", pc))
    feats = []
    for i in range(4):
        y = act(plain.linear(w, f"layer_{i}", y))
        y = torch.cat([y, torch.amax(y, -2, keepdim=True).expand_as(y)], -1)
        y = act(plain.linear(w, f"global_{i}", y))
        feats.append(y)
    return torch.amax(plain.linear(w, "conv_out", torch.cat(feats, -1)), -2)


def actor_mean(w, img, proprio, pc):
    """The visual Gaussian policy's mean: camera features ∥ point cloud ∥
    proprio features → two ReLU layers → the mean."""
    pse = plain.sub(w, "point_state_encoder")
    h = torch.cat([pointnet(plain.sub(pse, "pointnet"), pc), plain.mlp(plain.sub(pse, "mlp"), proprio, F.relu)], -1)
    x = F.relu(plain.layer_norm(plain.linear(w, "trunk_fc", res_encoder(plain.sub(w, "encoder"), img)),
                                w["trunk_ln.scale"], w["trunk_ln.bias"]))
    h = F.relu(plain.linear(w, "pi_1", torch.cat([x, h], -1)))
    return plain.linear(w, "pi_out", F.relu(plain.linear(w, "pi_2", h)))


def act(w, img, proprio, pc):
    return torch.tanh(actor_mean(w, img, proprio, pc))


# ------------------------------------------------------------- reference


def hyper(config: dict, traffic: dict) -> dict:
    a = {**config["args"], **traffic["args"]}
    return dict(E=int(a["num_envs"]), H=int(a["algo.horizon_len"]), B=int(a["algo.batch_size"]),
                updates=int(a["algo.update_times"]), memory=int(a["algo.memory_size"]), gamma=float(a["algo.gamma"]),
                tau=float(a["algo.tau"]), actor_lr=float(a["algo.actor_lr"]), critic_lr=float(a["algo.critic_lr"]),
                max_norm=a["algo.max_grad_norm"], reward_scale=float(a["algo.reward_scale"]),
                std_max=float(a["algo.noise.std_max"]), std_min=float(a["algo.noise.std_min"]),
                tgt_std=float(a["algo.noise.tgt_pol_std"]), tgt_bound=float(a["algo.noise.tgt_pol_noise_bound"]))


def quantize(x):
    return torch.round(x * 255.0).to(torch.uint8).reshape(x.shape[0], -1)


def half(x):
    return x.to(torch.float16).reshape(x.shape[0], -1)


def follow(rec: dict, weights: dict, hp: dict, task: dict, device, fault: str | None = None,
           env_actions: list | None = None) -> dict:
    """The warm-up and the followed iterations; returns the actions worked
    out, the env's answers, the ring rows written, the losses, the first
    gradients and the final params. With ``env_actions`` (a judged side's
    actions) the env is stepped, and the ring written, with those: each
    stage is judged on the inputs the side gave it."""
    img_shape = tuple(task["img_shape"])
    w = {k: v.detach().to(device).clone() for k, v in weights.items()}
    actor, critic = plain.sub(w, "actor"), plain.sub(w, "critic")
    target = {k: v.clone() for k, v in critic.items()}
    for p in (*actor.values(), *critic.values()):
        p.requires_grad_(True)
    opt_a = plain.AdamW(actor, hp["actor_lr"], hp["max_norm"])
    opt_c = plain.AdamW(critic, hp["critic_lr"], hp["max_norm"])
    env = Reacher(task, rec["start_draw"].to(device))
    obs = env.obs()
    rms = plain.RunningMoments(obs.shape[1], device)
    slots = max(hp["memory"] // hp["E"], 2)
    ring = []  # written steps, each a dict of [E, dim] fields
    out = {"obs0": obs, "actions": [], "env": [], "written": [], "losses": [], "update_losses": []}
    draws = [{k: v.to(device) for k, v in d.items()} for d in rec["draws"]]
    index = iter(rec["index"])
    uses, at = 0, 0

    def collect(d, random):
        nonlocal obs, at
        img, proprio, pc = env.views()
        for t in range(hp["H"]):
            rms.update(obs)
            with torch.no_grad():
                if random:
                    action = d["action_uniform"][t]
                else:
                    action = plain.mixed_noise_action(act(actor, img, proprio, pc), d["explore_normal"][t],
                                                      hp["std_min"], hp["std_max"])
            out["actions"].append(action)
            if env_actions is not None:
                action = env_actions[at].to(device)
            at += 1
            reward, done = env.step(action, d["reset"][t], fault)
            if fault == "reward_altered":
                reward = reward * 1.1
            next_obs = env.obs()
            n_img, n_proprio, n_pc = env.views()
            out["env"].append(dict(next_obs=next_obs, reward=reward, done=done))
            row = dict(img=quantize(img), next_img=quantize(n_img), proprio=half(proprio),
                       next_proprio=half(n_proprio), pc=half(pc), next_pc=half(n_pc), obs=half(obs),
                       next_obs=half(next_obs), action=half(action), reward=half(hp["reward_scale"] * reward),
                       done=half(done))
            out["written"].append(row)
            if len(ring) >= slots:
                raise ValueError("the followed iterations do not wrap the ring")
            ring.append(row)
            obs, img, proprio, pc = next_obs, n_img, n_proprio, n_pc

    def batch():
        nonlocal uses
        slot, envs = next(index)
        uses += 1
        if slot.shape[0] != hp["B"] or int(slot.max()) >= len(ring) or int(envs.max()) >= hp["E"]:
            raise ValueError(f"the ring drew {slot.shape[0]} rows (slots < {int(slot.max()) + 1}) for a batch of "
                             f"{hp['B']} from {len(ring)} written slots")
        if fault == "half_batch":
            slot, envs = slot[: hp["B"] // 2], envs[: hp["B"] // 2]
        slot, envs = slot.to(device), envs.to(device)
        return {k: torch.stack([r[k] for r in ring])[slot, envs].float() for k in ring[0]}

    collect(draws[0], True)
    for it in range(1, len(draws)):
        d = draws[it]
        collect(d, False)
        c_losses, a_losses = [], []
        for u in range(hp["updates"]):
            b = batch()
            img = b["img"].reshape((-1,) + img_shape) / 255.0
            n_img = b["next_img"].reshape((-1,) + img_shape) / 255.0
            pc, n_pc = b["pc"].reshape(b["pc"].shape[0], -1, 3), b["next_pc"].reshape(b["pc"].shape[0], -1, 3)
            o, no = rms.normalize_clip(b["obs"]), rms.normalize_clip(b["next_obs"])
            with torch.no_grad():
                na = plain.smoothed_target_action(act(actor, n_img, b["next_proprio"], n_pc),
                                                  d["target_normal"][u][: o.shape[0]], hp["tgt_std"], hp["tgt_bound"])
                y = b["reward"] + (1.0 - b["done"]) * hp["gamma"] * plain.q_min(target, no, na)
            q1, q2 = plain.double_q(critic, o, b["action"])
            loss = F.mse_loss(q1, y) + F.mse_loss(q2, y)
            opt_c.step(critic, plain.grads_of(loss, critic), apply=fault != "frozen_step")
            plain.polyak(target, critic, hp["tau"])
            c_losses.append(float(loss.detach()))
            a_loss = -plain.q_min({k: v.detach() for k, v in critic.items()}, o,
                                  act(actor, img, b["proprio"], pc)).mean()
            opt_a.step(actor, plain.grads_of(a_loss, actor), apply=fault != "frozen_step")
            a_losses.append(float(a_loss.detach()))
            out["update_losses"].append((c_losses[-1], a_losses[-1]))
        out["losses"].append((sum(c_losses) / len(c_losses), sum(a_losses) / len(a_losses)))
    if uses != len(rec["index"]):
        raise ValueError(f"the ring drew {len(rec['index'])} batches for {uses} updates")
    out["g1"] = {**{f"actor.{k}": v for k, v in opt_a.first.items()},
                 **{f"critic.{k}": v for k, v in opt_c.first.items()}}
    out["params"] = {**{f"actor.{k}": v.detach() for k, v in actor.items()},
                     **{f"critic.{k}": v.detach() for k, v in critic.items()},
                     **{f"target.{k}": v for k, v in target.items()}}
    return out


def program_side(rec: dict) -> dict:
    return {"obs0": rec["obs0"], "losses": rec["losses"], "update_losses": rec["update_losses"], "g1": rec["g1"],
            "params": rec["params"],
            "actions": [s["action"] for s in rec["steps"]],
            "env": [dict(next_obs=s["next_obs"], reward=s["reward"], done=s["done"]) for s in rec["steps"]],
            "written": [{k: v[t] for k, v in w.items()} for w in rec["written"] for t in range(len(w["obs"]))]}


def numbers(side: dict, ref: dict, weights: dict, hp: dict, details: dict | None = None) -> dict:
    """A side against the reference that followed it:

    - the learner's numbers (``plain.learner_numbers``) with the losses of
      the first update and the median leaf's change: the visual actor is
      ill-conditioned (a rounding difference in one update grows over the
      next ones), so the later losses and the worst leaf's change swing
      from seed to seed;
    - ``action_gap``: the actions of the warm-up and the first iteration
      (from the benchmark's weights), against the reference's;
    - the env's answers to the side's actions (relative), the frames it
      wrote (share of pixels more than one level off) and the other written
      fields (fp16, relative as the env's answers), over every step."""
    first_update = lambda d: dict(d, losses=d["update_losses"][:1])  # noqa: E731
    out = plain.learner_numbers(first_update(side), first_update(ref), weights, change_of="median", details=details)
    if details is not None:
        details["update_loss_gaps"] = [plain.loss_gap(s, r) for s, r in zip(side["update_losses"],
                                                                             ref["update_losses"])]
    first = 2 * hp["H"]
    out["action_gap"] = max(float((a.cpu() - b.cpu()).abs().max())
                            for a, b in zip(side["actions"][:first], ref["actions"][:first]))
    rel = lambda a, b: float(((a.cpu() - b.cpu()).abs() / (1.0 + b.cpu().abs())).max())  # noqa: E731
    env_gap = rel(side["obs0"], ref["obs0"])
    for s, r in zip(side["env"], ref["env"]):
        env_gap = max(env_gap, *(rel(s[k], r[k]) for k in ("next_obs", "reward", "done")))
    frames, ring = 0.0, 0.0
    for s, r in zip(side["written"], ref["written"]):
        for k in r:
            got, want = s[k].cpu(), r[k].cpu()
            if k in ("img", "next_img"):
                frames = max(frames, float(((got.int() - want.int()).abs() > 1).float().mean()))
            else:
                ring = max(ring, rel(got.float(), want.float()))
    out.update(env_gap=env_gap, frame_share=frames, ring_gap=ring)
    return out


def readings(rec: dict, weights: dict, config: dict, traffic: dict, device, control: bool = False,
             fault: str | None = None, details: dict | None = None) -> dict:
    """The numbers compared for the program (``control`` False, no
    ``fault``), or for the reference put in its place: in TF32
    (``control``) or with a fault planted. ``details`` gets the parts
    behind the numbers."""
    hp, task = hyper(config, traffic), config["task_constants"]
    if control or fault is not None:
        with plain.matmul_precision(control):
            side = follow(rec, weights, hp, task, device, fault=fault)
    else:
        side = program_side(rec)
    with plain.matmul_precision(False):
        ref = follow(rec, weights, hp, task, device, env_actions=side["actions"])
    return numbers(side, ref, weights, hp, details)


def check(rec: dict, weights: dict, config: dict, traffic: dict, device) -> dict:
    return readings(rec, weights, config, traffic, device)
