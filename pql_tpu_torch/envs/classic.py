"""Analytic control tasks, batched (port of pql_tpu/envs/classic.py).

- Cartpole: obs = [cart_pos, cart_vel, pole_angle, pole_angvel]; reward =
  1 - θ² - 0.01|ẋ| - 0.005|θ̇|, −2 on falling outside bounds; semi-implicit
  Euler at dt = 1/60; fresh states U(-0.1, 0.1).
- Pendulum: torque-limited swing-up, obs = [cos θ, sin θ, θ̇]; never
  terminates (pure time limit).
- PointMass: a 2-D point mass reaching a random goal, with a ``success``
  info.
- Reacher: a two-link planar arm reaching a random target, with
  ``success``.
- BallBalance: a ball rolling on a tilting tray; terminates off the tray,
  with ``success``.

Each ``draw_reset`` holds exactly the numbers the JAX ``init_state`` draws
(after its key splits), in the order of its fields; ``init_state`` maps
them to the state. None of these tasks draws inside its dynamics.
"""

from __future__ import annotations

import math

import torch

_FIELDS = ("x", "x_dot", "theta", "theta_dot")


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _jnp_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod``: C fmod, then the divisor's sign (jax.numpy.remainder)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


class Cartpole:
    obs_dim = 4
    action_dim = 1
    max_episode_length = 500

    force_mag = 10.0
    dt = 1.0 / 60.0
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    length = 0.5  # half pole length
    reset_dist = 3.0

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """[E, 4] uniform draws in [-0.1, 0.1), one per state field."""
        u = torch.rand(num_envs, 4, generator=gen, device=gen.device)
        return u * 0.2 - 0.1

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        return {k: draw[:, i] for i, k in enumerate(_FIELDS)}

    def get_obs(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.stack([state[k] for k in _FIELDS], dim=-1)

    def dynamics(self, state: dict[str, torch.Tensor], action: torch.Tensor):
        force = self.force_mag * torch.clamp(action[:, 0], -1.0, 1.0)
        x, x_dot = state["x"], state["x_dot"]
        theta, theta_dot = state["theta"], state["theta_dot"]

        costh, sinth = torch.cos(theta), torch.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sinth) / total_mass
        theta_acc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costh**2 / total_mass)
        )
        x_acc = temp - polemass_length * theta_acc * costh / total_mass

        x_dot = x_dot + self.dt * x_acc
        x = x + self.dt * x_dot
        theta_dot = theta_dot + self.dt * theta_acc
        theta = theta + self.dt * theta_dot

        fell = (torch.abs(x) > self.reset_dist) | (torch.abs(theta) > math.pi / 2.0)
        reward = torch.where(
            fell,
            torch.full_like(x, -2.0),
            1.0 - theta**2 - 0.01 * torch.abs(x_dot) - 0.005 * torch.abs(theta_dot),
        )
        next_state = {"x": x, "x_dot": x_dot, "theta": theta, "theta_dot": theta_dot}
        return next_state, reward, fell, {}


class Pendulum:
    """gym Pendulum-v1 analog (pql_tpu/envs/classic.py:79-122)."""

    obs_dim = 3
    action_dim = 1
    max_episode_length = 200

    max_torque = 2.0
    max_speed = 8.0
    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0  # noqa: E741

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """[E, 2]: θ ~ U(-π, π), θ̇ ~ U(-1, 1)."""
        return torch.stack([_uniform(gen, num_envs, -math.pi, math.pi), _uniform(gen, num_envs, -1.0, 1.0)], -1)

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"theta": draw[:, 0], "theta_dot": draw[:, 1]}

    def get_obs(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        th = state["theta"]
        return torch.stack([torch.cos(th), torch.sin(th), state["theta_dot"]], dim=-1)

    def dynamics(self, state: dict[str, torch.Tensor], action: torch.Tensor):
        u = self.max_torque * torch.clamp(action[:, 0], -1.0, 1.0)
        th, thdot = state["theta"], state["theta_dot"]
        norm_th = _jnp_mod(th + math.pi, 2.0 * math.pi) - math.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2

        thdot = thdot + self.dt * (
            3.0 * self.g / (2.0 * self.l) * torch.sin(th) + 3.0 / (self.m * self.l**2) * u
        )
        thdot = torch.clamp(thdot, -self.max_speed, self.max_speed)
        th = th + self.dt * thdot
        return {"theta": th, "theta_dot": thdot}, -cost, torch.zeros_like(th, dtype=torch.bool), {}


class PointMass:
    """2-D point mass reaching a random goal (pql_tpu/envs/classic.py:124-163)."""

    obs_dim = 6  # pos(2), vel(2), goal-pos delta(2)
    action_dim = 2
    max_episode_length = 100

    dt = 0.05
    damping = 0.95
    success_dist = 0.1

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """[E, 4]: pos (2) then goal (2), each U(-1, 1)."""
        return _uniform(gen, (num_envs, 4), -1.0, 1.0)

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"pos": draw[:, 0:2], "vel": torch.zeros_like(draw[:, 0:2]), "goal": draw[:, 2:4]}

    def get_obs(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([state["pos"], state["vel"], state["goal"] - state["pos"]], dim=-1)

    def dynamics(self, state: dict[str, torch.Tensor], action: torch.Tensor):
        accel = torch.clamp(action, -1.0, 1.0)
        vel = state["vel"] * self.damping + self.dt * accel
        pos = state["pos"] + self.dt * vel
        dist = _norm(state["goal"] - pos)
        success = dist < self.success_dist
        reward = -dist - 0.01 * torch.sum(accel**2, dim=-1) + success.float()
        next_state = {"pos": pos, "vel": vel, "goal": state["goal"]}
        return next_state, reward, torch.zeros_like(success), {"success": success.float()}


class Reacher:
    """Two-link planar arm reaching a random target (pql_tpu/envs/classic.py:165-223)."""

    obs_dim = 10  # cos(2), sin(2), qvel(2), target(2), fingertip-target(2)
    action_dim = 2
    max_episode_length = 150

    dt = 0.02
    link1 = 0.1
    link2 = 0.11
    max_torque = 1.0
    damping = 0.99

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """[E, 4]: the joint offsets q (2) U(-0.1, 0.1), the target's angle
        U(-π, π) and its radius U(0.05, 0.2)."""
        return torch.cat([
            _uniform(gen, (num_envs, 2), -0.1, 0.1),
            _uniform(gen, (num_envs, 1), -math.pi, math.pi),
            _uniform(gen, (num_envs, 1), 0.05, 0.2),
        ], -1)

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        angle, radius = draw[:, 2:3], draw[:, 3:4]
        return {
            "q": draw[:, 0:2],
            "qd": torch.zeros_like(draw[:, 0:2]),
            "target": radius * torch.cat([torch.cos(angle), torch.sin(angle)], -1),
        }

    def _fingertip(self, q: torch.Tensor) -> torch.Tensor:
        q0, q01 = q[:, 0], q[:, 0] + q[:, 1]
        x = self.link1 * torch.cos(q0) + self.link2 * torch.cos(q01)
        y = self.link1 * torch.sin(q0) + self.link2 * torch.sin(q01)
        return torch.stack([x, y], -1)

    def get_obs(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        q, target = state["q"], state["target"]
        return torch.cat(
            [torch.cos(q), torch.sin(q), state["qd"], target, self._fingertip(q) - target], dim=-1
        )

    def dynamics(self, state: dict[str, torch.Tensor], action: torch.Tensor):
        torque = self.max_torque * torch.clamp(action, -1.0, 1.0)
        qd = state["qd"] * self.damping + self.dt * torque / 0.01
        qd = torch.clamp(qd, -10.0, 10.0)
        q = state["q"] + self.dt * qd
        dist = _norm(self._fingertip(q) - state["target"])
        reward = -dist - 0.1 * torch.sum(torch.square(action), dim=-1)
        success = dist < 0.02
        next_state = {"q": q, "qd": qd, "target": state["target"]}
        return next_state, reward, torch.zeros_like(success), {"success": success.float()}


class BallBalance:
    """A ball kept centered on a tilting tray (pql_tpu/envs/classic.py:225-281)."""

    obs_dim = 10  # pitch, roll, pitch_rate, roll_rate, ball xy, ball vel xy, dist, speed
    action_dim = 2
    max_episode_length = 500

    dt = 1.0 / 60.0
    gravity = 9.81
    tray_inertia = 0.5
    tray_damping = 0.98
    max_torque = 3.0
    max_tilt = 0.5
    tray_radius = 0.5
    roll_factor = 5.0 / 7.0  # solid-sphere rolling

    def draw_reset(self, gen: torch.Generator, num_envs: int) -> torch.Tensor:
        """[E, 4]: the tilt (2) U(-0.05, 0.05), the ball's position (2) U(-0.25, 0.25)."""
        return torch.cat([_uniform(gen, (num_envs, 2), -0.05, 0.05), _uniform(gen, (num_envs, 2), -0.25, 0.25)], -1)

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        zeros = torch.zeros_like(draw[:, 0:2])
        return {"tilt": draw[:, 0:2], "tilt_rate": zeros, "ball": draw[:, 2:4], "ball_vel": zeros}

    def get_obs(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        dist = _norm(state["ball"])[:, None]
        speed = _norm(state["ball_vel"])[:, None]
        return torch.cat([state["tilt"], state["tilt_rate"], state["ball"], state["ball_vel"], dist, speed], dim=-1)

    def dynamics(self, state: dict[str, torch.Tensor], action: torch.Tensor):
        torque = self.max_torque * torch.clamp(action, -1.0, 1.0)
        tilt_rate = state["tilt_rate"] * self.tray_damping + self.dt * torque / self.tray_inertia
        tilt = torch.clamp(state["tilt"] + self.dt * tilt_rate, -self.max_tilt, self.max_tilt)
        # the ball rolls down the slope: a = (5/7) g sin(tilt) along each axis
        acc = self.roll_factor * self.gravity * torch.sin(tilt)
        ball_vel = state["ball_vel"] + self.dt * acc
        ball = state["ball"] + self.dt * ball_vel

        dist = _norm(ball)
        speed = _norm(ball_vel)
        off_tray = dist > self.tray_radius
        reward = torch.where(
            off_tray,
            torch.full_like(dist, -5.0),
            1.0 - 2.0 * dist - 0.1 * speed - 0.05 * torch.sum(torch.square(action), dim=-1),
        )
        success = (dist < 0.05) & (speed < 0.1)
        next_state = {"tilt": tilt, "tilt_rate": tilt_rate, "ball": ball, "ball_vel": ball_vel}
        return next_state, reward, off_tray, {"success": success.float()}
