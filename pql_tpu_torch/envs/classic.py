"""Cartpole, batched (port of pql_tpu/envs/classic.py:20-76).

obs = [cart_pos, cart_vel, pole_angle, pole_angvel];
reward = 1 - θ² - 0.01|ẋ| - 0.005|θ̇|, −2 on falling outside bounds;
semi-implicit Euler at dt = 1/60; fresh states U(-0.1, 0.1).
"""

from __future__ import annotations

import math

import torch

_FIELDS = ("x", "x_dot", "theta", "theta_dot")


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
