"""Vision tasks (port of pql_tpu/envs/vision.py:30-180), batched over envs.

The visual agents (``algos/ppov.py``) read three views beside the flat obs,
which is the critic's privileged observation:

- ``proprio(state)``    -> [E, 6] policy-side state (the two-agent task:
  [E, 2, 6], one row per hand);
- ``pointcloud(state)`` -> [E, 40, 3] scene points in the z = 0 plane;
- ``render(state)``     -> [E, 1 cam, 2 frames, 48, 48, 3]: the previous
  and the current frame, Gaussian splats of the arm's and the target's
  points (red and green), clipped to [0, 1]. The previous frame comes from
  ``q_prev``, which the state keeps: a fresh episode starts with
  ``q_prev = q``, and ``VecEnv.step``'s auto-reset replaces it with the
  fresh episode's as it does every other field.

``_splat`` materializes [E, K, H, W] per frame, as the JAX code does.
"""

from __future__ import annotations

import math

import torch

from pql_tpu_torch.envs.bimanual import BimanualReacher
from pql_tpu_torch.envs.classic import Reacher


def _splat(grid_x: torch.Tensor, grid_y: torch.Tensor, pts: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian splats of pts [E, K, 2] summed onto the grid [H, W], clipped
    to [0, 1]: [E, H, W]."""
    d2 = (grid_x - pts[..., 0, None, None]) ** 2 + (grid_y - pts[..., 1, None, None]) ** 2
    return torch.clamp(torch.sum(torch.exp(-d2 / (2.0 * sigma**2)), dim=1), 0.0, 1.0)


def _ring(n: int, device) -> torch.Tensor:
    """[n, 2] unit vectors at angles 2πk/n (``linspace(0, 2π, n, endpoint=False)``)."""
    ang = torch.arange(n, dtype=torch.float32, device=device) * (2.0 * math.pi / n)
    return torch.stack([torch.cos(ang), torch.sin(ang)], -1)


def _with_z(pts2d: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts2d, torch.zeros_like(pts2d[..., :1])], -1)


class ReacherVision(Reacher):
    """Reacher whose policy sees proprio (6), a point cloud (40 × 3) and one
    camera's two 48 × 48 frames; the flat obs is the critic's."""

    height = 48
    width = 48
    num_cams = 1
    frames = 2
    n_link_pts = 16
    n_target_pts = 8
    proprio_dim = 6
    visual_spec = dict(img=(1, 2, 48, 48, 3), pc=(2 * 16 + 8, 3), proprio=6)
    view = 0.25  # world extent mapped onto the image

    def init_state(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        s = super().init_state(draw)
        s["q_prev"] = s["q"].clone()
        return s

    def dynamics(self, state: dict[str, torch.Tensor], action: torch.Tensor):
        nxt, reward, terminated, info = super().dynamics({k: v for k, v in state.items() if k != "q_prev"}, action)
        nxt["q_prev"] = state["q"]
        return nxt, reward, terminated, info

    # ------------------------------------------------------------ geometry

    def _link_points(self, q: torch.Tensor) -> torch.Tensor:
        """Points along both links [E, 2·n_link_pts, 2]."""
        q0, q01 = q[:, 0], q[:, 0] + q[:, 1]
        elbow = self.link1 * torch.stack([torch.cos(q0), torch.sin(q0)], -1)
        tip = elbow + self.link2 * torch.stack([torch.cos(q01), torch.sin(q01)], -1)
        t = torch.linspace(0.0, 1.0, self.n_link_pts, device=q.device)[:, None]
        seg1 = t * elbow[:, None]
        seg2 = elbow[:, None] + t * (tip - elbow)[:, None]
        return torch.cat([seg1, seg2], 1)

    def _target_points(self, target: torch.Tensor) -> torch.Tensor:
        return target[:, None] + 0.01 * _ring(self.n_target_pts, target.device)

    # ------------------------------------------------------------- contract

    def proprio(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([torch.cos(state["q"]), torch.sin(state["q"]), state["qd"]], -1)

    def pointcloud(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        return _with_z(torch.cat([self._link_points(state["q"]), self._target_points(state["target"])], 1))

    def _frame(self, q: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """[E, H, W, 3]: the arm's splats, the target's, and a zero channel."""
        ys = torch.linspace(-self.view, self.view, self.height, device=q.device)
        xs = torch.linspace(-self.view, self.view, self.width, device=q.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        sigma = 2.0 * self.view / self.height
        arm = _splat(gx, gy, self._link_points(q), sigma)
        tgt = _splat(gx, gy, self._target_points(target), sigma)
        return torch.stack([arm, tgt, torch.zeros_like(arm)], -1)

    def render(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        prev = self._frame(state["q_prev"], state["target"])
        cur = self._frame(state["q"], state["target"])
        return torch.stack([prev, cur], 1)[:, None]


class BimanualReacherVision(BimanualReacher):
    """The two-agent task with per-hand proprio [E, 2, 6] (local frames) and
    a shared world-frame cloud [E, 40, 3]: per arm 8 points on each link and
    4 around its target. The JAX task wraps a ``BimanualReacher``; this one
    inherits its dynamics, obs, spec and symmetry."""

    proprio_dim = 6
    n_pts = 40
    visual_spec = dict(pc=(40, 3), proprio=6)

    def proprio(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        q = state["q"]
        return torch.cat([torch.cos(q), torch.sin(q), state["qd"]], -1)

    def pointcloud(self, state: dict[str, torch.Tensor]) -> torch.Tensor:
        q_all, dev = state["q"], state["q"].device
        s = torch.linspace(0.0, 1.0, 8, device=dev)[:, None]
        ring = 0.01 * _ring(4, dev)
        pts = []
        for arm in range(2):
            handed = 1.0 if arm == 0 else -1.0
            base_x = handed * self.base_half_gap
            q = q_all[:, arm]
            elbow = torch.stack([base_x + handed * self.link1 * torch.cos(q[:, 0]), self.link1 * torch.sin(q[:, 0])], -1)
            tip_l = self._tip_local(q)
            tip = torch.stack([base_x + handed * tip_l[:, 0], tip_l[:, 1]], -1)
            base = torch.tensor([base_x, 0.0], device=dev)
            pts.append(base + s * (elbow - base)[:, None])
            pts.append(elbow[:, None] + s * (tip - elbow)[:, None])
            tgt_l = state["target"][:, arm]
            tgt = torch.stack([base_x + handed * tgt_l[:, 0], tgt_l[:, 1]], -1)
            pts.append(tgt[:, None] + ring)
        return _with_z(torch.cat(pts, 1))
