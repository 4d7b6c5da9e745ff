"""Point-cloud encoders (port of pql_tpu/models/pointnet.py:26-110).

Channel-last [B, N, C] clouds through per-point ``Linear``s (the
reference's kernel-1 Conv1d stacks), with a max over the points.

- ``MLP``: Linear + activation stack (flax ``TorchLinear_i`` → ``layers.i``);
- ``MultiStagePointNetEncoder``: per-point features with the max-pooled
  global context concatenated back at every stage, the stages' features
  concatenated, ``conv_out``, a max over the points. Its activation is
  flax's ``nn.leaky_relu`` with the default slope, 0.01 (the JAX comment
  calls it relu; the code is followed). Submodules keep the flax names
  ``conv_in``, ``layer_i``, ``global_i`` and ``conv_out``;
- ``StateEncoder``: the state MLP (flax ``MLP_0`` → ``mlp``);
- ``Encoder``: concat(pointnet(pc), mlp(state)) (``MultiStagePointNetEncoder_0``
  → ``pointnet``, ``MLP_0`` → ``mlp``).

Flax infers input widths at init; here they are arguments (``pc_dim``,
``state_dim``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pql_tpu_torch.models.mlp import Linear

ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu is the tanh form
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}


class MLP(nn.Module):
    """``hidden`` Linear + ``act`` layers, then Linear(out_dim) when out_dim > 0,
    then tanh when ``squash_output``."""

    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int], act: str = "relu",
                 squash_output: bool = False, gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_dim, *hidden] + ([out_dim] if out_dim > 0 else [])
        self.layers = nn.ModuleList(Linear(dims[i], dims[i + 1], gen, dtype) for i in range(len(dims) - 1))
        self.n_hidden, self.act, self.squash_output = len(hidden), ACTIVATIONS[act], squash_output

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < self.n_hidden:
                x = self.act(x)
        return torch.tanh(x) if self.squash_output else x


class MultiStagePointNetEncoder(nn.Module):
    """[B, N, pc_dim] → [B, out_channels]."""

    def __init__(self, pc_dim: int = 3, h_dim: int = 128, out_channels: int = 128, num_layers: int = 4,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.conv_in = Linear(pc_dim, h_dim, gen, dtype)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", Linear(h_dim, h_dim, gen, dtype))
            self.add_module(f"global_{i}", Linear(2 * h_dim, h_dim, gen, dtype))
        self.conv_out = Linear(h_dim * num_layers, out_channels, gen, dtype)

    def forward(self, pc):
        act = ACTIVATIONS["leaky_relu"]
        y = act(self.conv_in(pc))
        feats = []
        for i in range(self.num_layers):
            y = act(getattr(self, f"layer_{i}")(y))
            y_global = torch.amax(y, dim=-2, keepdim=True)
            y = torch.cat([y, y_global.expand_as(y)], -1)
            y = act(getattr(self, f"global_{i}")(y))
            feats.append(y)
        return torch.amax(self.conv_out(torch.cat(feats, -1)), dim=-2)


class StateEncoder(nn.Module):
    """The state MLP: hidden ``state_mlp_size[:-1]``, out ``state_mlp_size[-1]``."""

    def __init__(self, state_dim: int, state_mlp_size: Sequence[int] = (64, 64), gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_dim = state_mlp_size[-1]
        self.mlp = MLP(state_dim, state_mlp_size[-1], state_mlp_size[:-1], gen=gen, dtype=dtype)

    def forward(self, state):
        return self.mlp(state)


class Encoder(nn.Module):
    """concat(pointnet(pc) [B, pointcloud_feature_dim], mlp(state) [B, 64])."""

    def __init__(self, state_dim: int, pointcloud_feature_dim: int = 1024, state_mlp_size: Sequence[int] = (64, 64),
                 pc_dim: int = 3, gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_output_channels = pointcloud_feature_dim + state_mlp_size[-1]
        self.pointnet = MultiStagePointNetEncoder(pc_dim, out_channels=pointcloud_feature_dim, gen=gen, dtype=dtype)
        self.mlp = MLP(state_dim, state_mlp_size[-1], state_mlp_size[:-1], gen=gen, dtype=dtype)

    def forward(self, state, pc):
        return torch.cat([self.pointnet(pc), self.mlp(state)], -1)
