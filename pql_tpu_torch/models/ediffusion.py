"""The equivariant diffusion policy (port of pql_tpu/models/ediffusion.py).

The DDPM ε-prediction loop of ``models/diffusion.py`` with a C2-equivariant
noise net: an ``EMLP`` (``models/emlp.py``) from trivial^dim (the time
embedding) ⊕ the obs rep ⊕ the action rep (× horizon) to the action rep
(× horizon). The time embedding comes from an unconstrained MLP, which is
valid because the timestep is invariant: its features carry the trivial rep.

If the conditioning obs is transformed by g and the draws (x_T and each
step's noise) by g_act, the ε-field transforms by g_act, and since the
DDPM step is linear in (x, ε) and the clip is odd and elementwise, the
sampled action is exactly g_act-transformed.

Submodule names follow the flax modules for ``utils/convert.py``: the
policy's ``net`` is ``EquivariantDiffusionNet``, whose ``TorchLinear_0/1``
(the time MLP) are ``layers.0/1`` and whose ``EMLP_0`` is ``net``.
"""

from __future__ import annotations

import torch
from torch import nn

from pql_tpu_torch.models.diffusion import DDPMPolicy, SinusoidalPosEmb, mish
from pql_tpu_torch.models.emlp import EMLP, concat_reps, sign_rep
from pql_tpu_torch.models.mlp import Linear
from pql_tpu_torch.ops.ddpm import DDPMSchedule


def _trivial_rep(dim: int) -> tuple:
    return sign_rep((1.0,) * dim)


class EquivariantDiffusionNet(nn.Module):
    """ε-prediction EMLP on concat(t_emb, cond, x); ``gen_act`` is the rep of
    one action block, repeated ``horizon`` times (the diffusion horizon)."""

    def __init__(self, gen_obs: tuple, gen_act: tuple, horizon: int = 1, dim: int = 256, hidden_units: int = 512,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_emb = SinusoidalPosEmb(dim)
        self.layers = nn.ModuleList([Linear(dim, 4 * dim, gen, dtype), Linear(4 * dim, dim, gen, dtype)])
        act_blocks = [gen_act] * horizon
        gen_in = concat_reps(_trivial_rep(dim), gen_obs, *act_blocks)
        gen_out = concat_reps(*act_blocks) if horizon > 1 else gen_act
        self.net = EMLP(gen_in, gen_out, hidden_units, gen=gen, dtype=dtype)

    def forward(self, x, time, cond):
        t = self.layers[1](mish(self.layers[0](self.pos_emb(time))))
        return self.net(torch.cat([t.float(), cond, x], dim=-1))


class EquivariantDiffusionPolicy(DDPMPolicy):
    """A DDPM policy with an equivariant noise net; ``get_actions`` returns the
    first action block of the denoised horizon."""

    def __init__(self, gen_obs: tuple, gen_act: tuple, diffusion_iter: int = 5, horizon: int = 1,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.action_dim, self.horizon = len(gen_act), horizon
        self.sample_dim = self.action_dim * horizon
        self.net = EquivariantDiffusionNet(gen_obs, gen_act, horizon, gen=gen, dtype=dtype)
        self.sched = DDPMSchedule(diffusion_iter)
