"""Vision encoders and the visual Gaussian policy (port of
pql_tpu/models/visual.py:36-298).

Images arrive channel-last, [..., H, W, C], as the JAX package and the
tasks give them; the convolutions run channel-first (NCHW, cuDNN's layout)
inside, and ``ResEncoder`` turns its features back to channel-last before
the flatten that feeds its fc, so a converted fc weight needs no row
permutation. The flax rules are kept:

- ``padding="SAME"`` pads (lo, hi) = (total // 2, total − total // 2) with
  total = max((out − 1)·s + k − in, 0), out = ⌈in / s⌉: asymmetric at
  stride 2 (the 7×7/2 stem on 48 pads (2, 3), the 3×3/2 max pool on 24 (0, 1)
  with −inf, the 3×3/2 conv on 12 (0, 1); DINO's 14×14/14 patches on 48 (4,
  4), so 4×4 patches);
- ``GroupNorm(min(32, c))`` and ``LayerNorm`` with eps 1e-6; ``nn.gelu`` is
  the tanh form;
- convolution and DenseGeneral kernels start from lecun_normal (a normal
  truncated at ±2σ, σ = √(1/fan_in)/0.8796), biases and norm shifts at 0,
  norm scales at 1; ``TorchLinear``s from ``models/mlp.py``'s ``Linear``.

``ResEncoder`` runs the trunk on frame 0 under ``torch.no_grad()`` when
autograd is on: frame 0 enters only ``prev = cur − stop_gradient(conv[:, :T−1])``,
so the function and its parameter gradient are the same as one batched
pass, for half the saved activations. On the other frames it recomputes
the trunk's stem in the backward (``torch.utils.checkpoint``) rather than
keep its activations: PPOV's update at its preset (32,768 frames with a
gradient) otherwise peaks at 77 GB of the card's 80.

Submodule names follow the flax tree for ``utils/convert.py``: ``Conv_i`` →
``convs.i``, ``GroupNorm_i`` → ``gns.i``, ``_BasicBlock_i`` → ``blocks.i``,
``TorchLinear_i`` → ``layers.i``, one ``LayerNorm_0`` → ``norm`` (several:
``lns.i``), ``MultiHeadDotProductAttention_i`` → ``attn.i`` (``query``,
``key``, ``value``, ``out`` keep the flax layouts [D, heads, head_dim] and
[heads, head_dim, D]), ``ResNet18Trunk_0`` → ``trunk``; setup names as they
are (``encoder``, ``point_state_encoder``, ``trunk_fc``, ``trunk_ln``,
``pi_1``, ``pi_2``, ``pi_out``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from pql_tpu_torch.models.diffusion import LayerNorm
from pql_tpu_torch.models.distributions import diag_gaussian_entropy, diag_gaussian_logprob, diag_gaussian_sample
from pql_tpu_torch.models.mlp import Linear
from pql_tpu_torch.models.pointnet import Encoder

_TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated at ±2


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator | None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """flax ``SAME`` padding (lo, hi) of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    (hl, hh), (wl, wh) = same_pad(x.shape[-2], k, s), same_pad(x.shape[-1], k, s)
    return F.pad(x, (wl, wh, hl, hh), value=value) if hl or hh or wl or wh else x


# ---------------------------------------------------------------------------
# augmentation + positional encodings
# ---------------------------------------------------------------------------


def draw_shifts(gen: torch.Generator, batch: int, pad: int = 4) -> torch.Tensor:
    """[batch, 2] integer offsets in [0, 2·pad] for ``random_shifts_aug``."""
    return torch.randint(0, 2 * pad + 1, (batch, 2), generator=gen, device=gen.device)


def random_shifts_aug(x: torch.Tensor, shifts: torch.Tensor, pad: int = 4) -> torch.Tensor:
    """DrQ's random shift: replicate-pad x [B, H, W, C] by ``pad``, then crop
    each image at its offset ``shifts`` [B, 2] (rows, columns)."""
    b, h, w, _ = x.shape
    padded = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="replicate")
    rows = shifts[:, 0, None] + torch.arange(h, device=x.device)
    cols = shifts[:, 1, None] + torch.arange(w, device=x.device)
    return padded[torch.arange(b, device=x.device)[:, None, None], :, rows[:, :, None], cols[:, None, :]]


def fourier_encode(x: torch.Tensor, num_freqs: int, max_freq: float, include_input: bool = False) -> torch.Tensor:
    """sin ∥ cos of x · 2π · exp(linspace(0, log(max_freq), num_freqs)), / √num_freqs.
    The exponents are ``jnp.linspace``'s, k · (stop / (n − 1)) in the input's
    dtype (torch's linspace differs in the last bit, which a frequency of
    300 turns into 1e-4 of the sines)."""
    b, c = x.shape
    stop = torch.tensor(math.log(max_freq + 1e-6), dtype=x.dtype, device=x.device)
    step = stop / (num_freqs - 1) if num_freqs > 1 else torch.zeros_like(stop)
    freqs = torch.exp(torch.arange(num_freqs, dtype=x.dtype, device=x.device) * step)
    xb = x[..., None] * (2.0 * math.pi) * freqs
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], -1).reshape(b, c * 2 * num_freqs) / math.sqrt(num_freqs)
    return torch.cat([x, enc], -1) if include_input else enc


class TimestepEmbedder(nn.Module):
    """Fourier features (with the input) → LayerNorm → Linear(d_model)."""

    def __init__(self, in_dim: int, d_model: int, freq_dim: int = 128, max_freq: float = 300.0,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.freq_dim, self.max_freq = freq_dim, max_freq
        feats = in_dim * (1 + 2 * freq_dim)
        self.norm = LayerNorm(feats, dtype=dtype)
        self.layers = nn.ModuleList([Linear(feats, d_model, gen, dtype)])

    def forward(self, x):
        return self.layers[0](self.norm(fourier_encode(x, self.freq_dim, self.max_freq, include_input=True)))


class PointNetEncoderXYZ(nn.Module):
    """Per-point [64, 128, 256] Linear (+ LayerNorm) + ReLU, max over the
    points, then a projection to ``out_channels`` (+ a final LayerNorm)."""

    WIDTHS = (64, 128, 256)

    def __init__(self, pc_dim: int = 3, out_channels: int = 1024, use_layernorm: bool = False,
                 final_norm: str = "none", use_projection: bool = True, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [pc_dim, *self.WIDTHS] + ([out_channels] if use_projection else [])
        self.layers = nn.ModuleList(Linear(dims[i], dims[i + 1], gen, dtype) for i in range(len(dims) - 1))
        norms = [LayerNorm(w, dtype=dtype) for w in self.WIDTHS] if use_layernorm else []
        self.final = use_projection and final_norm == "layernorm"
        if self.final:
            norms.append(LayerNorm(out_channels, dtype=dtype))
        self.use_layernorm, self.use_projection = use_layernorm, use_projection
        if len(norms) == 1:
            self.norm = norms[0]
        elif norms:
            self.lns = nn.ModuleList(norms)

    def _norms(self) -> list:
        return [self.norm] if hasattr(self, "norm") else list(getattr(self, "lns", []))

    def forward(self, pc):
        norms, x = self._norms(), pc
        for i in range(3):
            x = self.layers[i](x)
            if self.use_layernorm:
                x = norms[i](x)
            x = F.relu(x)
        x = torch.amax(x, dim=-2)
        if not self.use_projection:
            return x
        x = self.layers[3](x)
        return norms[-1](x) if self.final else x


# ---------------------------------------------------------------------------
# conv backbones
# ---------------------------------------------------------------------------


class Conv2d(nn.Module):
    """flax ``nn.Conv`` with ``SAME`` padding on NCHW; the weight is OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, bias: bool = False,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride, self.compute_dtype = kernel, stride, dtype
        self.weight = nn.Parameter(lecun_normal_(torch.empty(out_ch, in_ch, kernel, kernel), in_ch * kernel**2, gen))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        k, s, dt = self.kernel, self.stride, self.compute_dtype
        (hl, hh), (wl, wh) = same_pad(x.shape[-2], k, s), same_pad(x.shape[-1], k, s)
        pad = hl
        if not (hl == hh == wl == wh):
            x, pad = F.pad(x, (wl, wh, hl, hh)), 0
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, stride=s, padding=pad)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=min(32, c), epsilon=1e-6)`` on NCHW;
    statistics in fp32 (or wider)."""

    def __init__(self, features: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups, self.eps, self.compute_dtype = min(32, features), eps, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.group_norm(x, self.groups, self.scale.to(x.dtype), self.bias.to(x.dtype), self.eps).to(
            self.compute_dtype)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool`` with ``SAME`` padding (the pad is −inf)."""
    return F.max_pool2d(_pad_same(x, k, s, value=float("-inf")), k, s)


class BasicBlock(nn.Module):
    """ResNet-18 basic block: 3×3 conv (stride) → GN → ReLU → 3×3 conv → GN,
    plus the skip (a 1×1 conv (stride) → GN where the shape changes), ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        convs = [Conv2d(in_ch, features, 3, stride, gen=gen, dtype=dtype), Conv2d(features, features, 3, gen=gen,
                                                                                  dtype=dtype)]
        if stride != 1 or in_ch != features:
            convs.append(Conv2d(in_ch, features, 1, stride, gen=gen, dtype=dtype))
        self.convs = nn.ModuleList(convs)
        self.gns = nn.ModuleList(GroupNorm(features, dtype=dtype) for _ in convs)

    def forward(self, x):
        y = F.relu(self.gns[0](self.convs[0](x)))
        y = self.gns[1](self.convs[1](y))
        residual = self.gns[2](self.convs[2](x)) if len(self.convs) == 3 else x
        return F.relu(residual + y)


class ResNet18Trunk(nn.Module):
    """ResNet-18's stem, layer1 and layer2: [B, C, H, W] → [B, 128, H/8, W/8]."""

    def __init__(self, in_ch: int = 3, gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList([Conv2d(in_ch, 64, 7, 2, gen=gen, dtype=dtype)])
        self.gns = nn.ModuleList([GroupNorm(64, dtype=dtype)])
        self.blocks = nn.ModuleList([BasicBlock(64, 64, gen=gen, dtype=dtype), BasicBlock(64, 64, gen=gen, dtype=dtype),
                                     BasicBlock(64, 128, 2, gen=gen, dtype=dtype),
                                     BasicBlock(128, 128, gen=gen, dtype=dtype)])

    def stem(self, x):
        return max_pool_same(F.relu(self.gns[0](self.convs[0](x))))

    def forward(self, x, checkpoint_stem: bool = False):
        """``checkpoint_stem``: keep only the stem's input for the backward and
        recompute the stem there (its 24×24 maps hold about half of the
        trunk's saved activations for an eighth of its operations)."""
        if checkpoint_stem:
            x = torch.utils.checkpoint.checkpoint(self.stem, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = self.stem(x)
        for block in self.blocks:
            x = block(x)
        return x


def trunk_out_hw(h: int, w: int) -> tuple[int, int]:
    """The trunk's output size: stem /2, pool /2, layer2 /2 (ceil each)."""
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


class ResEncoder(nn.Module):
    """Multi-camera frame-stack encoder: per camera the T frames through the
    trunk, channels conv[t] − stop_grad(conv[t−1]) beside conv[t] for t ≥ 1,
    flattened channel-last, fc → LayerNorm. [B, cams, T, H, W, C] → [B, cams·repr_dim]."""

    def __init__(self, img_shape: Sequence[int], repr_dim: int = 1024, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cams, t, h, w, c = img_shape
        self.repr_dim = repr_dim
        self.trunk = ResNet18Trunk(c, gen, dtype)
        hh, ww = trunk_out_hw(h, w)
        self.layers = nn.ModuleList([Linear(2 * (t - 1) * hh * ww * 128, repr_dim, gen, dtype)])
        self.norm = LayerNorm(repr_dim, dtype=dtype)

    def forward(self, obs, shifts: torch.Tensor | None = None):
        """``shifts`` [B·cams·T, 2], when given, apply ``random_shifts_aug``."""
        b, cams, t, h, w, c = obs.shape
        x = obs.reshape(b * cams * t, h, w, c)
        if shifts is not None:
            x = random_shifts_aug(x, shifts)
        x = x.permute(0, 3, 1, 2).reshape(b * cams, t, c, h, w)
        if torch.is_grad_enabled() and t > 1:
            with torch.no_grad():
                first = self.trunk(x[:, 0].contiguous())
            rest = self.trunk(x[:, 1:].reshape(-1, c, h, w), checkpoint_stem=True)
            conv = torch.cat([first[:, None], rest.reshape((b * cams, t - 1) + rest.shape[1:])], 1)
        else:
            conv = self.trunk(x.reshape(-1, c, h, w))
            conv = conv.reshape((b * cams, t) + conv.shape[1:])
        conv = conv.permute(0, 1, 3, 4, 2)  # channel-last [B·cams, T, h, w, c]
        cur = conv[:, 1:]
        prev = cur - conv[:, : t - 1].detach()
        feats = torch.cat([cur, prev], 1).reshape(b * cams, -1)
        return self.norm(self.layers[0](feats)).reshape(b, cams * self.repr_dim)


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` of an attention block, its kernel in the flax
    layout: ``in`` [D] → (heads, head_dim), or ``out`` (heads, head_dim) → [D]."""

    def __init__(self, shape: tuple[int, ...], fan_in: int, bias_shape: tuple[int, ...],
                 gen: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal_(torch.empty(shape), fan_in, gen))
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads)`` self-attention, as
    plain einsums: q scaled by 1/√head_dim, softmax over the keys."""

    def __init__(self, dim: int, heads: int = 6, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hd = dim // heads
        self.head_dim, self.compute_dtype = hd, dtype
        self.query = DenseGeneral((dim, heads, hd), dim, (heads, hd), gen)
        self.key = DenseGeneral((dim, heads, hd), dim, (heads, hd), gen)
        self.value = DenseGeneral((dim, heads, hd), dim, (heads, hd), gen)
        self.out = DenseGeneral((heads, hd, dim), heads * hd, (dim,), gen)

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        q, k, v = (torch.einsum("bnd,dhk->bnhk", x, m.weight.to(dt)) + m.bias.to(dt)
                   for m in (self.query, self.key, self.value))
        logits = torch.einsum("bqhk,bshk->bhqs", q / math.sqrt(self.head_dim), k)
        w = torch.softmax(logits.float(), -1).to(dt)
        y = torch.einsum("bhqs,bshk->bqhk", w, v)
        return torch.einsum("bqhk,hkd->bqd", y, self.out.weight.to(dt)) + self.out.bias.to(dt)


class DINOEncoder(nn.Module):
    """ViT-S/14-shaped patch encoder, random init only: [B, cams, H, W, C] →
    [B, cams·repr_dim]. ``pretrained=True`` raises, as the JAX one does
    (DINOv2 weights need a torch-hub download)."""

    def __init__(self, img_shape: Sequence[int], repr_dim: int = 384, patch: int = 14, depth: int = 4,
                 pretrained: bool = False, gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pretrained:
            raise NotImplementedError(
                "DINOv2 pretrained weights require a torch-hub download (reference visual.py:190) — unavailable "
                "offline; use pretrained=False (random init) or ResEncoder.")
        cams, _, _, c = img_shape
        self.repr_dim, self.patch, self.depth = repr_dim, patch, depth
        self.convs = nn.ModuleList([Conv2d(c, repr_dim, patch, patch, bias=True, gen=gen, dtype=dtype)])
        self.lns = nn.ModuleList(LayerNorm(repr_dim, dtype=dtype) for _ in range(2 * depth))
        self.attn = nn.ModuleList(Attention(repr_dim, 6, gen, dtype) for _ in range(depth))
        self.layers = nn.ModuleList(Linear(*io, gen, dtype) for _ in range(depth)
                                    for io in ((repr_dim, 4 * repr_dim), (4 * repr_dim, repr_dim)))

    def forward(self, obs):
        b, cams, h, w, c = obs.shape
        x = self.convs[0](obs.reshape(b * cams, h, w, c).permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(b * cams, -1, self.repr_dim)
        for i in range(self.depth):
            x = x + self.attn[i](self.lns[2 * i](x))
            y = F.gelu(self.layers[2 * i](self.lns[2 * i + 1](x)), approximate="tanh")
            x = x + self.layers[2 * i + 1](y)
        return x.mean(1).reshape(b, cams * self.repr_dim)


# ---------------------------------------------------------------------------
# visual policy
# ---------------------------------------------------------------------------


class DiagGaussianMLPVPolicy(nn.Module):
    """The visual Gaussian policy: camera features (encoder → trunk_fc →
    trunk_ln → ReLU) ∥ the fused point-cloud + state features → two ReLU
    layers → the mean; a state-independent fp32 ``logstd`` from
    ``init_log_std``. ``encoder_type=None`` (or no ``img_shape``) uses the
    point-state encoder alone; ``img`` is then ignored. ``img_shape`` is
    (cams, T, H, W, C) for ``resnet``, (cams, H, W, C) for ``dino``."""

    def __init__(self, state_dim: int, act_dim: int, img_shape: Sequence[int] | None = None,
                 feature_dim: int = 1024, hidden_dim: int = 512, init_log_std: float = 0.0,
                 encoder_type: str | None = "resnet", pc_dim: int = 3, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if encoder_type not in ("resnet", "dino", None):
            raise ValueError(f"Invalid encoder type: {encoder_type}")
        self.act_dim = act_dim
        self.encoder = None
        if encoder_type is not None and img_shape is not None:
            enc = ResEncoder if encoder_type == "resnet" else DINOEncoder
            self.encoder = enc(img_shape, gen=gen, dtype=dtype)
        self.point_state_encoder = Encoder(state_dim, pointcloud_feature_dim=128, pc_dim=pc_dim, gen=gen, dtype=dtype)
        in_dim = self.point_state_encoder.n_output_channels
        if self.encoder is not None:
            cams = img_shape[0]
            self.trunk_fc = Linear(cams * self.encoder.repr_dim, feature_dim, gen, dtype)
            self.trunk_ln = LayerNorm(feature_dim, dtype=dtype)
            in_dim += feature_dim
        self.pi_1 = Linear(in_dim, hidden_dim, gen, dtype)
        self.pi_2 = Linear(hidden_dim, hidden_dim, gen, dtype)
        self.pi_out = Linear(hidden_dim, act_dim, gen, dtype)
        self.logstd = nn.Parameter(torch.full((act_dim,), float(init_log_std)))

    def features(self, img, state, pc):
        h = self.point_state_encoder(state, pc)
        if self.encoder is not None:
            x = F.relu(self.trunk_ln(self.trunk_fc(self.encoder(img))))
            h = torch.cat([x, h], -1)
        return h

    def forward(self, img, state, pc):
        h = F.relu(self.pi_1(self.features(img, state, pc)))
        mean = self.pi_out(F.relu(self.pi_2(h))).float()
        return mean, self.logstd.expand_as(mean)

    def sample(self, img, state, pc, normal):
        """(action, logp, entropy) with action = mean + std · normal."""
        mean, log_std = self(img, state, pc)
        action = diag_gaussian_sample(normal, mean, log_std)
        return action, diag_gaussian_logprob(action, mean, log_std), diag_gaussian_entropy(log_std)

    def logprob_entropy(self, img, state, pc, actions):
        mean, log_std = self(img, state, pc)
        return diag_gaussian_logprob(actions, mean, log_std), diag_gaussian_entropy(log_std)
