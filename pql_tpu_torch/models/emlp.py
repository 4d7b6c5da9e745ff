"""G-equivariant MLPs (port of pql_tpu/models/emlp.py).

A layer keeps an unconstrained ("raw") weight and bias as its parameters and
projects them onto the equivariant subspace on every forward, so autograd,
the optimizer's moments and the gradient clip all act on the raw weight, as
in the JAX package: for a finite group G acting on row vectors as
x ↦ x @ ρ(g), the projector is the group average

    W_eq = 1/|G| Σ_g ρ_out(g) W ρ_in(g)ᵀ,    b_eq = 1/|G| Σ_g ρ_out(g) b

in the port's ``[out, in]`` weight layout (the JAX kernel is ``[in, out]``,
where the same map reads 1/|G| Σ_g ρ_in(g) w ρ_out(g)ᵀ). A store of the
projected weight would match the JAX package at init and part from it at
the first AdamW step, whose per-element scaling leaves the subspace.

- C2 (``EquivariantLinear``, ``EMLP``): the reflection of the bimanual
  tasks, given by its generator matrix; W_eq = ½(W + G_out W G_inᵀ). Hidden
  layers carry ``ceil(hidden/2)`` copies of the regular representation
  (channel pairs swapped by the generator), on which ELU is exactly
  equivariant. The invariant head pools each pair (h₀, h₁) as |t|, |s| with
  t, s = (h₀ ± h₁)/√2, all |t| first, then an unconstrained ``Linear``.
- Any finite group (``FiniteGroup``, ``GroupEquivariantLinear``,
  ``GroupEMLP``): the closure of generator matrices, index-aligned element
  lists per space, and hidden layers on the regular representation from the
  multiplication table; the invariant head sorts each regular block.

The rep helpers build generators as nested tuples; the group matrices are
non-persistent buffers, made once in ``__init__`` (they follow ``.to()`` and
stay out of the ``state_dict``). Init is ``Linear``'s U(±1/sqrt(fan_in)) from
an explicit generator; with ``dtype=torch.bfloat16`` the product runs in
bf16 and the network returns fp32 (the projection stays fp32). Submodule
names follow the flax modules for ``utils/convert.py``: ``EMLP_0`` is
``net``, ``EquivariantLinear_i`` ``net.layers.i``, the invariant head's
``TorchLinear_0`` ``net.head``.
"""

from __future__ import annotations

from math import ceil
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pql_tpu_torch.models.distributions import diag_gaussian_entropy, diag_gaussian_logprob, diag_gaussian_sample
from pql_tpu_torch.models.mlp import Linear

# ---------------------------------------------------------------------------
# representation helpers (C2: group = {identity, g}, g² = identity)
# ---------------------------------------------------------------------------


def sign_rep(signs: Sequence[float]) -> tuple:
    """Generator of a diagonal ±1 representation, as a nested tuple."""
    return tuple(map(tuple, np.diag(np.asarray(signs, np.float32))))


def perm_sign_rep(perm: Sequence[int], signs: Sequence[float] | None = None) -> tuple:
    """Generator acting on row vectors as (x @ G)[i] = sign[i] · x[perm[i]]."""
    d = len(perm)
    signs = signs if signs is not None else [1.0] * d
    m = np.zeros((d, d), np.float32)
    for i, (p, s) in enumerate(zip(perm, signs)):
        m[int(p), i] = float(s)
    return tuple(map(tuple, m))


def concat_reps(*gens: tuple) -> tuple:
    """Direct sum (block diagonal) of generators."""
    mats = [np.asarray(g, np.float32) for g in gens]
    d = sum(m.shape[0] for m in mats)
    out, o = np.zeros((d, d), np.float32), 0
    for m in mats:
        out[o : o + m.shape[0], o : o + m.shape[0]] = m
        o += m.shape[0]
    return tuple(map(tuple, out))


def regular_rep(multiplicity: int) -> tuple:
    """``multiplicity`` copies of the C2 regular representation: channel pairs
    (2i, 2i+1) swapped by the generator."""
    perm = []
    for i in range(multiplicity):
        perm += [2 * i + 1, 2 * i]
    return perm_sign_rep(perm)


def check_involution(gen: tuple) -> bool:
    g = np.asarray(gen, np.float32)
    return bool(np.allclose(g @ g, np.eye(g.shape[0]), atol=1e-6))


def cyclic_rotation2d(n: int) -> tuple:
    """Generator of Cn acting on a 2-D row vector by rotation 2π/n (exact
    signed permutation for n ∈ {1, 2, 4} up to cos(π/2)'s rounding)."""
    c, s = np.cos(2 * np.pi / n), np.sin(2 * np.pi / n)
    return tuple(map(tuple, np.array([[c, s], [-s, c]], np.float32)))


# ---------------------------------------------------------------------------
# general finite groups
# ---------------------------------------------------------------------------


class FiniteGroup:
    """A finite matrix group closed from generators, with index-aligned
    representations on several spaces.

    ``spaces`` maps a name to that space's generator list (one matrix per
    abstract generator, the same order in every space). The closure runs on
    the direct sum of all spaces (the most faithful rep at hand) and yields
    one word list; each space's elements evaluate those words in its own
    generators, so element i is the same abstract element in every space.
    """

    def __init__(self, max_order: int = 512, **spaces: Sequence[tuple]):
        if not spaces:
            raise ValueError("need at least one space of generators")
        names = list(spaces)
        n_gens = len(spaces[names[0]])
        if any(len(spaces[n]) != n_gens for n in names):
            raise ValueError("every space needs one matrix per abstract generator")
        sum_gens = [np.asarray(concat_reps(*(spaces[n][k] for n in names)), np.float64) for k in range(n_gens)]
        elems: list[np.ndarray] = [np.eye(sum_gens[0].shape[0])]
        words: list[tuple[int, ...]] = [()]

        def _find(m: np.ndarray) -> int | None:
            for i, e in enumerate(elems):
                if np.allclose(e, m, atol=1e-6):
                    return i
            return None

        frontier = [0]
        while frontier:
            new: list[int] = []
            for idx in frontier:
                for gi, g in enumerate(sum_gens):
                    m = elems[idx] @ g
                    if _find(m) is None:
                        elems.append(m)
                        words.append(words[idx] + (gi,))
                        new.append(len(elems) - 1)
                        if len(elems) > max_order:
                            raise ValueError(f"group closure exceeded max_order={max_order}")
            frontier = new

        self.order = len(elems)
        self.words = tuple(words)
        self.mul = tuple(tuple(_find(a @ b) for b in elems) for a in elems)
        if any(None in row for row in self.mul):
            raise ValueError("generators do not close into a group")
        self._elements: dict[str, tuple] = {}
        for n in names:
            gens = [np.asarray(g, np.float64) for g in spaces[n]]
            mats = []
            for w in words:
                m = np.eye(gens[0].shape[0])
                for gi in w:
                    m = m @ gens[gi]
                mats.append(m.astype(np.float32))
            self._elements[n] = tuple(tuple(map(tuple, m)) for m in mats)

    def elements(self, space: str) -> tuple:
        """Index-aligned element matrices of ``space``'s representation."""
        return self._elements[space]

    def regular_elements(self, multiplicity: int = 1) -> tuple:
        """Element matrices of ``multiplicity`` copies of the regular
        representation (channels block-major: [copy, group element];
        element j sends channel a → mul[a][j])."""
        return _regular_elements(self.mul, multiplicity)


def _regular_elements(mul: tuple, multiplicity: int) -> tuple:
    n = len(mul)
    mats = []
    for j in range(n):
        r = np.zeros((n, n), np.float32)
        for a in range(n):
            r[a, mul[a][j]] = 1.0
        if multiplicity > 1:
            r = np.kron(np.eye(multiplicity, dtype=np.float32), r)
        mats.append(r)
    return tuple(tuple(map(tuple, m)) for m in mats)


def _mats(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x, np.float32)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class GroupEquivariantLinear(Linear):
    """A linear layer constrained to the G-equivariant subspace of any finite
    group by the group average over its element lists (``elems_in`` /
    ``elems_out``: index-aligned lists of the same abstract group,
    ``FiniteGroup.elements``); the projector is orthogonal when the reps
    are (permutations, signed permutations, rotations)."""

    def __init__(self, elems_in: tuple, elems_out: tuple, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        g_in, g_out = _mats(elems_in), _mats(elems_out)
        super().__init__(g_in.shape[-1], g_out.shape[-1], gen, dtype)
        self.register_buffer("g_in", g_in, persistent=False)  # [n, d_in, d_in]
        self.register_buffer("g_out", g_out, persistent=False)  # [n, d_out, d_out]

    def projected(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(W_eq [out, in], b_eq [out]) from the raw parameters."""
        n = self.g_in.shape[0]
        w = torch.einsum("glk,kj,gij->li", self.g_out, self.weight, self.g_in) / n
        return w, torch.einsum("k,glk->l", self.bias, self.g_out) / n

    def forward(self, x):
        w, b = self.projected()
        dt = self.compute_dtype
        return F.linear(x.to(dt), w.to(dt), b.to(dt))


class EquivariantLinear(GroupEquivariantLinear):
    """C2 form of ``GroupEquivariantLinear``, from the generators alone:
    W_eq = ½(W + G_out W G_inᵀ), b_eq = ½(b + G_out b) (the exact projector
    for an orthogonal involution)."""

    def __init__(self, gen_in: tuple, gen_out: tuple, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__((gen_in,), (gen_out,), gen, dtype)

    def projected(self) -> tuple[torch.Tensor, torch.Tensor]:
        g_in, g_out = self.g_in[0], self.g_out[0]
        return 0.5 * (self.weight + g_out @ self.weight @ g_in.T), 0.5 * (self.bias + g_out @ self.bias)


class EMLP(nn.Module):
    """Equivariant MLP over C2: ``num_layers`` linear maps counting the head.

    ``out`` is a generator (equivariant head: a last ``EquivariantLinear``)
    or an int out_dim (G-invariant: pair pooling and a ``Linear`` head)."""

    def __init__(self, gen_in: tuple, out: tuple | int, hidden_units: int = 256, num_layers: int = 5,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mult = max(ceil(hidden_units / 2), 1)
        gen_h = regular_rep(self.mult)
        layers, g = [], gen_in
        for _ in range(num_layers - 1):
            layers.append(EquivariantLinear(g, gen_h, gen, dtype))
            g = gen_h
        head = None
        if isinstance(out, int):
            head = Linear(2 * self.mult, out, gen, dtype)
        else:
            layers.append(EquivariantLinear(g, out, gen, dtype))
        self.layers = nn.ModuleList(layers)
        self.head = head

    def forward(self, x):
        hidden = self.layers if self.head is not None else self.layers[:-1]
        for layer in hidden:
            x = F.elu(layer(x))
        if self.head is None:
            return self.layers[-1](x).float()
        h = x.reshape(x.shape[:-1] + (self.mult, 2))
        r = float(np.float32(1.0 / np.sqrt(2.0)))  # an fp32 constant: the pooled features are fp32
        t, s = (h[..., 0] + h[..., 1]).float() * r, (h[..., 0] - h[..., 1]).float() * r
        return self.head(torch.cat([t.abs(), s.abs()], -1)).float()


class GroupEMLP(nn.Module):
    """Equivariant MLP over any finite group (``mul``: its multiplication
    table, ``FiniteGroup.mul``). Hidden layers carry ``ceil(hidden/|G|)``
    copies of the regular representation. ``out``: an element list
    (equivariant head) or an int out_dim (invariant: each regular block
    sorted, then a ``Linear`` head)."""

    def __init__(self, elems_in: tuple, out: tuple | int, mul: tuple, hidden_units: int = 256, num_layers: int = 5,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(mul)
        self.mult = max(ceil(hidden_units / self.n), 1)
        reg = _regular_elements(mul, self.mult)
        layers, elems = [], elems_in
        for _ in range(num_layers - 1):
            layers.append(GroupEquivariantLinear(elems, reg, gen, dtype))
            elems = reg
        head = None
        if isinstance(out, int):
            head = Linear(self.mult * self.n, out, gen, dtype)
        else:
            layers.append(GroupEquivariantLinear(elems, out, gen, dtype))
        self.layers = nn.ModuleList(layers)
        self.head = head

    def forward(self, x):
        hidden = self.layers if self.head is not None else self.layers[:-1]
        for layer in hidden:
            x = F.elu(layer(x))
        if self.head is None:
            return self.layers[-1](x).float()
        h = x.reshape(x.shape[:-1] + (self.mult, self.n))
        inv = torch.sort(h, dim=-1).values.reshape(x.shape[:-1] + (self.mult * self.n,))
        return self.head(inv).float()


# ---------------------------------------------------------------------------
# model-zoo wrappers (the non-equivariant zoo's interface)
# ---------------------------------------------------------------------------


class EquivariantMLPNet(nn.Module):
    """An equivariant (or, with an int ``out``, invariant) trunk."""

    def __init__(self, gen_in: tuple, out: tuple | int, hidden_units: int = 256, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = EMLP(gen_in, out, hidden_units, gen=gen, dtype=dtype)

    def forward(self, x):
        return self.net(x)


class TanhEquivariantMLPPolicy(nn.Module):
    """tanh of an equivariant trunk (tanh is odd, so equivariance under
    signed permutations holds)."""

    def __init__(self, gen_in: tuple, gen_out: tuple, hidden_units: int = 256, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_dim = len(gen_out)
        self.net = EMLP(gen_in, gen_out, hidden_units, gen=gen, dtype=dtype)

    def forward(self, obs):
        return torch.tanh(self.net(obs))


class DiagGaussianEquivariantMLPPolicy(nn.Module):
    """``DiagGaussianMLPPolicy``'s interface with an equivariant mean and a
    state-independent fp32 ``logstd``."""

    def __init__(self, gen_in: tuple, gen_out: tuple, hidden_units: int = 256, init_log_std: float = 0.0,
                 gen: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_dim = len(gen_out)
        self.net = EMLP(gen_in, gen_out, hidden_units, gen=gen, dtype=dtype)
        self.logstd = nn.Parameter(torch.full((self.act_dim,), float(init_log_std), dtype=torch.float32))

    def forward(self, obs):
        mean = self.net(obs)
        return mean, self.logstd.expand_as(mean)

    def sample(self, obs, normal):
        """(action, logp, entropy) with action = mean + std · normal, unclipped."""
        mean, log_std = self(obs)
        action = diag_gaussian_sample(normal, mean, log_std)
        return action, diag_gaussian_logprob(action, mean, log_std), diag_gaussian_entropy(log_std)

    def logprob_entropy(self, obs, actions):
        mean, log_std = self(obs)
        return diag_gaussian_logprob(actions, mean, log_std), diag_gaussian_entropy(log_std)


class MLPCriticEquivariant(nn.Module):
    """G-invariant state-value critic V(obs) [..., 1]."""

    def __init__(self, gen_in: tuple, hidden_units: int = 256, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = EMLP(gen_in, 1, hidden_units, gen=gen, dtype=dtype)

    def forward(self, obs):
        return self.net(obs)


class DoubleQEquivariant(nn.Module):
    """Twin G-invariant Q networks on concat(obs, act); input rep obs ⊕ act."""

    def __init__(self, gen_obs: tuple, gen_act: tuple, hidden_units: int = 256, gen: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        gen_in = concat_reps(gen_obs, gen_act)
        self.net_q1 = EMLP(gen_in, 1, hidden_units, gen=gen, dtype=dtype)
        self.net_q2 = EMLP(gen_in, 1, hidden_units, gen=gen, dtype=dtype)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.net_q1(x), self.net_q2(x)

    def q_min(self, obs, act):
        q1, q2 = self(obs, act)
        return torch.minimum(q1, q2)
