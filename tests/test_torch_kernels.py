"""The port's C51 kernel module (pql_tpu_torch/ops/kernels.py) against the JAX package.

On the CPU the wrapper ``c51_td_target`` computes its plain version (the
dense projection); it is held against the JAX dense projection and the
Pallas kernel run in interpret mode, on the cases of
tests/test_ops.py::TestPallasProjection: B = 300 (ragged), mass
conservation, the twin min, and an integer pos; and on the edge cases the
CUDA kernel must meet: targets clipped at either end, fractional done,
A = 21 and 101, gamma = 1. Tolerance atol 1e-5 as
there: the Pallas kernel builds the support as i·Δz + v_min and the dense
paths by linspace, which differ by an ulp. Inputs are numpy, from a seed.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pql_tpu.ops.distributional import categorical_projection as jax_projection
from pql_tpu.ops.distributional import categorical_td_target as jax_td_target
from pql_tpu.ops.pallas import categorical_projection_pallas, categorical_td_target_pallas
from pql_tpu_torch.ops import kernels
from pql_tpu_torch.ops.kernels import c51_td_target, c51_td_target_plain

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, A=51, reward_scale=3.0, done_p=0.3):
    r = np.random.default_rng(seed)
    logits = r.normal(size=(2, B, A)).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    reward = (reward_scale * r.normal(size=(B, 1))).astype(np.float32)
    done = (r.uniform(size=(B, 1)) < done_p).astype(np.float32)
    return p[0].astype(np.float32), p[1].astype(np.float32), reward, done


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("mode", ["single", "twin"])
def test_ragged_batch_matches_dense_and_pallas(mode):
    """B = 300, not a multiple of the Pallas tile (test_ops.py:181-188)."""
    p1, p2, rew, done = _inputs(0, 300)
    gamma = 0.95
    if mode == "single":
        got = c51_td_target(_t(p1), None, _t(rew), _t(done), gamma, -10.0, 10.0).numpy()
        dense = np.asarray(jax_projection(jnp.asarray(p1), rew, done, gamma))
        pallas = np.asarray(categorical_projection_pallas(jnp.asarray(p1), rew, done, gamma, tile=128))
    else:
        got = c51_td_target(_t(p1), _t(p2), _t(rew), _t(done), gamma, -10.0, 10.0).numpy()
        dense = np.asarray(jax_td_target(p1, p2, rew, done, gamma, -10.0, 10.0))
        pallas = np.asarray(categorical_td_target_pallas(p1, p2, rew, done, gamma, -10.0, 10.0))
    np.testing.assert_allclose(got, dense, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_mass_conserved():
    """Row sums stay 1 (test_ops.py:190-200), single mode."""
    p1, _, rew, done = _inputs(1, 64)
    out = c51_td_target(_t(p1), None, _t(rew), _t(done), 0.99, -10.0, 10.0).numpy()
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=ATOL)
    pallas = np.asarray(categorical_projection_pallas(jnp.asarray(p1), rew, done, 0.99))
    np.testing.assert_allclose(out, pallas, atol=ATOL)


def test_twin_min():
    """min of the twin projections (test_ops.py:202-216)."""
    p1, p2, _, _ = _inputs(2, 32)
    rew, done = np.ones((32, 1), np.float32), np.zeros((32, 1), np.float32)
    got = c51_td_target(_t(p1), _t(p2), _t(rew), _t(done), 0.97, -10.0, 10.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_td_target(p1, p2, rew, done, 0.97, -10.0, 10.0)), atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(categorical_td_target_pallas(p1, p2, rew, done, 0.97, -10.0, 10.0)), atol=ATOL
    )


def test_integer_pos_puts_all_mass_on_one_atom():
    """done = 1, r = 0: pos = 25 exactly, all mass on atom 25 (test_ops.py:146-153)."""
    p1, p2, _, _ = _inputs(3, 8)
    rew, done = np.zeros((8, 1), np.float32), np.ones((8, 1), np.float32)
    want = np.zeros((8, 51), np.float32)
    want[:, 25] = 1.0
    got = c51_td_target(_t(p1), _t(p2), _t(rew), _t(done), 0.99, -10.0, 10.0).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    pallas = np.asarray(categorical_td_target_pallas(p1, p2, rew, done, 0.99, -10.0, 10.0))
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def _edge_case(case, B=64):
    """Inputs of one edge case (numpy, seeded): the function the CUDA kernel
    must compute at clipped ends, fractional done, other atom counts, gamma 1."""
    A = {"atoms_21": 21, "atoms_101": 101}.get(case, 51)
    p1, p2, rew, done = _inputs(10 + len(case), B, A)
    r = np.random.default_rng(len(case))
    far = (20.0 + 10.0 * r.uniform(size=(B, 1))).astype(np.float32)
    gamma = 1.0 if case == "gamma_one" else 0.99 ** 3
    if case == "clip_low":
        rew = -far
    elif case == "clip_high":
        rew = far
    elif case == "frac_done":
        done = r.uniform(size=(B, 1)).astype(np.float32)
    return p1, p2, rew, done, gamma


@pytest.mark.parametrize("mode", ["single", "twin"])
@pytest.mark.parametrize("case", ["clip_low", "clip_high", "frac_done", "atoms_21", "atoms_101", "gamma_one"])
def test_edge_cases_match_dense_and_pallas(case, mode):
    """Every target clipped at v_min or at v_max (|r| >= 20), done in (0, 1),
    A = 21 and 101, gamma = 1: the port against the JAX dense projection and
    the Pallas kernel in interpret mode."""
    p1, p2, rew, done, gamma = _edge_case(case)
    if mode == "single":
        got = c51_td_target(_t(p1), None, _t(rew), _t(done), gamma, -10.0, 10.0).numpy()
        dense = np.asarray(jax_projection(jnp.asarray(p1), rew, done, gamma, -10.0, 10.0))
        pallas = np.asarray(categorical_projection_pallas(jnp.asarray(p1), rew, done, gamma, -10.0, 10.0))
    else:
        got = c51_td_target(_t(p1), _t(p2), _t(rew), _t(done), gamma, -10.0, 10.0).numpy()
        dense = np.asarray(jax_td_target(p1, p2, rew, done, gamma, -10.0, 10.0))
        pallas = np.asarray(categorical_td_target_pallas(p1, p2, rew, done, gamma, -10.0, 10.0))
    assert got.shape == p1.shape
    np.testing.assert_allclose(got, dense, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    p1, p2, rew, done = _inputs(4, 16)
    before = dict(kernels.LAUNCHES)
    got = c51_td_target(_t(p1), _t(p2), _t(rew[:, 0]), _t(done[:, 0]), 0.9, -10.0, 10.0)
    want = c51_td_target_plain(_t(p1), _t(p2), _t(rew), _t(done), 0.9, -10.0, 10.0)
    assert torch.equal(got, want)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize(
    "bad",
    ["float64", "reward_shape", "twin_shape", "one_dim"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p1, p2, rew, done = (_t(x) for x in _inputs(5, 16))
    if bad == "float64":
        p1 = p1.double()
    elif bad == "reward_shape":
        rew = torch.zeros(15, 1)
    elif bad == "twin_shape":
        p2 = p2[:, :50]
    else:
        p1 = p1[0]
    with pytest.raises((TypeError, ValueError)):
        c51_td_target(p1, p2, rew, done, 0.99, -10.0, 10.0)


def _round_f32(exact):
    """A Fraction rounded to the nearest float32, ties to even."""
    near = np.float32(float(exact))
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact), int(c.view(np.uint32)) & 1))


def test_reciprocal_division_rounds_as_ieee():
    """The CUDA kernel takes pos = x / dz as y = RN(x * RN(1/dz)) corrected by
    two FMAs, y + (x - y * dz) * RN(1/dz); that rounds as IEEE division does
    (Markstein), here for every A <= 512 and x in [0, v_max - v_min]. An FMA is
    emulated in float64, where the product of two floats is exact; results
    float64 may have rounded twice are redone in exact arithmetic."""
    rng = np.random.default_rng(0)
    for A in range(2, 513):
        dz = np.float32(20.0) / np.float32(A - 1)
        inv = np.float32(1.0) / dz
        x = np.concatenate([rng.uniform(0.0, 20.0, 2000), np.arange(A) * np.float64(dz), [0.0, 20.0]])
        x = x.astype(np.float32)
        y = x * inv
        r = (x.astype(np.float64) - y.astype(np.float64) * np.float64(dz)).astype(np.float32)
        pos = (r.astype(np.float64) * np.float64(inv) + y.astype(np.float64)).astype(np.float32)
        want = x / dz
        for k in np.nonzero(pos != want)[0]:
            exact = Fraction(float(r[k])) * Fraction(float(inv)) + Fraction(float(y[k]))
            assert _round_f32(exact) == want[k], (A, float(x[k]))


def test_no_build_at_import():
    """Importing the module builds and loads nothing (this machine has no nvcc)."""
    assert kernels._c51_lib.cache_info().currsize == 0
