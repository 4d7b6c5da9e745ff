"""The port's host ring (``pql_tpu_torch/native``) against numpy and the JAX
package's ``pql_tpu.native.HostReplay``, on the CPU.

- the loader builds ``native/host_ring.cpp`` into ``build/native/`` under a
  digest name, and two processes building at once both load a whole library;
- writes that wrap, ``filled`` and ``ptr``;
- the gather bitwise equal to numpy fancy indexing of a mirror of the ring,
  with the indices of ``default_rng(seed)`` drawn slot first, then env;
- sampled batches bitwise equal to the JAX class's after the same writes,
  into new arrays and into caller-owned tensors (``out``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pql_tpu.native import HostReplay as JHostReplay
from pql_tpu_torch import native
from pql_tpu_torch.native import HostReplay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {"img": 12, "obs": 5, "done": 1}
DTYPES = {"img": np.uint8, "obs": np.float16, "done": np.float32}


def _chunk(rng, T, E, k):
    if DTYPES[k] == np.uint8:
        return rng.integers(0, 256, (T, E, FIELDS[k]), dtype=np.uint8)
    return rng.normal(size=(T, E, FIELDS[k])).astype(DTYPES[k])


def test_loader_builds_into_build_native():
    lib = native.load_host_ring()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and str(native.BUILD_DIR) == os.path.join(REPO, "build", "native")
    assert path.name.startswith("libhost_ring-") and path.suffix == ".so" and path.exists()
    assert lib._name == str(path) and native.load_host_ring() is lib
    assert native.SOURCE == native.REPO / "native" / "host_ring.cpp"


def test_two_loaders_build_at_once(tmp_path):
    """Two processes build into an empty directory at once: each loads a
    whole library, one file is left and no temporary."""
    code = ("import sys; from pathlib import Path; import pql_tpu_torch.native as n; "
            "n.BUILD_DIR = Path(sys.argv[1]); "
            "n.library_path = (lambda f: lambda: Path(sys.argv[1]) / f().name)(n.library_path); "
            "h = n.HostReplay(3, 2, {'x': 4}); print(h.filled)")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip() for o, _ in outs] == ["0", "0"]
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]


@pytest.mark.parametrize("writes", [[1] * 6, [3, 2, 4], [7]], ids=["single-slots", "chunks", "one-past-the-end"])
def test_writes_wrap(writes):
    slots, E = 4, 3
    hr = HostReplay(slots, E, {"x": 2}, {"x": np.float32})
    mirror = np.zeros((slots, E, 2), np.float32)
    ptr, total, value = 0, 0, 0.0
    for t in writes:
        chunk = (value + np.arange(t * E * 2, dtype=np.float32)).reshape(t, E, 2)
        value += chunk.size
        hr.add({"x": torch.from_numpy(chunk)})  # a CPU tensor
        for row in chunk:
            mirror[ptr] = row
            ptr = (ptr + 1) % slots
        total += t
        assert hr.filled == min(total, slots) and hr.ptr == ptr
    batch = hr.sample(256, seed=5)["x"]
    rng = np.random.default_rng(5)
    slot, env = rng.integers(0, slots, 256, dtype=np.int64), rng.integers(0, E, 256, dtype=np.int64)
    np.testing.assert_array_equal(batch, mirror[slot, env])


@pytest.mark.parametrize("seed", [0, 3])
def test_gather_matches_numpy(seed):
    """Ring of 6 slots × 5 envs, 4 slots written: every field's batch is
    the mirror's rows at default_rng(seed)'s (slot, env) pairs, bitwise,
    for three batches in a row."""
    slots, E, B = 6, 5, 64
    rng = np.random.default_rng(100 + seed)
    hr = HostReplay(slots, E, FIELDS, DTYPES)
    chunk = {k: _chunk(rng, 4, E, k) for k in FIELDS}
    hr.add(chunk)
    draw = np.random.default_rng(seed)
    for i in range(3):
        got = hr.sample(B, seed=seed if i == 0 else None)
        slot, env = draw.integers(0, 4, B, dtype=np.int64), draw.integers(0, E, B, dtype=np.int64)
        for k in FIELDS:
            assert got[k].dtype == DTYPES[k] and got[k].shape == (B, FIELDS[k])
            np.testing.assert_array_equal(got[k], chunk[k][slot, env])


@pytest.mark.parametrize("into", ["arrays", "tensors"])
def test_batches_equal_the_jax_class(into):
    """The same writes (wrapping) into both packages' rings; five batches of
    each, drawn by each ring's own default_rng(0): bitwise equal, and the
    port's ``draw_index`` repeats the JAX class's draws."""
    slots, E, B = 5, 4, 32
    rng = np.random.default_rng(7)
    port, jax_ring = HostReplay(slots, E, FIELDS, DTYPES), JHostReplay(slots, E, FIELDS, DTYPES)
    for t in (2, 3, 2):
        chunk = {k: _chunk(rng, t, E, k) for k in FIELDS}
        port.add(chunk)
        jax_ring.add(chunk)
    assert port.filled == jax_ring.filled == slots
    out = {k: torch.empty(B, d, dtype=torch.from_numpy(np.empty(0, DTYPES[k])).dtype) for k, d in FIELDS.items()}
    for _ in range(5):
        want = jax_ring.sample(B)
        got = port.sample(B, out=out) if into == "tensors" else port.sample(B)
        for k in FIELDS:
            g = got[k].numpy() if into == "tensors" else got[k]
            np.testing.assert_array_equal(g, want[k], err_msg=k)
        if into == "tensors":
            assert all(got[k] is out[k] for k in FIELDS)
    draws = np.random.default_rng(0)
    port.sample(B, seed=0)
    slot, env = port.draw_index(B)
    draws.integers(0, slots, B, dtype=np.int64), draws.integers(0, E, B, dtype=np.int64)
    np.testing.assert_array_equal(slot, draws.integers(0, slots, B, dtype=np.int64))
    np.testing.assert_array_equal(env, draws.integers(0, E, B, dtype=np.int64))


def test_out_buffers_are_checked():
    hr = HostReplay(3, 2, {"img": 4}, {"img": np.uint8})
    hr.add({"img": np.ones((1, 2, 4), np.uint8)})
    with pytest.raises(ValueError, match="contiguous CPU torch.uint8 tensor of \\(8, 4\\)"):
        hr.sample(8, out={"img": torch.empty(8, 4, dtype=torch.float16)})
    with pytest.raises(ValueError, match="contiguous CPU"):
        hr.sample(8, out={"img": torch.empty(4, 8, dtype=torch.uint8).t()})
    with pytest.raises(ValueError, match="chunk"):
        hr.add({"img": np.ones((1, 3, 4), np.uint8)})
