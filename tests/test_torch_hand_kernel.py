"""The hand's fused control-step kernel (``pql_tpu_torch/csrc/hand_step.cu``)
and the program it is generated from (``pql_tpu_torch/physics/codegen.py``,
``AllegroHand.kernel_programs``).

On the CPU:

- the traced program, run by its reference interpreter (``Program.run``),
  equals the eager step in its per-pair form bit for bit (the same torch
  calls in the same order: the trace left nothing out), and the eager
  ``control_step`` (the vectorized contact groups the CPU and the graph run)
  to rounding: the box's wrench sums its pairs left to right here and with
  ``torch.sum`` there;
- the emitted C++ source, built by a host C++ compiler as the kernel's
  skeleton allows, gives the eager step's results on the same states;
- the tracer raises on what it cannot lower, the source is the same twice,
  its op count is reported, and the routing of ``AllegroHand.dynamics``.

The states: 6 eager control steps from a reset at 64 envs (engaged
contacts), then env 0's goal set where the step will take its cube (it
succeeds and draws a new one), env 1 with the cube 1 m up (it falls) and
env 2 with a NaN angle (non-finite).

Tolerance against the eager step (``chip_smoke.hand_kernel_gaps``, which
``chip_smoke.py`` holds the kernel to as well), |got − eager| / (1 + |eager|):
1e-5 over q, the contact state and qd, but 2e-3 on the cube's six velocities: its tiny
inertia under capped finger contacts turns a rounding difference in the
summed contact torques into up to ~3e-4 of its angular velocity (tens of
rad/s), which the body-frame linear velocity shares through the spin
(2e-5 seen; chip_smoke.py allows 1e-2 on the angular velocity between the
card and the CPU); the reward 1e-5; terminated, success and the target
exact, except an env whose goal distance lies within 1e-6 of the success
tolerance. The host build's target is held to 1e-6: the host C library's
sinf and cosf round a new goal's quaternion other than torch's CPU sin and
cos, by an ulp.

On the card (marker ``gpu``, skipped without one; ``python -m pytest
tests/test_torch_hand_kernel.py -m gpu --noconftest -q``): the kernel against
the eager CUDA step at 8,192 and 16,384 envs, its launch count, and that
neither the graph nor an eager step runs where it runs. There the eager step
itself sums in other orders (its reductions, a division by a Python float
taken as a product with its reciprocal), and over thousands of envs a few
(~0.1%) sit where a contact's stick or slip, or the cube's spin, turns a
rounding difference into more than the tolerance: the kernel may have as many
such envs as the eager CPU step has against the same eager card step, and at
most 0.2% of the envs; every other env within the tolerances.

This file imports nothing of JAX.
"""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import hand_kernel_gaps
from pql_tpu_torch.envs.base import GraphedTask, VecEnv
from pql_tpu_torch.envs.hand import AllegroHand, ShadowHand, _rand_quat_s
from pql_tpu_torch.ops import kernels
from pql_tpu_torch.physics import codegen
from pql_tpu_torch.physics.dynamics import _columns, physics_substeps
from pql_tpu_torch.utils import trace

E = 64
HANDS = {"AllegroHand": AllegroHand, "ShadowHand": ShadowHand}


@pytest.fixture(autouse=True)
def _one_thread():
    # keep torch off the cores the XLA:CPU collective rendezvous of
    # neighbouring JAX tests needs (tests/conftest.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(task, seed: int, envs: int = E, steps: int = 6, dev="cpu"):
    """(state, action, draw) after ``steps`` control steps with auto-reset
    from a seeded reset under uniform actions, with env 0 at its goal, env 1
    falling and env 2 non-finite."""
    gen = torch.Generator().manual_seed(seed)
    env = VecEnv(task, envs)
    s, _ = env.reset(task.draw_reset(gen, envs).to(dev))
    for _ in range(steps):
        a = (torch.rand(envs, task.action_dim, generator=gen) * 2.0 - 1.0).to(dev)
        s, *_ = env.step(s, a, task.draw_reset(gen, envs).to(dev), task.draw_step(gen, envs).to(dev))
    state = {k: v.clone() for k, v in s.state.items()}
    action = (torch.rand(envs, task.action_dim, generator=gen) * 2.0 - 1.0).to(dev)
    draw = task.draw_step(gen, envs).to(dev)
    _plant_ends(task, state, action, draw)
    return state, action, draw


def _plant_ends(task, state, action, draw):
    """Env 0's goal where its cube will be after the step (it succeeds),
    env 1's cube 1 m up (it falls), a NaN angle in env 2 (non-finite)."""
    cq = task.cube_q
    after = task.control_step({k: v[:1] for k, v in state.items()}, action[:1], draw[:1])[0]["q"]
    state["target"][0] = after[0, cq + 3 : cq + 7]
    state["q"][1, cq + 2] = 1.0
    state["q"][2, 0] = float("nan")


def _interpret(task, state, action, draw):
    """The traced programs on CPU columns: ``substeps`` × "substep", then "finish"."""
    progs = task.kernel_programs
    cols = dict(q=_columns(state["q"]), qd=_columns(state["qd"]), cs=_columns(state["contact"]),
                act=_columns(action))
    for _ in range(task.substeps):
        cols = dict(progs["substep"].run(cols), act=cols["act"])
    fin = progs["finish"].run(dict(q=cols["q"], target=_columns(state["target"]), act=cols["act"],
                                   draw=_columns(draw)))
    stack = lambda c: torch.stack(c, -1)  # noqa: E731
    return dict(q=stack(cols["q"]), qd=stack(cols["qd"]), contact=stack(cols["cs"]), target=stack(fin["target"]),
                reward=fin["reward"][0], terminated=fin["terminated"][0], success=fin["success"][0])


def _per_pair_eager(task, state, action, draw):
    """The eager step with the per-pair contacts and ``_finish_s``: the
    torch calls the program recorded."""
    q, qd, cs = physics_substeps(task.model, state["q"], state["qd"], action, task.substeps,
                                 contact_fn=task._contact_fn_s(), contact_state=state["contact"])
    target, reward, terminated, success = task._finish_s(_columns(q), _columns(state["target"]), _columns(action),
                                                         _columns(draw))
    return dict(q=q, qd=qd, contact=cs, target=torch.stack(target, -1), reward=reward, terminated=terminated,
                success=success)


def _fields(res):
    nxt, reward, terminated, info = res
    return dict(nxt, reward=reward, terminated=terminated, success=info["success"])


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_matches_eager(task, state, got: dict, want: dict, target_atol: float = 0.0):
    """``got`` against the eager step ``want`` in every env, at the
    tolerances of ``chip_smoke.hand_kernel_gaps``; returns the largest gaps."""
    off, gaps = hand_kernel_gaps(task, state, got, want, target_atol)
    assert not off, (off, gaps)
    return gaps


SEEDS = [("AllegroHand", 0), ("AllegroHand", 1), ("AllegroHand", 2), ("ShadowHand", 0), ("ShadowHand", 1)]


@pytest.fixture(scope="module", params=SEEDS, ids=[f"{n}-{s}" for n, s in SEEDS])
def case(request):
    name, seed = request.param
    task = HANDS[name]()
    state, action, draw = _states(task, seed)
    return task, state, action, draw


def test_traced_program_equals_the_eager_step(case):
    task, state, action, draw = case
    got = _interpret(task, state, action, draw)
    pair = _per_pair_eager(task, state, action, draw)
    for k in got:
        assert torch.equal(_bits(got[k]), _bits(pair[k])), k
    want = _fields(task.control_step(state, action, draw))
    assert_matches_eager(task, state, got, want)
    assert float(got["success"][0]) == 1.0 and not bool(got["terminated"][0])
    assert torch.equal(got["target"][0], torch.stack([x[0] for x in _rand_quat_s(*draw.unbind(-1))]))
    assert bool(got["terminated"][1]) and bool(got["terminated"][2])
    assert int((got["contact"][:, 3::4] > 0.5).sum()) > 0  # engaged pairs


# ------------------------------------------------------- the emitted source


def _host_library(task, tmp_path) -> ctypes.CDLL:
    """``csrc/hand_step.cu`` around the task's generated header, built by
    the host C++ compiler (fp32, no contraction), loaded."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler"
    (tmp_path / "hand_step_body.h").write_text(kernels.hand_step_header(task))
    lib = tmp_path / "libhand_step_host.so"
    cmd = [cxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math", "-fPIC", "-shared",
           "-I", str(tmp_path), "-o", str(lib), str(kernels.CSRC / "hand_step.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = ctypes.CDLL(str(lib))
    out.hand_control_step_host.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int]
    out.hand_step_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
    return out


@pytest.mark.parametrize("name", list(HANDS))
def test_emitted_source_on_the_host_matches_the_eager_step(name, tmp_path):
    task = HANDS[name]()
    lib = _host_library(task, tmp_path)
    sizes = [ctypes.c_int() for _ in range(5)]
    lib.hand_step_sizes(*sizes)
    m = task.model
    assert [s.value for s in sizes] == [m.nq, m.nv, 4 * task.n_contact_pairs, m.nu, task.substeps]
    for seed in (3,):
        state, action, draw = _states(task, seed)
        ins = [state[k].contiguous() for k in ("q", "qd", "contact", "target")] + [action, draw]
        outs = [torch.empty_like(t) for t in ins[:4]]
        reward, success = torch.empty(E), torch.empty(E)
        terminated = torch.empty(E, dtype=torch.bool)
        assert lib.hand_control_step_host(*(t.data_ptr() for t in (*ins, *outs, reward, terminated, success)),
                                          E) == 0
        got = dict(q=outs[0], qd=outs[1], contact=outs[2], target=outs[3], reward=reward, terminated=terminated,
                   success=success)
        want = _fields(task.control_step(state, action, draw))
        assert_matches_eager(task, state, got, want, target_atol=1e-6)
        assert float(success[0]) == 1.0 and bool(terminated[1]) and bool(terminated[2])


def test_emitted_source_is_the_same_twice():
    a, b = (kernels.hand_step_header(AllegroHand()) for _ in range(2))
    lib = lambda header: kernels.library_path(kernels.CSRC / "hand_step.cu", header)  # noqa: E731
    assert a == b and lib(a) == lib(b)
    assert lib(kernels.hand_step_header(ShadowHand())) != lib(a)


@pytest.mark.parametrize("stem", ["c51_projection", "clip_adamw", "hand_step"])
def test_libraries_keep_their_paths_and_build_commands(stem, tmp_path, monkeypatch):
    """Every source's library is named as before the build paths were one:
    sha256 of the source, then for the hand its generated header, then the
    space-joined flags (the hand's with ``-fmad=false``), so a library a
    checkout has built is reused. nvcc's command (not run: a stand-in) is
    as before, with the hand's header at ``hand_step-<digest>/hand_step_body.h``."""
    src = kernels.CSRC / f"{stem}.cu"
    header = kernels.hand_step_header(AllegroHand()) if stem == "hand_step" else None
    if header is None:
        flags = kernels.NVCC_FLAGS
        digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    else:
        flags = kernels.NVCC_FLAGS + ("-fmad=false",)
        digest = hashlib.sha256(src.read_bytes() + header.encode() + " ".join(flags).encode()).hexdigest()[:12]
    assert kernels.library_path(src, header) == kernels.BUILD_DIR / f"lib{stem}-{digest}.so"
    commands = []
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", lambda cmd, **kw: commands.append(cmd))
    kernels._start_build(src, header)
    (cmd,) = commands
    gen = tmp_path / f"{stem}-{digest}"
    assert cmd[:-3] == ["nvcc", *flags, *(() if header is None else ("-I", str(gen)))]
    assert cmd[-3] == "-o" and cmd[-2].startswith(str(tmp_path / f"lib{stem}-{digest}.")) and cmd[-1] == str(src)
    assert sorted(p.name for p in tmp_path.iterdir()) == ([] if header is None else [gen.name])
    if header is not None:
        assert [p.name for p in gen.iterdir()] == ["hand_step_body.h"]
        assert (gen / "hand_step_body.h").read_text() == header


@pytest.mark.parametrize("name", list(HANDS))
def test_op_count_is_reported(name):
    task = HANDS[name]()
    sub, fin = task.kernel_programs["substep"], task.kernel_programs["finish"]
    header = kernels.hand_step_header(task)
    assert f"// ops: {sub.op_count()} a substep, {fin.op_count()} at the step's end" in header
    # one statement per live op, inputs and constants included
    assert header.count("  const ") == sum(sub.live()) + sum(fin.live())
    print(f"{name}: {sub.op_count()} ops a substep, {fin.op_count()} at the end, "
          f"{task.substeps * sub.op_count() + fin.op_count()} a control step")
    assert 5_000 < sub.op_count() < 50_000 and 50 < fin.op_count() < 1_000


# ------------------------------------------------------------- the tracer


def _sym_pair():
    prog = codegen.Program()
    return prog, prog.input("x", 2)


@pytest.mark.parametrize("case", ["tanh", "exp", "pow3", "branch", "tensor_operand", "sum", "clamp_by_column",
                                  "reflected_div", "le"])
def test_tracer_raises_on_what_it_does_not_lower(case):
    prog, (x, y) = _sym_pair()
    calls = {
        "tanh": lambda: torch.tanh(x),
        "exp": lambda: torch.exp(x),
        "pow3": lambda: x**3,
        "branch": lambda: 1.0 if x > 0.0 else 0.0,
        "tensor_operand": lambda: x * torch.ones(3),
        "sum": lambda: torch.sum(x),
        "clamp_by_column": lambda: torch.clamp(x, y, 1.0),
        "reflected_div": lambda: 1.0 / x,
        "le": lambda: x <= 1.0,
    }
    with pytest.raises((NotImplementedError, TypeError)):
        calls[case]()


def test_tracer_records_each_op_once_and_folds_constants():
    prog, (x, y) = _sym_pair()
    z = torch.where(torch.sin(x) * 2.0 - y > 0.0, torch.clamp(x, -1.0, 1.0), 0.5)
    prog.output("z", [z])
    assert [op for op, _ in prog.ops] == ["in", "in", "sin", "mul", "sub", "gt", "clamp", "where"]
    assert prog.op_count() == 6
    xs, ys = torch.randn(16), torch.randn(16)
    (got,) = prog.run(dict(x=[xs, ys]))["z"]
    assert torch.equal(got, torch.where(torch.sin(xs) * 2.0 - ys > 0.0, torch.clamp(xs, -1.0, 1.0), 0.5))
    src = prog.emit("f", dict(x="const float* x", z="float* z"))
    assert "pql_clamp(v0, -0x1.0000000000000p+0f, 0x1.0000000000000p+0f)" in src
    assert "v2 * 0x1.0000000000000p+1f" in src and "z[0] = v7;" in src


# ------------------------------------------------------------- routing


def test_cpu_dynamics_is_the_eager_step():
    task = AllegroHand()
    state, action, draw = _states(task, 5, steps=2)
    n0 = kernels.LAUNCHES["hand_control_step"]
    got, want = _fields(task.dynamics(state, action, draw)), _fields(task.control_step(state, action, draw))
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    assert kernels.LAUNCHES["hand_control_step"] == n0


@pytest.mark.parametrize("bad", ["dtype", "shape", "draws", "keys"])
def test_wrapper_checks_its_inputs(bad):
    task = AllegroHand()
    state, action, draw = _states(task, 6, steps=1)
    args = [state, action, draw]
    if bad == "dtype":
        args[1] = action.double()
    elif bad == "shape":
        args[2] = draw[:, :2]
    elif bad == "keys":
        args[0] = {k: v for k, v in state.items() if k != "target"}
    with pytest.raises((TypeError, ValueError, KeyError)):
        if bad == "draws":
            kernels.hand_control_step(task, state, action)
        else:
            kernels.hand_control_step(task, *args)


def test_bowl_palm_keeps_the_graph_path(monkeypatch):
    task = AllegroHand()
    task.palm = "bowl"
    state, action, draw = _states(task, 7, steps=1)
    seen = []
    orig = GraphedTask.dynamics
    monkeypatch.setattr(GraphedTask, "dynamics", lambda self, *a: seen.append(1) or orig(self, *a))
    monkeypatch.setattr(kernels, "hand_control_step", lambda *a, **k: pytest.fail("the kernel's wrapper ran"))
    task.dynamics(state, action, draw)
    assert seen == [1]
    with pytest.raises(ValueError):
        task._contact_fn_s()


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from pql_tpu_torch.algos.base import set_precision
    from pql_tpu_torch.cfg import make_config

    set_precision(make_config("pql"))
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("envs", [8192, 16384])
def test_kernel_matches_eager_on_card(cuda, envs):
    """From states rolled out through the kernel (auto-reset, per-step
    draws), one control step at a time: the kernel against the eager CUDA
    step; one launch and one ``env.fused_steps`` a step, no graph."""
    task = AllegroHand()
    gen = torch.Generator().manual_seed(11)
    env = VecEnv(task, envs)
    s, _ = env.reset(task.draw_reset(gen, envs).to(cuda))
    for t in range(24):
        a = (torch.rand(envs, task.action_dim, generator=gen) * 2.0 - 1.0).to(cuda)
        d = task.draw_step(gen, envs).to(cuda)
        if t in (4, 12, 23):
            st = {k: v.clone() for k, v in s.state.items()}
            if t == 23:
                _plant_ends(task, st, a, d)
            n0 = kernels.LAUNCHES["hand_control_step"]
            trace.iteration(cuda)
            got = _fields(task.dynamics(st, a, d))
            trace.iteration(cuda)
            counters = trace.recent(sync=True)[-2].counters
            assert kernels.LAUNCHES["hand_control_step"] == n0 + 1
            assert counters == {"env.fused_steps": 1}, counters
            want = _fields(task.control_step(st, a, d))
            cpu = _fields(task.control_step({k: v.cpu() for k, v in st.items()}, a.cpu(), d.cpu()))
            off, gaps = hand_kernel_gaps(task, st, got, want)
            off_cpu, _ = hand_kernel_gaps(task, st, cpu, want)
            # no farther from the eager card step than the eager CPU step is
            assert len(off) <= len(off_cpu) and len(off) <= envs // 500, (t, off, off_cpu, gaps)
            assert int((got["contact"][:, 3::4] > 0.5).sum()) > 0
        s, *_ = env.step(s, a, task.draw_reset(gen, envs).to(cuda), d)
    assert task._graphs == {}


@pytest.mark.gpu
@pytest.mark.parametrize("block", [32, 128])
def test_kernel_block_sizes_agree(cuda, block):
    task = ShadowHand()
    state, action, draw = _states(task, 8, envs=1000, steps=4, dev=cuda)
    want = _fields(kernels.hand_control_step(task, state, action, draw))
    got = _fields(kernels.hand_control_step(task, state, action, draw, block=block))
    for k in want:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.gpu
def test_bowl_hand_goes_through_the_graph_on_card(cuda):
    task = AllegroHand()
    task.palm = "bowl"
    state, action, draw = _states(task, 9, envs=512, steps=2, dev=cuda)
    n0 = kernels.LAUNCHES["hand_control_step"]
    task.dynamics(state, action, draw)
    assert (512, action.device) in task._graphs and kernels.LAUNCHES["hand_control_step"] == n0


@pytest.mark.gpu
def test_cuda_hand_step_never_runs_eagerly(cuda, monkeypatch):
    task = AllegroHand()
    state, action, draw = _states(task, 10, envs=256, steps=2, dev=cuda)
    monkeypatch.setattr(task, "control_step", lambda *a: pytest.fail("an eager step ran on the card"))
    nxt, reward, terminated, info = task.dynamics(state, action, draw)
    assert np.isfinite(reward[3:].cpu().numpy()).all() and task._graphs == {}
