"""Hand-written CUDA kernels of the port, their build, binding and wrappers.

Each kernel's source lives in ``pql_tpu_torch/csrc/``. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface, at
first use, into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), and loaded with ``ctypes``. Nothing is built or loaded when
this module is imported.

Every wrapper follows one contract:

- on a CPU tensor it computes the kernel's plain PyTorch version;
- on a CUDA tensor it checks device, dtype, shape and contiguity, launches
  the kernel on the current stream or raises — it never falls back to the
  plain version;
- it adds one to ``LAUNCHES[name]`` where it launches the kernel, and
  nowhere else.

Kernels:

``c51_td_target`` (``csrc/c51_projection.cu``) replaces the TPU kernel
``pql_tpu/ops/pallas.py::_projection_kernel`` (launched by
``categorical_projection_pallas``; the twin ``categorical_td_target_pallas``
calls it twice and takes the min). It computes the C51 projection of both
twin target distributions and their min in one pass. On an H100 it is
bound by bytes: the inputs and output are 5.08 MB at B=8192, A=51 (1.52 us
at 3.35 TB/s). The design does O(A) work per row in the scatter form: pos is
monotone in the source atom, so each destination's sources form one run of a
walk over the row; each lane sums the runs of 7 consecutive sources in
registers, one segmented warp scan joins the runs that cross lanes, and the
last source of a run writes it (no atomics, bitwise deterministic). Each warp
owns whole rows (4 at A=51, every lane busy), stages their contiguous span
with 16-byte ``cp.async`` copies and writes its output span with 16-byte
stores (see the source's note). A block of 4 warps needs
``c51_td_target_smem_bytes(A)`` of shared memory: 23,168 B at A=51, at most
57,664 B for A <= 512. The launcher raises the kernel's dynamic limit above
48 KB itself. The wrapper refuses A whose block would exceed the 232,448 B
a block may use on sm_90.

``hand_control_step`` (``csrc/hand_step.cu``) replaces no TPU kernel (the
JAX package's hand step is plain ``jnp`` under ``jit``): it runs the hand
task's whole control step in one launch, one thread per env, where the eager
step is ~1e5 elementwise launches (the captured graph of
``envs/rigid.py::GraphedStep``). The source is the file's hand-written
skeleton around a generated header: the task's substep and the step's end,
traced from the port's algebra (``AllegroHand.kernel_programs``) and
emitted one statement per op (``physics/codegen.py``). It is built with
``HAND_STEP_FLAGS`` (no FMA contraction, so each product and sum rounds as
the eager op does), one library per generated header, cached by the digest
of the skeleton, the header and the flags. It is bound by operations, about
1e5 a thread; one thread per env leaves ~2 warps an SM at 8,192 envs.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path

import torch

from pql_tpu_torch.ops.distributional import categorical_projection, categorical_td_target
from pql_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HAND_STEP_FLAGS = NVCC_FLAGS + ("-fmad=false",)

# kernel name -> what chip_smoke.py reports about it
KERNELS = {
    "c51_td_target": dict(
        source="pql_tpu_torch/csrc/c51_projection.cu",
        replaces="pql_tpu/ops/pallas.py:28",
    ),
    "hand_control_step": dict(
        source="pql_tpu_torch/csrc/hand_step.cu",
        replaces=None,  # the JAX package's hand step is plain jnp under jit
    ),
}
GENERATED = {"hand_step"}  # sources that include a generated header, built per header
MAX_SMEM_BYTES = 232448  # shared memory one block may use on sm_90
# launches of each kernel since the last reset (plain-version calls do not count)
LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on the machine with the card")


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_kernels() -> dict[str, dict]:
    """Compile every ``csrc/*.cu`` not built yet (but those of ``GENERATED``,
    built per task by their wrapper), one nvcc per source, all started
    together. Returns {source stem: {path, seconds, ptxas}}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs, out = {}, {}
    for src in sorted(CSRC.glob("*.cu")):
        if src.stem in GENERATED:
            continue
        lib = _library_path(src)
        if lib.exists():
            out[src.stem] = dict(path=str(lib), seconds=0.0, ptxas="(already built)")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[src.stem] = (proc, tmp, lib, time.perf_counter())
    for stem, (proc, tmp, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem}.cu (rc {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        out[stem] = dict(path=str(lib), seconds=time.perf_counter() - t0, ptxas=log.strip())
    return out


@functools.cache
def _c51_lib() -> ctypes.CDLL:
    src = CSRC / "c51_projection.cu"
    if not _library_path(src).exists():
        build_kernels()
    lib = ctypes.CDLL(str(_library_path(src)))
    lib.c51_td_target.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.c51_td_target.restype = ctypes.c_int
    lib.c51_td_target_smem_bytes.argtypes = [ctypes.c_int]
    lib.c51_td_target_smem_bytes.restype = ctypes.c_int
    return lib


def _check_c51_inputs(p1, p2, reward, done) -> tuple[int, int]:
    if p1.dim() != 2:
        raise ValueError(f"c51_td_target: next_dist must be [B, A], got {tuple(p1.shape)}")
    b, a = p1.shape
    if a < 2:
        raise ValueError(f"c51_td_target: need at least 2 atoms, got {a}")
    named = [("next_dist1", p1), ("reward", reward), ("done", done)]
    if p2 is not None:
        named.append(("next_dist2", p2))
        if p2.shape != p1.shape:
            raise ValueError(f"c51_td_target: twin shapes differ: {tuple(p1.shape)} vs {tuple(p2.shape)}")
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"c51_td_target: {name} must be float32, got {t.dtype}")
        if t.device != p1.device:
            raise ValueError(f"c51_td_target: {name} is on {t.device}, next_dist1 on {p1.device}")
    for name, t in (("reward", reward), ("done", done)):
        if t.shape not in ((b,), (b, 1)):
            raise ValueError(f"c51_td_target: {name} must be [B] or [B, 1] with B={b}, got {tuple(t.shape)}")
    return b, a


def c51_td_target_plain(p1, p2, reward, done, gamma_n, v_min, v_max) -> torch.Tensor:
    """Plain PyTorch version: the dense projection of ``ops/distributional``."""
    if p2 is None:
        return categorical_projection(p1, reward, done, gamma_n, v_min, v_max)
    return categorical_td_target(p1, p2, reward, done, gamma_n, v_min, v_max)


def c51_td_target(
    p1: torch.Tensor,  # [B, A] float32 probabilities
    p2: torch.Tensor | None,  # [B, A] twin, or None for a single projection
    reward: torch.Tensor,  # [B] or [B, 1] float32
    done: torch.Tensor,  # [B] or [B, 1] float32
    gamma_n: float,
    v_min: float,
    v_max: float,
) -> torch.Tensor:
    """min(proj(p1), proj(p2)) — or proj(p1) when p2 is None — as [B, A] float32."""
    b, a = _check_c51_inputs(p1, p2, reward, done)
    if p1.device.type == "cpu":
        return c51_td_target_plain(p1, p2, reward, done, gamma_n, v_min, v_max)
    if p1.device.type != "cuda":
        raise ValueError(f"c51_td_target: unsupported device {p1.device}")
    for name, t in (("next_dist1", p1), ("next_dist2", p2), ("reward", reward), ("done", done)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"c51_td_target: {name} must be contiguous")
    lib = _c51_lib()
    smem = lib.c51_td_target_smem_bytes(a)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"c51_td_target: {a} atoms need {smem} B of shared memory per block (max {MAX_SMEM_BYTES})")
    out = torch.empty_like(p1)
    with torch.cuda.device(p1.device):
        stream = torch.cuda.current_stream(p1.device).cuda_stream
        err = lib.c51_td_target(
            p1.data_ptr(), None if p2 is None else p2.data_ptr(), reward.data_ptr(),
            done.data_ptr(), out.data_ptr(), b, a, float(gamma_n), float(v_min), float(v_max), stream,
        )
    if err != 0:
        raise RuntimeError(f"c51_td_target: kernel launch failed with cudaError {err}")
    LAUNCHES["c51_td_target"] += 1
    return out


# ------------------------------------------------------------ hand_control_step

# the hand kernel's builds in this process: digest -> {path, seconds, ptxas}
HAND_BUILDS: dict[str, dict] = {}
# each hand task's generated header, made once per task object
_HAND_HEADERS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
# builds started ahead of the first launch: digest -> the future of build_hand_step
_HAND_PENDING: dict[str, concurrent.futures.Future] = {}


def hand_block(envs: int) -> int:
    """Threads a block of hand_control_step. On an H100 at 700 W (AllegroHand,
    medians of 5 timings in turns): 8,192 envs take 1.143 ms in blocks of 128
    against 1.195 in 64 and 1.203 in 32; 16,384 envs 1.557 ms in 64 against
    1.562 in 32 and 1.574 in 128."""
    return 128 if envs <= 8192 else 64


def hand_step_header(task) -> str:
    """The generated header of ``csrc/hand_step.cu`` for ``task`` (a flat-palm
    AllegroHand or ShadowHand): the model's sizes and the two traced
    functions, one C++ statement per op. Made once per task object."""
    header = _HAND_HEADERS.get(task)
    if header is not None:
        return header
    sub, fin = task.kernel_programs["substep"], task.kernel_programs["finish"]
    m = task.model
    header = "\n".join([
        f"// Generated for {type(task).__name__} (flat palm) from the port's algebra",
        "// (pql_tpu_torch/envs/hand.py::kernel_programs, pql_tpu_torch/physics/codegen.py).",
        f"// ops: {sub.op_count()} a substep, {fin.op_count()} at the step's end",
        "#pragma once",
        f"#define HAND_NQ {m.nq}",
        f"#define HAND_NV {m.nv}",
        f"#define HAND_NC {4 * task.n_contact_pairs}",
        f"#define HAND_NU {m.nu}",
        f"#define HAND_SUBSTEPS {task.substeps}",
        "",
        sub.emit("hand_substep", dict(q="float* __restrict__ q", qd="float* __restrict__ qd",
                                      cs="float* __restrict__ cs", act="const float* __restrict__ act")),
        fin.emit("hand_finish", dict(q="const float* __restrict__ q", target="float* __restrict__ target",
                                     act="const float* __restrict__ act", draw="const float* __restrict__ draw",
                                     reward="float* __restrict__ reward", terminated="bool* __restrict__ terminated",
                                     success="float* __restrict__ success")),
    ])
    _HAND_HEADERS[task] = header
    return header


def hand_step_digest(header: str) -> str:
    src = (CSRC / "hand_step.cu").read_bytes()
    return hashlib.sha256(src + header.encode() + " ".join(HAND_STEP_FLAGS).encode()).hexdigest()[:12]


def build_hand_step(header: str) -> dict:
    """Build ``csrc/hand_step.cu`` around ``header`` with nvcc (once per
    digest; a build another process finished is reused). Returns {path,
    seconds, ptxas}: 0 s where it was built already."""
    digest = hand_step_digest(header)
    if digest in HAND_BUILDS:
        return HAND_BUILDS[digest]
    lib = BUILD_DIR / f"libhand_step-{digest}.so"
    if lib.exists():
        HAND_BUILDS[digest] = dict(path=str(lib), seconds=0.0, ptxas="(already built)")
        return HAND_BUILDS[digest]
    gen = BUILD_DIR / f"hand_step-{digest}"  # the header, kept beside the library
    gen.mkdir(parents=True, exist_ok=True)
    tmp = gen / f"hand_step_body.h.{os.getpid()}.tmp"
    tmp.write_text(header)
    os.replace(tmp, gen / "hand_step_body.h")  # whole, where another rank builds the same digest
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *HAND_STEP_FLAGS, "-I", str(gen), "-o", str(tmp), str(CSRC / "hand_step.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for hand_step.cu (rc {proc.returncode}):\n{proc.stdout[-20000:]}")
    os.replace(tmp, lib)
    HAND_BUILDS[digest] = dict(path=str(lib), seconds=time.perf_counter() - t0, ptxas=proc.stdout.strip())
    return HAND_BUILDS[digest]


@functools.cache
def _build_pool() -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="hand_step_build")


def prebuild_hand_step(task) -> None:
    """Trace and emit ``task``'s kernel here and start its nvcc build on a
    background thread, so that the build overlaps the rest of a run's
    set-up; the first launch waits for it (and raises what it raised)."""
    header = hand_step_header(task)
    digest = hand_step_digest(header)
    if digest not in HAND_BUILDS and digest not in _HAND_PENDING:
        _HAND_PENDING[digest] = _build_pool().submit(build_hand_step, header)


@functools.cache
def _hand_lib(header: str) -> ctypes.CDLL:
    pending = _HAND_PENDING.pop(hand_step_digest(header), None)
    lib = ctypes.CDLL((pending.result() if pending is not None else build_hand_step(header))["path"])
    lib.hand_control_step.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.hand_control_step.restype = ctypes.c_int
    return lib


def _check_hand_inputs(task, state, action, draw) -> int:
    m = task.model
    if len(draw) != 1:
        raise TypeError(f"hand_control_step: one draw_step draw, got {len(draw)}")
    e = action.shape[0]
    want = dict(q=(e, m.nq), qd=(e, m.nv), contact=(e, 4 * task.n_contact_pairs), target=(e, 4))
    if set(state) != set(want):
        raise KeyError(f"hand_control_step: state keys {sorted(state)}, want {sorted(want)}")
    named = [*((k, state[k], s) for k, s in want.items()), ("action", action, (e, m.nu)), ("draw", draw[0], (e, 3))]
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"hand_control_step: {name} must be {list(shape)}, got {list(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"hand_control_step: {name} must be float32, got {t.dtype}")
        if t.device != action.device:
            raise ValueError(f"hand_control_step: {name} is on {t.device}, action on {action.device}")
    return e


def hand_control_step(task, state: dict[str, torch.Tensor], action: torch.Tensor, *draw: torch.Tensor,
                      block: int | None = None):
    """One control step of the hand ``task`` (flat palm): (next_state,
    reward [E], terminated [E] bool, {"success": [E] 0/1}), as
    ``task.control_step``, which is the plain version on the CPU. On a
    CUDA device one launch of ``hand_control_step`` in blocks of ``block``
    threads (``hand_block(E)`` by default), or an error."""
    e = _check_hand_inputs(task, state, action, draw)
    if action.device.type == "cpu":
        return task.control_step(state, action, *draw)
    if action.device.type != "cuda":
        raise ValueError(f"hand_control_step: unsupported device {action.device}")
    if task.palm != "flat":
        raise ValueError(f"hand_control_step: the kernel has the flat palm only, not {task.palm!r}")
    ins = [state["q"], state["qd"], state["contact"], state["target"], action, draw[0]]
    for name, t in zip(("q", "qd", "contact", "target", "action", "draw"), ins):
        if not t.is_contiguous():
            raise ValueError(f"hand_control_step: {name} must be contiguous")
    lib = _hand_lib(hand_step_header(task))
    outs = [torch.empty_like(t) for t in ins[:4]]
    reward = torch.empty(e, dtype=torch.float32, device=action.device)
    terminated = torch.empty(e, dtype=torch.bool, device=action.device)
    success = torch.empty(e, dtype=torch.float32, device=action.device)
    with torch.cuda.device(action.device):
        stream = torch.cuda.current_stream(action.device).cuda_stream
        err = lib.hand_control_step(*(t.data_ptr() for t in (*ins, *outs, reward, terminated, success)),
                                    e, hand_block(e) if block is None else int(block), stream)
    if err != 0:
        raise RuntimeError(f"hand_control_step: kernel launch failed with cudaError {err}")
    LAUNCHES["hand_control_step"] += 1
    trace.count("env.fused_steps")
    next_state = dict(q=outs[0], qd=outs[1], target=outs[3], contact=outs[2])
    return next_state, reward, terminated, {"success": success}
