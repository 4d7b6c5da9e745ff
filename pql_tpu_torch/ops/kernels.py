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
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from pql_tpu_torch.ops.distributional import categorical_projection, categorical_td_target

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> what chip_smoke.py reports about it
KERNELS = {
    "c51_td_target": dict(
        source="pql_tpu_torch/csrc/c51_projection.cu",
        replaces="pql_tpu/ops/pallas.py:28",
    ),
}
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
    """Compile every ``csrc/*.cu`` not built yet, one nvcc per source, all
    started together. Returns {source stem: {path, seconds, ptxas}}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs, out = {}, {}
    for src in sorted(CSRC.glob("*.cu")):
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
