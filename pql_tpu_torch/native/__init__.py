"""The host ring of the port, bound through ctypes (port of
pql_tpu/native/__init__.py:34-84).

``load_host_ring`` builds ``native/host_ring.cpp`` (the repo's one C++
source, shared with the JAX package) with g++ and the JAX loader's flags
into ``build/native/libhost_ring-<digest>.so``. The digest covers the
source, the flags and the build host's name (``-march=native`` ties the
library to the CPU it was built on). The library is written beside its
final name and renamed into place, so two processes that build at once
never load a half-written file. The JAX loader's ``native/libhost_ring.so``
is never written or read here.

``HostReplay`` (``native/host_replay.py``) is the ring over named fields.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "host_ring.cpp"
BUILD_DIR = REPO / "build" / "native"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where this source, these flags and this host's CPU build the library."""
    key = SOURCE.read_bytes() + " ".join(FLAGS).encode() + platform.node().encode()
    return BUILD_DIR / f"libhost_ring-{hashlib.sha256(key).hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE} (rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_host_ring() -> ctypes.CDLL:
    """The host ring's library (built on first use), with the five C
    functions' argument and return types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.host_ring_create.restype = ptr
        lib.host_ring_create.argtypes = [i64, i64, i64, ctypes.c_int]
        lib.host_ring_destroy.argtypes = [ptr]
        lib.host_ring_ptr.restype = i64
        lib.host_ring_ptr.argtypes = [ptr]
        lib.host_ring_filled.restype = i64
        lib.host_ring_filled.argtypes = [ptr]
        lib.host_ring_write.argtypes = [ptr, ptr, i64]
        lib.host_ring_gather.argtypes = [ptr, ctypes.POINTER(i64), ctypes.POINTER(i64), i64, ptr]
        _lib = lib
        return lib


from pql_tpu_torch.native.host_replay import HostReplay  # noqa: E402

__all__ = ["HostReplay", "build", "library_path", "load_host_ring"]
