"""Build and load the port's CUDA kernels (``kspecanal_tpu_torch/csrc``).

At the first CUDA call, :func:`load` compiles every ``csrc/*.cu`` with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface and
loads it with ``ctypes``.  The library's name carries a hash of the sources
and flags, so an edit rebuilds; the output goes to
``kspecanal_tpu_torch/build/``.  Only the installed CUDA toolkit is used.
Nothing here runs at import time, and a CPU-only run never calls it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_log = ""         # compiler output of the build this process ran
build_seconds = 0.0    # 0.0 when the library was already built


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises if neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "toolkit is needed to build kspecanal_tpu_torch/csrc")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libkspec_kernels_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> None:
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, so)


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kspec_curscan_sublane.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, ptr]
    lib.kspec_curscan_sublane.restype = i32
    _lib = lib
    return lib
