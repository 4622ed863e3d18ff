"""Build and load the port's CUDA kernels (``kspecanal_tpu_torch/csrc``).

At the first CUDA call, :func:`load` compiles every ``csrc/*.cu`` with
``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started together),
links the objects into one shared library with a plain C interface and
loads it with ``ctypes``.  The library's name carries a hash of the sources
and flags, so an edit rebuilds; the output goes to
``kspecanal_tpu_torch/build/``.  Only the installed CUDA toolkit is used.
Nothing here runs at import time, and a CPU-only run never calls it.
:func:`load_variant` builds a forensic library of some sources with extra
``-D`` flags beside it (``ops/cuda_tc.stage_library``,
``scripts/tc_stages.py``); :func:`build` compiles the library and any such
variants that are not built yet at once, one ``nvcc`` per source and
variant, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_variants: dict = {}   # (names, defines) -> the loaded forensic library
build_log = ""         # compiler output of the build this process ran
build_seconds = 0.0    # 0.0 when the library was already built
build_job_seconds: dict = {}   # library path -> s until its last compile


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


def _run_all(cmds):
    """Run the commands at once; raise with the output of the first that
    fails.  Returns their combined output and each one's seconds from the
    common start to its end."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, ends = [None] * len(procs), [0.0] * len(procs)

    def wait(i):
        outs[i] = procs[i].communicate()[0]
        ends[i] = time.perf_counter() - t0
    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(len(procs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{o}")
    return "".join(outs), ends


def _compile(so: Path, sources=None, flags=()) -> None:
    """Build the library ``so`` of ``sources`` (default every ``csrc/*.cu``)
    with the extra nvcc ``flags``."""
    _compile_many([(so, _sources() if sources is None else sources, flags)])


def _compile_many(jobs) -> None:
    """Build each ``(so, sources, flags)`` of ``jobs``: every object of
    every job compiled at once, then the links."""
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    plans = []
    for so, sources, flags in jobs:
        tag = f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        plans.append((so, sources, flags, objs,
                      so.with_name(f"{so.name}.{os.getpid()}.tmp")))
    t0 = time.perf_counter()
    try:
        build_log, ends = _run_all([
            [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(o), str(src)]
            for _, sources, flags, objs, _ in plans
            for src, o in zip(sources, objs)])
        build_log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                                *(str(o) for o in objs)]
                               for _, _, _, objs, tmp in plans])[0]
        for so, sources, _, _, _ in plans:
            build_job_seconds[so] = max(ends[:len(sources)])
            ends = ends[len(sources):]
        for so, _, _, _, tmp in plans:
            os.replace(tmp, so)
    finally:
        for _, _, _, objs, tmp in plans:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
        build_seconds = time.perf_counter() - t0


def _variant(names, defines):
    """``(library path, sources, flags)`` of a forensic build."""
    flags = tuple(f"-D{d}" for d in defines)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return (BUILD_DIR / f"libkspec_variant_{h.hexdigest()[:16]}.so",
            [CSRC_DIR / n for n in names], flags)


def build(variants=(), library: bool = True) -> None:
    """Compile, all at once, the kernels' library (where ``library``) and
    the forensic ``variants`` (``(names, defines)`` pairs, as
    :func:`load_variant` takes them) that are not built yet."""
    jobs = [(library_path(), _sources(), ())] if library else []
    jobs += [_variant(names, defines) for names, defines in variants]
    jobs = [j for j in dict((j[0], j) for j in jobs).values()
            if not j[0].exists()]
    if jobs:
        _compile_many(jobs)


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    _lib = _declare(ctypes.CDLL(str(library_path())))
    return _lib


def load_variant(names, defines) -> ctypes.CDLL:
    """A forensic library of the ``csrc`` sources ``names`` compiled with
    ``-D`` each of ``defines`` (e.g. ``("KSPEC_TC_STOP=1",)``), built on
    first use under a name hashed from their text and the flags, and kept
    for the process (a launch pays no lookup)."""
    key = (tuple(names), tuple(defines))
    if key not in _variants:
        build([(names, defines)], library=False)
        _variants[key] = _declare(
            ctypes.CDLL(str(_variant(names, defines)[0])), missing_ok=True)
    return _variants[key]


# Entries only a forensic build holds (K2's parent form,
# -DKSPEC_PACKED_PARENT=1).
_FORENSIC_ONLY = ("kspec_curscan_packed_parent",
                  "kspec_curscan_packed_parent_attrs")


def _declare(lib: ctypes.CDLL, missing_ok: bool = False) -> ctypes.CDLL:
    """Set the C entry points' argument and result types (those ``lib``
    has, where ``missing_ok``)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    types = {
        "kspec_curscan_sublane": [ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr,
                                  i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_packed": [
            ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_fft": [
            ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_packed_parent": [
            ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_packed_attrs": [i32, i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_packed_parent_attrs": [i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_fft_attrs": [i32, i32, ptr],
        "kspec_curscan_tc": [
            ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_tc_ablate": [
            ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_packed_tc": [
            ptr, ptr, i32, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_packed_tc_smem": [i32, i32, i32, i32],
        "kspec_curscan_packed_tc_occupancy": [i32, i32, i32, i32, i32],
        "kspec_curscan_tc_smem": [i32, i32, i32, i32],
        "kspec_curscan_tc_occupancy": [i32, i32, i32, i32, i32],
        "kspec_curscan_tc_split": [
            ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_tc_split_ablate": [
            ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr],
        "kspec_curscan_tc_split_mt": [i32, i32, i32, i32],
        "kspec_curscan_tc_split_smem": [i32, i32, i32, i32],
        "kspec_curscan_tc_split_occupancy": [i32, i32, i32, i32, i32],
    }
    restypes = {"kspec_curscan_tc_smem": ctypes.c_longlong,
                "kspec_curscan_packed_tc_smem": ctypes.c_longlong,
                "kspec_curscan_tc_split_smem": ctypes.c_longlong}
    for name, args in types.items():
        if (missing_ok or name in _FORENSIC_ONLY) and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = restypes.get(name, i32)
    return lib

