"""ctypes bindings for the native host-ingest kernels (native/iqdecode.cpp).

Builds the shared library on first use if the repo's native toolchain is
available; callers fall back to NumPy decode when the build or load fails
(io/sources.py catches ImportError/OSError).

The port's own copy of ``kspecanal_tpu.io.native_iq``: it builds and loads
the same library from the repository's ``native/`` sources.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libiqdecode.so")

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    # Always run make: it dependency-checks, so an up-to-date build is a
    # no-op and a stale .so (older sources, missing symbols) rebuilds.
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    except (subprocess.CalledProcessError, OSError) as e:
        if not os.path.exists(_LIB_PATH):
            # Surface as OSError: callers' documented fallback contract is
            # `except (OSError, ImportError)` -> NumPy reader.
            err = (e.stderr.decode(errors="replace").strip()[-200:]
                   if getattr(e, "stderr", None) else str(e))
            raise OSError(f"native iqdecode build failed: {err}") from e
    lib = ctypes.CDLL(_LIB_PATH)
    try:
        lib.iq_decode_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t, ctypes.c_int]
        lib.iq_decode_u8.restype = None
        lib.iq_split_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
        lib.iq_split_f32.restype = None
        lib.iq_split_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_int]
        lib.iq_split_u8.restype = None
    except AttributeError as e:
        # Stale prebuilt .so (older sources, make failed/unavailable):
        # surface as OSError so callers' documented
        # `except (OSError, ImportError)` fallback (NumPy path) holds —
        # mirrors _bind_stream's translation.
        raise OSError(f"native iqdecode symbols missing (stale build?): "
                      f"{e}") from e
    _lib = lib
    return lib


def decode_u8_iq(raw: np.ndarray,
                 num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 interleaved I/Q (-127 offset) -> float32 planes."""
    lib = _load()
    raw = np.ascontiguousarray(raw, np.uint8)
    n = len(raw) // 2
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    lib.iq_decode_u8(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, num_threads)
    return re, im


def split_u8_iq(raw: np.ndarray,
                num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 interleaved I/Q -> UNDECODED u8 planes (no -127; the device
    kernels decode in VMEM).  ``raw`` may be any shape whose last axis is
    the interleaved byte stream; planes halve that axis."""
    lib = _load()
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.size // 2
    out_shape = raw.shape[:-1] + (raw.shape[-1] // 2,)
    re = np.empty(n, np.uint8)
    im = np.empty(n, np.uint8)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    lib.iq_split_u8(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, num_threads)
    return re.reshape(out_shape), im.reshape(out_shape)


def split_complex64(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """complex64 array -> float32 planes via the native deinterleaver."""
    lib = _load()
    x = np.ascontiguousarray(x, np.complex64)
    n = len(x)
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    lib.iq_split_f32(
        x.view(np.float32).ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    return re, im


def _bind_stream(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_iqs_bound", False):
        return
    try:
        _bind_stream_symbols(lib)
    except AttributeError as e:
        # Stale prebuilt .so (older sources) on a machine where make is
        # unavailable: surface as OSError so callers' documented
        # `except (OSError, ImportError)` fallback (NumPy reader) holds.
        raise OSError(f"native iqstream symbols missing (stale build?): "
                      f"{e}") from e


def _bind_stream_symbols(lib: ctypes.CDLL) -> None:
    lib.iqs_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    lib.iqs_open.restype = ctypes.c_void_p
    lib.iqs_open_raw.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_int]
    lib.iqs_open_raw.restype = ctypes.c_void_p
    lib.iqs_open_at.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.c_int, ctypes.c_int, ctypes.c_size_t]
    lib.iqs_open_at.restype = ctypes.c_void_p
    lib.iqs_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                             ctypes.POINTER(ctypes.c_float)]
    lib.iqs_read.restype = ctypes.c_int
    lib.iqs_read_raw.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint8)]
    lib.iqs_read_raw.restype = ctypes.c_int
    lib.iqs_file_samples.argtypes = [ctypes.c_void_p]
    lib.iqs_file_samples.restype = ctypes.c_size_t
    lib.iqs_close.argtypes = [ctypes.c_void_p]
    lib.iqs_close.restype = None
    lib._iqs_bound = True


class IqStream:
    """Native streaming capture reader (native/iqstream.cpp): a producer
    thread decodes fixed-size blocks into a ring ahead of the consumer.
    Memory is O(block * depth) regardless of capture length; wraps at EOF.
    """

    def __init__(self, path: str, block_samples: int, depth: int = 4,
                 raw: bool = False, start_sample: int = 0):
        lib = _load()
        _bind_stream(lib)
        self._lib = lib
        self._block = block_samples
        self._h = lib.iqs_open_at(path.encode(), block_samples, depth,
                                  1 if raw else 0, start_sample)
        if not self._h:
            raise OSError(f"iqs_open failed for {path}")

    @property
    def file_samples(self) -> int:
        return int(self._lib.iqs_file_samples(self._h))

    def read_block(self) -> Tuple[np.ndarray, np.ndarray]:
        re = np.empty(self._block, np.float32)
        im = np.empty(self._block, np.float32)
        ok = self._lib.iqs_read(
            self._h,
            re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if not ok:
            raise EOFError("native IQ stream stopped")
        return re, im

    def read_block_raw(self) -> np.ndarray:
        """Next block as RAW interleaved uint8 (2*block bytes); requires a
        stream opened with ``raw=True``."""
        out = np.empty(2 * self._block, np.uint8)
        ok = self._lib.iqs_read_raw(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if not ok:
            raise EOFError("native IQ stream stopped (or not in raw mode)")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.iqs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
