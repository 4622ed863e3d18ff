"""Packed tiny-FFT curscan on the card: the wrapper of the hand-written CUDA
kernel ``csrc/curscan_packed.cu``, the port of
``kspecanal_tpu.ops.pallas_curscan.curscan_fused_packed`` (the Pallas kernel
``_kernel_packed``) for fft_size <= 128 dividing 128 (quickFullScan runs 64).

Per IQ block ``(full_size,)`` the kernel runs every window's FFT in the
registers of a group of lanes (the window and ``winAdj*2/N`` applied at the
load), takes ``|.|``, folds the windows (AVG/RAW weighted sum, MAX/MIN
extrema) and writes the fftshifted ``(fft_size,)`` spectrum; u8 planes decode
in its loads.  The dispatcher sends it tpuPrecision HIGHEST (HIGH and
DEFAULT run the tensor-core packed kernel of ``ops/cuda_tc.py``).  Its FFT
runs in float64 and its folds in float32: float32 butterflies miss the
per-bin bound on MIN folds over hundreds of windows (see the source note).
:func:`launch_plan` splits the work: lane groups per IQ block, IQ blocks per
thread block, windows per staged chunk.

For a CUDA tensor :func:`curscan_fused_packed` launches the kernel or raises;
for a CPU tensor it runs :func:`curscan_fused_packed_plain` and never builds
anything.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from kspecanal_tpu_torch.config import (SpecConfig, cumu_weights, win_adj,
                                        window_lut)
from kspecanal_tpu_torch.ops import spectrum
from kspecanal_tpu_torch.ops.cuda_curscan import _FOLD, check_planes

_LANES = 128
THREADS = 256                       # the kernel's threads per block
# Points a lane P and lanes a window L, by fft size (N = P * L).
SPLIT = {2: (2, 1), 4: (4, 1), 8: (8, 1), 16: (16, 1), 32: (8, 4),
         64: (8, 8), 128: (16, 8)}
H100_SMS = 132
# Staged bytes of a thread block: the whole span in one buffer if it fits,
# else chunks of half of it, double-buffered.
STAGE_BYTES = 64 << 10

launches = 0


class Plan(NamedTuple):
    """How one launch splits the work (``csrc/curscan_packed.cu``)."""
    p: int          # points a lane
    lanes: int      # lanes a window
    groups: int     # lane groups sharing an IQ block
    blocks: int     # IQ blocks of one thread block
    chunk: int      # windows a staged chunk
    n_chunks: int
    stride: int     # samples a staged plane row (the widest chunk span)


def supports_fused_packed(cfg: SpecConfig) -> bool:
    """The JAX predicate (fft_size <= 128 dividing 128, full_size a multiple
    of 128 and >= 256) without its VMEM clause: that clause bounds Mosaic's
    8-block tile of lane-shifted views, and the kernel here stages any block
    in chunks, so it needs no size clause of its own."""
    n = cfg.fft_size
    return (n <= _LANES and _LANES % n == 0
            and cfg.full_size % _LANES == 0
            and cfg.full_size >= 2 * _LANES)


def chunk_spans(starts, n: int, chunk: int, align: int) -> np.ndarray:
    """Staged samples of each chunk of ``chunk`` windows: from the first
    start rounded down to ``align`` samples (16 bytes) to the last window's
    end rounded up."""
    st = np.asarray(starts, np.int64)
    first = st[0::chunk]
    last = st[np.minimum(np.arange(1, len(first) + 1) * chunk, len(st)) - 1]
    return (-(-(last + n) // align) * align) - first // align * align


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, starts: tuple, t: int, u8: bool,
                sms: int = H100_SMS) -> Plan:
    """Groups G: the smallest power of two that gives two waves of 2048
    threads on each of the card's ``sms`` SMs over T IQ blocks, at most one
    window a group and
    ``THREADS / L`` (one IQ block a thread block); the thread block then
    holds ``THREADS / L / G`` IQ blocks.  Chunks: all windows at once when
    their span fits ``STAGE_BYTES``, else the most windows (a multiple of G
    where G windows fit) whose widest span fits half of it, so a thread
    block stages at most about 80 KiB whatever ``full_size`` is."""
    p, lanes = SPLIT[n]
    w = len(starts)
    sb = 1 if u8 else 4
    align = 16 // sb
    need = -(-(2 * sms * 2048) // max(1, t * lanes))
    groups = min(THREADS // lanes, 1 << (w.bit_length() - 1),
                 1 << (need - 1).bit_length())
    blocks = THREADS // lanes // groups
    row_bytes = blocks * 2 * sb           # bytes a staged sample costs

    def fits(chunk, budget):
        return chunk_spans(starts, n, chunk, align).max() * row_bytes \
            <= budget

    def most(hi, step):
        """The largest m in [1, hi] with m * step windows fitting half the
        budget (1 if none does)."""
        lo = 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if fits(mid * step, STAGE_BYTES // 2):
                lo = mid
            else:
                hi = mid - 1
        return lo

    chunk = w
    if not fits(w, STAGE_BYTES):
        if fits(groups, STAGE_BYTES // 2):
            chunk = most(-(-w // groups) - 1, groups) * groups
        else:       # hops far beyond N (curScanNonOverlap > 1)
            chunk = most(groups - 1, 1)
    stride = int(chunk_spans(starts, n, chunk, align).max())
    return Plan(p, lanes, groups, blocks, chunk, -(-w // chunk), stride)


def curscan_fused_packed_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                               cfg: SpecConfig) -> torch.Tensor:
    """The plain PyTorch version of the kernel: decode u8, then the
    ``torch.fft`` curscan chain.  ``(T, full_size)`` -> ``(T, fft_size)``."""
    return spectrum.curscan_batched(spectrum.decode_u8(iq_re),
                                    spectrum.decode_u8(iq_im), cfg)


@functools.lru_cache(maxsize=32)
def _tables(n: int, window: str, starts: tuple, mode: str,
            device: torch.device):
    """Device tables of one config: int32 starts, float32 per-window
    weights (the closed-form decay weights for AVG/RAW, ones for MAX/MIN),
    and in float64 the window times ``winAdj*2/N`` and the twiddles
    ``exp(-2 pi i m/n)`` as (re, im) pairs."""
    w = cumu_weights(mode, len(starts))
    weights = np.ones(len(starts)) if w is None else w
    wscale = window_lut(window, n) * (win_adj(window, n) * 2.0 / n)
    tw = np.exp(-2j * np.pi * np.arange(n) / n)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(device)

    return (dev(starts, np.int32), dev(weights, np.float32),
            dev(wscale, np.float64),
            dev(np.stack([tw.real, tw.imag], axis=-1), np.float64))


@functools.lru_cache(maxsize=64)
def _launch_args(cfg: SpecConfig, t: int, u8: bool, device: torch.device):
    """The device tables and the integer arguments after ``full_size`` of
    one launch, computed once per config and T (``cfg.window_starts`` is a
    Python loop, the bulk of a small launch's host time otherwise)."""
    n, starts = cfg.fft_size, cfg.window_starts
    plan = launch_plan(n, starts, t, u8, torch.cuda.get_device_properties(
        device).multi_processor_count)
    return (_tables(n, cfg.window, starts, cfg.cur_scan_cumu_mode, device),
            (n, len(starts), _FOLD[cfg.cur_scan_cumu_mode], plan.groups,
             plan.chunk, plan.n_chunks, plan.stride))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernel copies 16 bytes at a time: a plane whose data does not
    start on 16 bytes is copied first."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def curscan_fused_packed(iq_re: torch.Tensor, iq_im: torch.Tensor,
                         cfg: SpecConfig) -> torch.Tensor:
    """``(T, full_size)`` float32 or raw-u8 planes -> ``(T, fft_size)``
    fftshifted linear spectra, in float64 at every class.  CUDA tensors
    launch the kernel on the current stream without synchronising; CPU
    tensors run the plain version."""
    global launches
    if not supports_fused_packed(cfg):
        raise ValueError(f"config not supported by the packed curscan "
                         f"kernel (fft_size {cfg.fft_size}, full_size "
                         f"{cfg.full_size})")
    check_planes(iq_re, iq_im, cfg)
    dev = iq_re.device
    if dev.type == "cpu":
        return curscan_fused_packed_plain(iq_re, iq_im, cfg)
    if dev.type != "cuda":
        raise ValueError(f"no curscan kernel for device {dev}")
    from kspecanal_tpu_torch.ops import _build
    lib = _build.load()
    t, n = iq_re.shape[0], cfg.fft_size
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    iq_re, iq_im = _aligned(iq_re), _aligned(iq_im)
    u8 = iq_re.dtype == torch.uint8
    tables, args = _launch_args(cfg, t, u8, dev)
    with torch.cuda.device(dev):
        err = lib.kspec_curscan_packed(
            iq_re.data_ptr(), iq_im.data_ptr(), int(u8), out.data_ptr(),
            *(x.data_ptr() for x in tables), t, cfg.full_size, *args,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"curscan_packed kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
