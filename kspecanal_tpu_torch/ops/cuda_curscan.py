"""Fused curscan on the card: the wrapper of the hand-written CUDA kernel
``csrc/curscan_sublane.cu``, the port of
``kspecanal_tpu.ops.pallas_curscan.curscan_fused_sublane`` (the sublane
Pallas kernel, ``_kernel_sublane``).  It also serves the one cell of the lane
kernel ``_kernel`` (``curscan_fused``: float32, fft >= 16384, 128-aligned
starts), whose function it computes in another layout.

Per IQ block ``(full_size,)`` the kernel frames at every window start,
decodes u8 planes in its loads, windows, runs the two-stage DFT
(``n1 x 128``), takes ``|.|``, folds the windows (AVG/RAW weighted sum,
MAX/MIN extrema, ``winAdj*2/N`` folded in) and writes the natural-order,
fftshifted ``(fft_size,)`` spectrum.  It computes in float32 at every
``tpuPrecision``, with float64 DFT sums above fft 8192.

For a CUDA tensor :func:`curscan_fused_sublane` launches the kernel or
raises; for a CPU tensor it runs :func:`curscan_fused_sublane_plain`, the
``torch.fft`` chain, and never builds anything.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from kspecanal_tpu.config import (CUMU_AVG, CUMU_MAX, CUMU_MIN, CUMU_RAW,
                                  SpecConfig, cumu_weights, win_adj,
                                  window_lut)
from kspecanal_tpu_torch.ops import spectrum

_N2 = 128
# Shared memory of one thread block: the windowed frame (N float2) plus up
# to 32 stage-1 rows and the two root tables, (32 * 128 + N/128 + 128)
# complex values of 8 bytes (float32 sums, fft <= 8192) or 16 bytes (float64
# sums above).  fft 16384 needs 200,704 of the 232,448 bytes a Hopper block
# may use; 32768 would need 333,824, so 16384 is the largest power of two the
# kernel takes.
MAX_FFT_SIZE = 16384
_FOLD = {CUMU_AVG: 0, CUMU_RAW: 0, CUMU_MAX: 1, CUMU_MIN: 2}

launches = 0


def supports_fused_sublane(cfg: SpecConfig) -> bool:
    """The JAX predicate (fft_size a multiple of 128 with n1 >= 2,
    full_size a multiple of 128; window starts may be any static offsets)
    plus this kernel's shared-memory limit, ``fft_size <= MAX_FFT_SIZE``.
    Larger ffts take the ``torch.fft`` chain."""
    n = cfg.fft_size
    if n % _N2 or n // _N2 < 2 or n > MAX_FFT_SIZE:
        return False
    return cfg.full_size % _N2 == 0


def curscan_fused_sublane_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                                cfg: SpecConfig) -> torch.Tensor:
    """The plain PyTorch version of the kernel: decode u8, then the
    ``torch.fft`` curscan chain.  ``(T, full_size)`` -> ``(T, fft_size)``."""
    return spectrum.curscan_batched(spectrum.decode_u8(iq_re),
                                    spectrum.decode_u8(iq_im), cfg)


@functools.lru_cache(maxsize=32)
def _tables(n: int, window: str, starts: tuple, mode: str,
            device: torch.device):
    """Device tables of one config: int32 starts, float32 per-window
    weights (the closed-form decay weights times winAdj*2/N, built in
    float64 and rounded once, as the JAX kernel does; MAX/MIN carry the
    scale alone), the window and the N roots of unity."""
    scale = win_adj(window, n) * 2.0 / n
    w = cumu_weights(mode, len(starts))
    weights = np.full(len(starts), scale) if w is None else w * scale
    roots = np.exp(-2j * np.pi * np.arange(n) / n)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(device)

    return (dev(starts, np.int32), dev(weights, np.float32),
            dev(window_lut(window, n), np.float32),
            dev(np.stack([roots.real, roots.imag], axis=-1), np.float32))


def check_planes(iq_re: torch.Tensor, iq_im: torch.Tensor, cfg: SpecConfig):
    """Raise unless the planes are what a curscan kernel takes: both float32
    or both uint8, one device, contiguous ``(T, full_size)``."""
    if iq_re.dtype not in (torch.float32, torch.uint8) \
            or iq_im.dtype != iq_re.dtype:
        raise TypeError(f"planes must both be float32 or both uint8, got "
                        f"{iq_re.dtype} and {iq_im.dtype}")
    if iq_re.device != iq_im.device:
        raise ValueError(f"planes on different devices: {iq_re.device}, "
                         f"{iq_im.device}")
    want = (iq_re.shape[0] if iq_re.dim() == 2 else -1, cfg.full_size)
    if iq_re.shape != want or iq_im.shape != iq_re.shape:
        raise ValueError(f"planes must be (T, {cfg.full_size}), got "
                         f"{tuple(iq_re.shape)} and {tuple(iq_im.shape)}")
    if not (iq_re.is_contiguous() and iq_im.is_contiguous()):
        raise ValueError("planes must be contiguous")


def curscan_fused_sublane(iq_re: torch.Tensor, iq_im: torch.Tensor,
                          cfg: SpecConfig) -> torch.Tensor:
    """``(T, full_size)`` float32 or raw-u8 planes -> ``(T, fft_size)``
    fftshifted linear spectra.  CUDA tensors launch the kernel on the
    current stream without synchronising; CPU tensors run the plain
    version."""
    global launches
    if not supports_fused_sublane(cfg):
        raise ValueError(f"config not supported by the sublane curscan "
                         f"kernel (fft_size {cfg.fft_size}, full_size "
                         f"{cfg.full_size})")
    check_planes(iq_re, iq_im, cfg)
    dev = iq_re.device
    if dev.type == "cpu":
        return curscan_fused_sublane_plain(iq_re, iq_im, cfg)
    if dev.type != "cuda":
        raise ValueError(f"no curscan kernel for device {dev}")
    from kspecanal_tpu_torch.ops import _build
    lib = _build.load()
    t, n = iq_re.shape[0], cfg.fft_size
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    starts, weights, window, roots = _tables(
        n, cfg.window, cfg.window_starts, cfg.cur_scan_cumu_mode, dev)
    with torch.cuda.device(dev):
        err = lib.kspec_curscan_sublane(
            iq_re.data_ptr(), iq_im.data_ptr(),
            int(iq_re.dtype == torch.uint8), out.data_ptr(),
            starts.data_ptr(), weights.data_ptr(), window.data_ptr(),
            roots.data_ptr(), t, cfg.full_size, n, len(cfg.window_starts),
            _FOLD[cfg.cur_scan_cumu_mode],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"curscan_sublane kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
