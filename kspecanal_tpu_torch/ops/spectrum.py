"""Overlapped sliding-window FFT magnitude spectra — the port of
``kspecanal_tpu.ops.spectrum`` on ``torch.fft``.

Per-window math (kspecanal.py:373,391,396):

    winAdj = len(win) / sum(win)
    fftN   = winAdj * 2 * |fft(frame * win)| / fftSize
    spec   = fftshift(cumulate(fftN over windows))

IQ travels as two planes (re, im), float32 or raw uint8 with the
value-127 offset (octave/load_rtlsdr.m).  The ``torch.fft`` chain here is
the plain path: the CPU route, and the comparator of the hand-written
curscan kernels (``ops/cuda_curscan.py``, ``ops/cuda_packed.py``) that
:func:`curscan_auto_batched` launches for CUDA tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from kspecanal_tpu_torch.config import (SpecConfig, cumu_weights, win_adj,
                                        window_lut)
from kspecanal_tpu_torch.ops.dsp import reduce_windows
from kspecanal_tpu_torch.ops.mxu_fft import class_matmul


def decode_u8(x: torch.Tensor) -> torch.Tensor:
    """Raw rtl_sdr bytes (value-127 offset) -> float32; float input passes
    through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) - 127.0
    return x


def frame_signal(x: torch.Tensor, starts: Tuple[int, ...],
                 frame_len: int) -> torch.Tensor:
    """Overlapped frames ``(..., len(starts), frame_len)`` from the last
    axis of ``x``: one gather with a static ``(W, frame_len)`` index
    tensor, exact for the non-uniform starts of a fractional hop
    (kspecanal.py:386)."""
    idx = (np.asarray(starts, np.int64)[:, None]
           + np.arange(frame_len, dtype=np.int64)[None, :])
    return x[..., torch.as_tensor(idx, device=x.device)]


def windowed_mags(iq_re: torch.Tensor, iq_im: torch.Tensor,
                  cfg: SpecConfig) -> torch.Tensor:
    """Per-window normalized magnitude spectra ``(..., W, fft_size)``, not
    yet window-reduced or fftshifted (kspecanal.py:385-391)."""
    n = cfg.fft_size
    fre = frame_signal(iq_re, cfg.window_starts, n)
    fim = frame_signal(iq_im, cfg.window_starts, n)
    win = torch.as_tensor(window_lut(cfg.window, n), dtype=fre.dtype,
                          device=fre.device)
    spec = torch.fft.fft(torch.complex(fre * win, fim * win), dim=-1)
    return (win_adj(cfg.window, n) * 2.0 / n) * spec.abs()


def curscan(iq_re: torch.Tensor, iq_im: torch.Tensor,
            cfg: SpecConfig) -> torch.Tensor:
    """``sdr_curscan``: one linear, fftshifted spectrum ``(fft_size,)`` per
    ``full_size`` IQ block (kspecanal.py:351-397).  Leading axes batch."""
    mags = windowed_mags(iq_re, iq_im, cfg)
    w = cumu_weights(cfg.cur_scan_cumu_mode, cfg.num_windows)
    spec = reduce_windows(cfg.cur_scan_cumu_mode, mags, w)
    return torch.fft.fftshift(spec, dim=-1)


def curscan_batched(iq_re: torch.Tensor, iq_im: torch.Tensor,
                    cfg: SpecConfig) -> torch.Tensor:
    """``(B, full_size)`` float IQ -> ``(B, fft_size)`` spectra."""
    return curscan(iq_re, iq_im, cfg)


def fft_freqs(cfg: SpecConfig, center_freq: Optional[float] = None
              ) -> np.ndarray:
    """fftshifted bin center frequencies (kspecanal.py:444-445)."""
    fc = cfg.center_freq if center_freq is None else center_freq
    return np.fft.fftshift(
        np.fft.fftfreq(cfg.fft_size, 1.0 / cfg.sampling_rate) + fc)


def psd_welch(iq_re: torch.Tensor, iq_im: torch.Tensor,
              cfg: SpecConfig) -> torch.Tensor:
    """Welch PSD with ``matplotlib.mlab.psd`` semantics — the reference's
    ``bUsePSD`` cross-check (kspecanal.py:374-384): segments stride by
    ``NFFT - noverlap``, windowed, ``|fft|^2`` averaged, scaled by
    ``1/(Fs*sum(win^2))`` with mlab's default ``Fs=2``, two-sided,
    fftshifted.  Leading axes batch."""
    n = cfg.fft_size
    noverlap = int(n * (1 - cfg.cur_scan_non_overlap))
    step = n - noverlap
    total = iq_re.shape[-1]
    num = (total - noverlap) // step
    starts = tuple(i * step for i in range(num) if i * step + n <= total)
    fre = frame_signal(iq_re, starts, n)
    fim = frame_signal(iq_im, starts, n)
    win = torch.as_tensor(window_lut(cfg.window, n), dtype=fre.dtype,
                          device=fre.device)
    spec = torch.fft.fft(torch.complex(fre * win, fim * win), dim=-1)
    pxx = (spec.abs() ** 2).mean(dim=-2)
    pxx = pxx / (2.0 * torch.sum(win * win))
    return torch.fft.fftshift(pxx, dim=-1)


def curscan_direct_batched(iq_re: torch.Tensor, iq_im: torch.Tensor,
                           cfg: SpecConfig) -> torch.Tensor:
    """Small-FFT curscan as a direct DFT matmul: frames ``(B, W, n)`` times
    the ``(n, n)`` DFT matrix at the config's ``tpuPrecision``
    (``mxu_fft.class_matmul``, as JAX's dot takes its precision), then the
    same normalize/cumulate/fftshift as :func:`curscan`.  Float planes
    only."""
    n = cfg.fft_size
    k = np.arange(n)
    dft = np.exp(-2j * np.pi * np.outer(k, k) / n)

    def table(a):
        return torch.as_tensor(a, dtype=torch.float32, device=iq_re.device)

    fr, fi = table(dft.real), table(dft.imag)
    win = table(window_lut(cfg.window, n))
    ar = frame_signal(iq_re, cfg.window_starts, n) * win
    ai = frame_signal(iq_im, cfg.window_starts, n) * win
    prec = cfg.tpu_precision
    xr = class_matmul(ar, fr.T, prec) - class_matmul(ai, fi.T, prec)
    xi = class_matmul(ai, fr.T, prec) + class_matmul(ar, fi.T, prec)
    mags = (win_adj(cfg.window, n) * 2.0 / n) * torch.sqrt(xr * xr + xi * xi)
    w = cumu_weights(cfg.cur_scan_cumu_mode, cfg.num_windows)
    return torch.fft.fftshift(
        reduce_windows(cfg.cur_scan_cumu_mode, mags, w), dim=-1)


def curscan_auto_batched(iq_re: torch.Tensor, iq_im: torch.Tensor,
                         cfg: SpecConfig) -> torch.Tensor:
    """Batched curscan ``(T, full_size)`` -> ``(T, fft_size)``, the
    counterpart of the JAX dispatcher's TPU ladder:

      * every config for which the JAX ``_fused_choice`` picks the sublane
        kernel K1 or the lane kernel K3 (``cuda_curscan.kernel_route``:
        every multiple of 128 from 256 up, and every fft >= 2048 that is
        not prime and whose window starts are multiples of n2 =
        ``_factorize(fft)[1]``, such as fft 3000, 10000 or 39800) goes, at
        tpuPrecision HIGH and DEFAULT, to a tensor-core kernel: up to fft
        16384 on the 128 grid to Kernel A ``cuda_tc.curscan_tc``, everywhere
        else to Kernel C ``cuda_tc.curscan_tc_split`` on the JAX
        dispatcher's split (``cuda_curscan.tc_split``); at HIGHEST to the
        float64 FFT kernel ``cuda_curscan.curscan_fused_sublane``;
      * else configs the packed kernel K2 supports (fft <= 128 dividing
        128 with blocks of a multiple of 128 samples, at least 256: every
        config JAX's packed kernel takes, the quickFullScan regime among
        them) go, at HIGH and DEFAULT, to the tensor-core packed kernel
        ``cuda_tc.curscan_packed_tc``, and at HIGHEST to the float64 one
        ``cuda_packed.curscan_fused_packed``;
      * else, on the card, fft <= 256 decodes and takes the direct DFT
        matmul (fft 48, 96, 200, ..., and blocks K2 does not take), and
        everything else the ``torch.fft`` chain, where the JAX dispatcher
        runs XLA's chain too (fft 1000, primes, starts off n2).

    Planes reach a kernel's wrapper as given (u8 decodes in the kernel's
    loads): for CUDA tensors the wrapper launches its kernel, for CPU
    tensors it runs its plain version, the ``torch.fft`` chain.  CPU tensors
    outside both kernels take the chain too."""
    from kspecanal_tpu_torch.ops import cuda_curscan, cuda_packed, cuda_tc
    route = cuda_curscan.kernel_route(cfg)
    if route == "tc":
        return cuda_tc.curscan_tc(iq_re, iq_im, cfg)
    if route == "tc_split":
        return cuda_tc.curscan_tc_split(iq_re, iq_im, cfg)
    if route == "fft":
        return cuda_curscan.curscan_fused_sublane(iq_re, iq_im, cfg)
    if cuda_tc.supports_packed_tc(cfg):
        return cuda_tc.curscan_packed_tc(iq_re, iq_im, cfg)
    if cuda_packed.supports_fused_packed(cfg):
        return cuda_packed.curscan_fused_packed(iq_re, iq_im, cfg)
    iq_re, iq_im = decode_u8(iq_re), decode_u8(iq_im)
    if iq_re.device.type == "cuda" and cfg.fft_size <= 256:
        return curscan_direct_batched(iq_re, iq_im, cfg)
    return curscan_batched(iq_re, iq_im, cfg)
