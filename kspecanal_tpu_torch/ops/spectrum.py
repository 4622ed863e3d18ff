"""Overlapped sliding-window FFT magnitude spectra — the port of
``kspecanal_tpu.ops.spectrum`` on ``torch.fft``.

Per-window math (kspecanal.py:373,391,396):

    winAdj = len(win) / sum(win)
    fftN   = winAdj * 2 * |fft(frame * win)| / fftSize
    spec   = fftshift(cumulate(fftN over windows))

IQ travels as two planes (re, im), float32 or raw uint8 with the
value-127 offset (octave/load_rtlsdr.m).  The ``torch.fft`` chain here is
the plain path: the CPU route, and the comparator of the hand-written
curscan kernel (``ops/cuda_curscan.py``) that :func:`curscan_auto_batched`
launches for CUDA tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from kspecanal_tpu.config import SpecConfig, cumu_weights, win_adj, window_lut
from kspecanal_tpu_torch.ops.dsp import reduce_windows


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


def curscan_auto_batched(iq_re: torch.Tensor, iq_im: torch.Tensor,
                         cfg: SpecConfig) -> torch.Tensor:
    """Batched curscan ``(T, full_size)`` -> ``(T, fft_size)``.

    Configs the sublane kernel supports go to its wrapper with the planes
    as given (u8 planes pass straight through and decode in the kernel's
    loads): for CUDA tensors that launches the hand-written kernel, for
    CPU tensors it runs the kernel's plain version.  Every other config
    runs the ``torch.fft`` chain, decoding u8 once."""
    from kspecanal_tpu_torch.ops import cuda_curscan
    if cuda_curscan.supports_fused_sublane(cfg):
        return cuda_curscan.curscan_fused_sublane(iq_re, iq_im, cfg)
    return curscan_batched(decode_u8(iq_re), decode_u8(iq_im), cfg)
