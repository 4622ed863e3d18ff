"""Packed tiny-FFT curscan on the card: the wrapper of the hand-written CUDA
kernel ``csrc/curscan_packed.cu``, the port of
``kspecanal_tpu.ops.pallas_curscan.curscan_fused_packed`` (the Pallas kernel
``_kernel_packed``) for fft_size <= 128 (quickFullScan runs 64).

Per IQ block ``(full_size,)`` the kernel computes every window's length-n
DFT against one table with the window and ``winAdj*2/N`` folded in, takes
``|.|``, folds the windows (AVG/RAW weighted sum, MAX/MIN extrema) and writes
the fftshifted ``(fft_size,)`` spectrum; u8 planes decode in its loads.  It
computes in float32 at every ``tpuPrecision``.

For a CUDA tensor :func:`curscan_fused_packed` launches the kernel or raises;
for a CPU tensor it runs :func:`curscan_fused_packed_plain` and never builds
anything.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from kspecanal_tpu_torch.config import (SpecConfig, cumu_weights, win_adj,
                                        window_lut)
from kspecanal_tpu_torch.ops import spectrum
from kspecanal_tpu_torch.ops.cuda_curscan import _FOLD, check_planes

_LANES = 128
_THREADS = 256              # the kernel's threads per block
_SMEM_BYTES = 232_448       # shared memory a Hopper block may use

launches = 0


def smem_bytes(cfg: SpecConfig) -> int:
    """Shared memory of one thread block: the (n, n) complex table and the
    ``256 / n`` IQ blocks it stages, 8 bytes per complex value."""
    n = cfg.fft_size
    return (n * n + (_THREADS // n) * cfg.full_size) * 8


def supports_fused_packed(cfg: SpecConfig) -> bool:
    """The JAX predicate (fft_size <= 128 dividing 128, full_size a multiple
    of 128 and >= 256) without its VMEM clause: that clause bounds Mosaic's
    8-block tile of lane-shifted views, a layout this kernel does not have.
    In its place stands the kernel's own shared-memory bound, which only an
    ``fft2FullMult`` beyond 49 (fft 128) or 97 (fft 64) reaches."""
    n = cfg.fft_size
    return (n <= _LANES and _LANES % n == 0
            and cfg.full_size % _LANES == 0
            and cfg.full_size >= 2 * _LANES
            and smem_bytes(cfg) <= _SMEM_BYTES)


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
    weights (the closed-form decay weights for AVG/RAW, ones for MAX/MIN)
    and the (n, n) complex table ``win[j] * winAdj*2/N * exp(-2 pi i jk/n)``,
    built in float64 and rounded once, as the JAX kernel builds its table."""
    w = cumu_weights(mode, len(starts))
    weights = np.ones(len(starts)) if w is None else w
    k = np.arange(n)
    dft = np.exp(-2j * np.pi * np.outer(k, k) / n)
    win = window_lut(window, n)[:, None]
    scale = win_adj(window, n) * 2.0 / n

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(device)

    return (dev(starts, np.int32), dev(weights, np.float32),
            dev(np.stack([dft.real * win * scale, dft.imag * win * scale],
                         axis=-1), np.float32))


def curscan_fused_packed(iq_re: torch.Tensor, iq_im: torch.Tensor,
                         cfg: SpecConfig) -> torch.Tensor:
    """``(T, full_size)`` float32 or raw-u8 planes -> ``(T, fft_size)``
    fftshifted linear spectra.  CUDA tensors launch the kernel on the
    current stream without synchronising; CPU tensors run the plain
    version."""
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
    starts, weights, table = _tables(n, cfg.window, cfg.window_starts,
                                     cfg.cur_scan_cumu_mode, dev)
    with torch.cuda.device(dev):
        err = lib.kspec_curscan_packed(
            iq_re.data_ptr(), iq_im.data_ptr(),
            int(iq_re.dtype == torch.uint8), out.data_ptr(),
            starts.data_ptr(), weights.data_ptr(), table.data_ptr(), t,
            cfg.full_size, n, len(cfg.window_starts),
            _FOLD[cfg.cur_scan_cumu_mode],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"curscan_packed kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
