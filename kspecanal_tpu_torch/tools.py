"""Offline batch analysis of raw rtl_sdr capture files on the card — the
port of ``kspecanal_tpu/tools.py``, the equivalent of
``octave/process_rtlsdr.m`` (which batch-decodes captures and plots
normalized spectra of several signal variants, process_rtlsdr.m:16-62).

Usage:
    python -m kspecanal_tpu_torch.tools capture.iq [capture2.iq ...] \\
        [fftSize N] [window hanning] [decimate 2048] [out spectra.npz]

For each file: decode, optionally decimate by group-summing (the
m-script's 2048-group sum, :16-25) on the host, then compute the batched
windowed-FFT average spectrum of the complex signal and of the
real/imag/abs variants the m-script studies (:27-50) with the port's
dispatcher (``ops/spectrum.curscan_auto_batched``: K1's FFT kernel at fft
2048, K2 at fft 128), saving everything to an .npz (no plotting).  Without
decimation the capture's bytes ship to the card as they are (2 B/sample)
and decode there (``parallel/stream.decode_u8_on_device``).  It runs on
the card; ``analyze_capture(..., device="cpu")`` and ``main(argv,
device="cpu")`` run the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np
import torch

from kspecanal_tpu_torch.config import WINDOWS, SpecConfig
from kspecanal_tpu_torch.io.sources import load_rtlsdr_capture
from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched
from kspecanal_tpu_torch.parallel.stream import decode_u8_on_device
from kspecanal_tpu_torch.utils.logging import log_info


def _device(device) -> torch.device:
    """``device``, or the card where it is None (which must exist)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: kspecanal_tpu_torch.tools "
                               "runs on the card (pass device='cpu' to run "
                               "its plain PyTorch path)")
        device = "cuda"
    return torch.device(device)


def _analyze_planes(re: torch.Tensor, im: torch.Tensor, cfg) -> dict:
    """All four spectrum variants, averaged over the blocks, from
    ``(T, full_size)`` float32 planes on the device."""
    def avg(r, i):
        return curscan_auto_batched(r, i, cfg).mean(dim=0).cpu().numpy()

    zero = torch.zeros_like(re)
    mag = torch.sqrt(re ** 2 + im ** 2)
    return {"complex": avg(re, im), "real": avg(re, zero),
            "imag": avg(im, zero), "abs": avg(mag, zero)}


def analyze_capture(path: str, fft_size: int = 2048,
                    window: str = "WIN.HANNING",
                    decimate: Optional[int] = None, device=None) -> dict:
    """The four average spectra of the capture at ``path`` (``complex``,
    ``real``, ``imag``, ``abs``: ``(fft_size,)`` float32, fftshifted), with
    ``num_blocks`` and ``fft_size``, on ``device`` (default the card)."""
    dev = _device(device)
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft_size,
                     window=window).finalize()
    full = cfg.full_size
    if decimate:
        # group-sum decimation (process_rtlsdr.m:16-25), host-side
        re, im = load_rtlsdr_capture(path)
        n = (len(re) // decimate) * decimate
        re = re[:n].reshape(-1, decimate).sum(axis=1)
        im = im[:n].reshape(-1, decimate).sum(axis=1)
        t = len(re) // full
        if t == 0:
            raise ValueError(f"{path}: capture shorter than one block "
                             f"({full})")
        out = _analyze_planes(
            torch.from_numpy(np.ascontiguousarray(
                re[: t * full].reshape(t, full), np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                im[: t * full].reshape(t, full), np.float32)).to(dev), cfg)
    else:
        # Raw-byte ingest: ship u8 (2 B/sample, 4x less than float32
        # planes) and decode on the device.
        raw = np.fromfile(path, np.uint8)
        t = (len(raw) // 2) // full
        if t == 0:
            raise ValueError(f"{path}: capture shorter than one block "
                             f"({full})")
        blocks = torch.from_numpy(raw[: t * 2 * full].reshape(t, 2 * full))
        re, im = decode_u8_on_device(blocks.to(dev))
        out = _analyze_planes(re.contiguous(), im.contiguous(), cfg)
    out["num_blocks"] = t
    out["fft_size"] = fft_size
    return out


def main(argv: Optional[List[str]] = None, device=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    files, fft_size, window, decimate, out_path = [], 2048, "WIN.HANNING", None, None
    i = 0
    while i < len(args):
        a = args[i]
        if a.upper() == "FFTSIZE":
            i += 1; fft_size = int(args[i])
        elif a.upper() == "WINDOW":
            i += 1; window = f"WIN.{args[i].upper()}"
            assert window in WINDOWS, window
        elif a.upper() == "DECIMATE":
            i += 1; decimate = int(args[i])
        elif a.upper() == "OUT":
            i += 1; out_path = args[i]
        else:
            files.append(a)
        i += 1
    if not files:
        print(__doc__)
        return 1
    results = {}
    for path in files:
        r = analyze_capture(path, fft_size, window, decimate, device)
        log_info(f"{path}: {r['num_blocks']} blocks, fftSize {fft_size}, "
                 f"peak {float(np.max(r['complex'])):.3e}")
        for k, v in r.items():
            results[f"{path}:{k}"] = v
    if out_path:
        np.savez(out_path, **results)
        log_info(f"saved {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
