"""The ``torch.fft`` chain stage by stage on the card — the port of
``scripts/perf_probe.py``: what each step of the plain curscan
(``ops/spectrum.curscan``) costs, beside the kernel the dispatcher runs.

At fft 2048, 4096 and 16384 (kaiser, 50% overlap, AVG; T blocks of about
4 M samples a call), each stage alone on its own inputs:

  frame gather  the overlapped frames of both planes (one gather each)
  window        the frames times the window
  fft           ``torch.fft.fft`` of the complex frames
  |X|           the normalised magnitudes
  fold          the windows' weighted sum and the fftshift
  chain         ``spectrum.curscan_batched``, all of it
  fft only      the same samples as disjoint frames (no overlap, no
                window): the FFT's own rate
  kernel        ``curscan_auto_batched`` (K1's FFT kernel at HIGHEST)

Times are CUDA events, the median of 10 after 3 warm-ups, in Gsamp/s of the
call's samples.

    python -m kspecanal_tpu_torch.scripts.perf_probe [fft ...]
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.config import cumu_weights, win_adj, window_lut
from kspecanal_tpu_torch.ops import dsp, spectrum
from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched
from kspecanal_tpu_torch.scripts.threemult_smoke import job_cfg, planes
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    require_cuda

SAMPLES = 4_194_304       # about 4 M samples a call


def main(argv: Optional[List[str]] = None
         ) -> Dict[Tuple[int, str], float]:
    """Print the table; returns ``{(fft, stage): ms}``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ffts = [int(a) for a in argv] or [2048, 4096, 16384]
    require_cuda("perf_probe")
    print(f"device: {card_line()}; the torch.fft chain stage by stage "
          f"(kaiser 50% AVG, float32)", flush=True)
    dev = torch.device("cuda")
    out: Dict[Tuple[int, str], float] = {}
    for fft in ffts:
        cfg = job_cfg(fft, 0.5, "HIGHEST")
        n, starts = cfg.fft_size, cfg.window_starts
        t = max(1, SAMPLES // cfg.full_size)
        re, im = planes(cfg, t, False, fft, dev)
        win = torch.as_tensor(window_lut(cfg.window, n), device=dev)
        scale = win_adj(cfg.window, n) * 2.0 / n
        weights = cumu_weights(cfg.cur_scan_cumu_mode, cfg.num_windows)
        fre = spectrum.frame_signal(re, starts, n)
        fim = spectrum.frame_signal(im, starts, n)
        z = torch.complex(fre * win, fim * win)
        spec = torch.fft.fft(z, dim=-1)
        mags = scale * spec.abs()
        m = t * cfg.full_size // n
        stages = {
            "frame gather": lambda: (spectrum.frame_signal(re, starts, n),
                                     spectrum.frame_signal(im, starts, n)),
            "window": lambda: torch.complex(fre * win, fim * win),
            "fft": lambda: torch.fft.fft(z, dim=-1),
            "|X|": lambda: scale * spec.abs(),
            "fold": lambda: torch.fft.fftshift(dsp.reduce_windows(
                cfg.cur_scan_cumu_mode, mags, weights), dim=-1),
            "chain": lambda: spectrum.curscan_batched(re, im, cfg),
            "fft only": lambda: torch.fft.fft(torch.complex(
                re.reshape(m, n), im.reshape(m, n)), dim=-1).abs(),
            "kernel": lambda: curscan_auto_batched(re, im, cfg),
        }
        line = []
        for name, fn in stages.items():
            out[fft, name] = ms = cuda_ms(fn)
            line.append(f"{name} {ms:.3f} ms "
                        f"({t * cfg.full_size / ms / 1e6:.2f} G)")
        print(f"fft={fft:6d} T={t:4d} W={cfg.num_windows:3d}: "
              + "; ".join(line), flush=True)
        del re, im, fre, fim, z, spec, mags
    return out


if __name__ == "__main__":
    main()
