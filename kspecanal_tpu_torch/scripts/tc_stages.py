"""Stage table of the tensor-core kernel (Kernel A, ``csrc/curscan_tc.cuh``)
on the card: the kernel cut off after each stage on the same planes,

    frame   the windowed frames staged in shared memory, every pass
    stage1  + stage 1 (B = F1 A) and the twiddle, C written over the frame
    full    + stage 2 (D = C F2^T), |D| and the fold: the production kernel

in the production (4M) form.  The cut-offs are builds of Kernel A's two
sources with ``-DKSPEC_TC_STOP=1`` (frame) and ``2`` (stage1) into
libraries of their own (``ops/_build.load_variant``; their spectra are
wrong by construction); ``full`` is the port's library.  Each is timed with
CUDA events (median of 10 after 3 warm-ups), and each stage's share is its
delta from the stage before.  The default cells are the precision rows of
``chip_smoke.py``'s timing phase: zero-span fft 2048 kaiser 50% (T=4096),
fmScan's fft 16384 ones 90% and the lane kernel's cell fft 16384 kaiser 50%
(T=288), float32 planes.

    python -m kspecanal_tpu_torch.scripts.tc_stages [FFT:NONO:WIN:T:PREC ...]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.ops import _build, cuda_tc
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    require_cuda

CELLS = ("2048:0.5:WIN.KAISER:4096:DEFAULT", "2048:0.5:WIN.KAISER:4096:HIGH",
         "16384:0.1:WIN.ONES:288:DEFAULT", "16384:0.5:WIN.KAISER:288:DEFAULT",
         "16384:0.5:WIN.KAISER:288:HIGH")
SOURCES = ("curscan_tc.cu", "curscan_tc_high.cu")
STOPS = {"frame": 1, "stage1": 2}


def cell_cfg(fft: int, nono: float, window: str, prec: str) -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=nono,
                      tpu_precision=prec, x_res=512).finalize()


def main(argv: Optional[List[str]] = None
         ) -> Dict[Tuple[int, float, str, int, str], Dict[str, float]]:
    """Print the stage table of each cell; returns ``{(fft, nono, window,
    T, precision): {stage: ms}}``."""
    p = argparse.ArgumentParser(prog="tc_stages", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("cells", nargs="*", default=list(CELLS))
    args = p.parse_args(argv)
    require_cuda("tc_stages")
    print(f"device: {card_line()}; Kernel A stage table (4M, float32 "
          f"planes, CUDA events, median of 10)", flush=True)
    libs = {stage: _build.load_variant(SOURCES, (f"KSPEC_TC_STOP={stop}",))
            for stage, stop in STOPS.items()}
    libs["full"] = _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    for cell in args.cells:
        fft, nono, window, t, prec = cell.split(":")
        cfg = cell_cfg(int(fft), float(nono), window, prec)
        t = int(t)
        re = torch.randn((t, cfg.full_size), generator=gen, device="cuda")
        im = torch.randn((t, cfg.full_size), generator=gen, device="cuda")
        row = {stage: cuda_ms(lambda _l=lib: cuda_tc.launch_tc(
                   _l, re, im, cfg, False))
               for stage, lib in libs.items()}
        prev, parts = 0.0, []
        for stage in ("frame", "stage1", "full"):
            parts.append(f"{stage} {row[stage]:.3f} ms "
                         f"(+{row[stage] - prev:.3f}, "
                         f"{(row[stage] - prev) / row['full']:.0%})")
            prev = row[stage]
        print(f"  fft {cfg.fft_size} {1 - cfg.cur_scan_non_overlap:.0%} "
              f"{cfg.window} {prec} T={t}: " + "; ".join(parts), flush=True)
        table[cfg.fft_size, cfg.cur_scan_non_overlap, cfg.window, t,
              prec] = row
        del re, im
    return table


if __name__ == "__main__":
    main(sys.argv[1:])
