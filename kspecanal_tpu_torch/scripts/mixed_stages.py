"""Stage table of the FFT kernel's mixed-radix form
(``csrc/curscan_mixed.cuh``) on the card: the kernel cut off after each
stage of ``cuda_curscan.MIXED_STAGES`` on the same planes
(``cuda_curscan.curscan_mixed_stage``, counted in ``forensic_launches``):

    input  the block input: loads, u8 decode, window (and the cluster's or
           the scratch's radix-c step), re + im folded per point
    odd    + the odd prime passes
    pow2   + the power-of-two passes
    full   + |.| and the fold: the production kernel

and prints per stage the time (CUDA events, median of 10) and its delta from
the stage before, then the production call and the plain ``torch.fft``
chain (in chunks of IQ blocks at 90% overlap).  The default cells are the
mixed kernel's rows of ``chip_smoke.py``'s timing phase: fft 3000 and 10000
(T=4096), 16256 (T=1024) and 39800 (T=64), kaiser, 50% overlap, AVG,
float32 planes.

    python -m kspecanal_tpu_torch.scripts.mixed_stages [--nono X] [FFT:T ...]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.config import CUMU_AVG, WINDOW_KAISER, SpecConfig
from kspecanal_tpu_torch.ops import cuda_curscan as cc
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    require_cuda

CELLS = ("3000:4096", "10000:4096", "16256:1024", "39800:64")
# The plain chain holds several (T, W, N) complex64 tensors at once: it is
# timed in chunks of IQ blocks whose frames stay within this many bytes.
PLAIN_FRAME_BYTES = 8 << 30


def stage_cfg(fft: int, nono: float = 0.5, mode: str = CUMU_AVG
              ) -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=WINDOW_KAISER, cur_scan_non_overlap=nono,
                      cur_scan_cumu_mode=mode,
                      x_res=min(512, fft)).finalize()


def main(argv: Optional[List[str]] = None
         ) -> Dict[Tuple[int, int], Dict[str, float]]:
    """Print the stage table of each cell; returns ``{(fft, T): {stage: ms,
    'kernel': ms, 'plain': ms}}``."""
    p = argparse.ArgumentParser(prog="mixed_stages", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--nono", type=float, default=0.5)
    p.add_argument("cells", nargs="*", default=list(CELLS))
    args = p.parse_args(argv)
    require_cuda("mixed_stages")
    print(f"device: {card_line()}; mixed kernel stage table, kaiser "
          f"{1 - args.nono:.0%} overlap AVG, float32 planes", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: Dict[Tuple[int, int], Dict[str, float]] = {}
    for cell in args.cells:
        fft, t = (int(x) for x in cell.split(":"))
        cfg = stage_cfg(fft, args.nono)
        c, via_scratch = cc.fft_plan(fft)
        re = torch.randn((t, cfg.full_size), generator=gen, device="cuda")
        im = torch.randn((t, cfg.full_size), generator=gen, device="cuda")
        row: Dict[str, float] = {}
        prev = 0.0
        for stage in cc.MIXED_STAGES:
            row[stage] = cuda_ms(lambda s=stage: cc.curscan_mixed_stage(
                re, im, cfg, s))
            print(f"fft {fft} (c={c}{', scratch' if via_scratch else ''}, "
                  f"odd primes {cc.odd_primes(fft // c)}) T={t} "
                  f"{stage:5s} {row[stage]:9.3f} ms  delta "
                  f"{row[stage] - prev:+9.3f} ms", flush=True)
            prev = row[stage]
        row["kernel"] = cuda_ms(lambda: cc.curscan_fused_sublane(re, im, cfg))
        rows = max(1, min(t, PLAIN_FRAME_BYTES
                          // (cfg.num_windows * fft * 8)))
        row["plain"] = cuda_ms(lambda: [
            cc.curscan_fused_sublane_plain(re[i:i + rows], im[i:i + rows],
                                           cfg) for i in range(0, t, rows)])
        print(f"fft {fft} T={t} production {row['kernel']:9.3f} ms, plain "
              f"torch.fft chain {row['plain']:9.3f} ms", flush=True)
        results[fft, t] = row
        del re, im
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
