"""Stage breakdown of the two-stage DFT curscan on the card — the port of
``scripts/roofline_r2.py``, whose stage ablation K4 it runs
(``cuda_curscan.curscan_stage_ablate``), cut off after each stage on the
same planes:

    read   read every sample once, sum the n1-row slabs (memory streaming)
    frame  + framing at each window start and the window multiply
    s1     + stage 1, the length-n1 DFT down each column
    s1tw   + the twiddle multiply
    s2     + stage 2, the length-128 DFT along each row
    full   + |.| and the weighted fold == the production kernel

Kernel A (``csrc/curscan_tc.cuh``, 4M, float32 sums) serves the table at
the class of ``--precision`` (default DEFAULT, as in the JAX script), each
cut-off a build of its own (``cuda_tc.stage_library``: every stage below
'full' folds its weighted re + im into the output):

* HIGH and DEFAULT: 'full' the port's library; beside them Kernel A itself
  and the FFT kernel at HIGHEST;
* HIGHEST: the six-pass forensic builds (``-DKSPEC_TC_HIGHEST=1``), 'full'
  Kernel A's HIGHEST build (``cuda_tc.highest_library``); beside them the
  direct kernel (``csrc/curscan_sublane.cu``, the yardstick) and the FFT
  kernel (``csrc/curscan_fft.cu``, what a HIGHEST session runs for a power
  of two);

and one bf16 ``torch.matmul`` at stage 2's shape ``(T*W*n1, 128) @ (128,
128)`` for scale.

Per stage the time (CUDA events around 10 back-to-back calls, median of 10,
per call: ``utils.profiling.cuda_ms_each``, the card's time), the delta from
the previous stage and Gsamp/s.  The default cell is the main path's: fft 2048,
kaiser, 50% overlap, AVG, float32 planes.

    python -m kspecanal_tpu_torch.scripts.roofline_r2 [--fft N]
        [--precision HIGHEST|HIGH|DEFAULT] [T ...]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from kspecanal_tpu_torch.config import CUMU_AVG, WINDOW_KAISER, SpecConfig
from kspecanal_tpu_torch.ops import cuda_curscan as cc
from kspecanal_tpu_torch.ops import cuda_tc
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    cuda_ms_each, require_cuda


def stage_cfg(fft: int, precision: str = "HIGHEST") -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=WINDOW_KAISER, cur_scan_non_overlap=0.5,
                      cur_scan_cumu_mode=CUMU_AVG, tpu_precision=precision,
                      x_res=min(512, fft)).finalize()


def main(argv: Optional[List[str]] = None) -> Dict[int, Dict[str, float]]:
    """Print the stage table for each T; returns ``{T: {stage: ms,
    'matmul': ms, 'fft': ms, and 'direct' (HIGHEST) or 'tc' (HIGH,
    DEFAULT): ms}}``."""
    p = argparse.ArgumentParser(prog="roofline_r2", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--fft", type=int, default=2048)
    p.add_argument("--precision", default="DEFAULT",
                   choices=("HIGHEST", "HIGH", "DEFAULT"))
    p.add_argument("t", type=int, nargs="*", default=[4096])
    args = p.parse_args(argv)
    tc_class = args.precision != "HIGHEST"
    require_cuda("roofline_r2")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = stage_cfg(args.fft, args.precision)
    n1 = cfg.fft_size // 128
    cuda_tc.build_stage_libraries(highest=not tc_class)
    served = ("Kernel A's cut-offs (csrc/curscan_tc.cuh, one "
              "-DKSPEC_TC_STOP build a stage; 'full' "
              + ("the port's library), 4M" if tc_class else
                 "Kernel A's HIGHEST build), six bf16 passes, 4M")
              + ", float32 sums")
    print(f"device: {card_line()}; fft {cfg.fft_size} kaiser 50% AVG, "
          f"W={cfg.num_windows}, full={cfg.full_size}; precision "
          f"{args.precision}: K4 served by {served}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: Dict[int, Dict[str, float]] = {}
    for t in args.t:
        row: Dict[str, float] = {}
        samples = t * cfg.full_size
        rows = t * cfg.num_windows * n1
        a = torch.randn((rows, 128), generator=gen,
                        device="cuda").to(torch.bfloat16)
        b = torch.randn((128, 128), generator=gen,
                        device="cuda").to(torch.bfloat16)
        row["matmul"] = cuda_ms(lambda: torch.matmul(a, b))
        print(f"T={t} torch.matmul stage-2 shape ({rows}, 128) @ (128, 128) "
              f"bf16: {row['matmul']:9.3f} ms "
              f"{2 * rows * 128 * 128 / row['matmul'] / 1e9:6.2f} TFLOP/s",
              flush=True)
        del a, b
        re = torch.randn((t, cfg.full_size), generator=gen, device="cuda")
        im = torch.randn((t, cfg.full_size), generator=gen, device="cuda")
        prev = None
        for stage in cc.STAGES:
            ms = cuda_ms_each(lambda s=stage: cc.curscan_stage_ablate(
                re, im, cfg, s))
            row[stage] = ms
            delta = "" if prev is None else f"delta {ms - prev:+9.3f} ms"
            print(f"T={t} {stage:5s} {ms:9.3f} ms {samples / ms / 1e6:7.3f} "
                  f"Gsamp/s  {delta}", flush=True)
            prev = ms
        highest = stage_cfg(args.fft)
        if tc_class:
            base = ("tc", lambda: cuda_tc.curscan_tc(re, im, cfg),
                    f"Kernel A at {args.precision}")
        else:
            base = ("direct", lambda: cc.curscan_sublane_direct(re, im, cfg),
                    "the direct kernel, the yardstick")
        for key, fn, what in (base, (
                "fft", lambda: cc.curscan_fused_sublane(re, im, highest),
                "K1, the FFT kernel, at HIGHEST")):
            row[key] = cuda_ms_each(fn)
            print(f"T={t} {key:6s} {row[key]:9.3f} ms "
                  f"{samples / row[key] / 1e6:7.3f} Gsamp/s ({what})",
                  flush=True)
        results[t] = row
        del re, im
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
