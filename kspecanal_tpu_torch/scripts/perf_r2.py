"""Deep-overlap measurements on the card — the port of
``scripts/perf_r2.py``:

  ovl90  the reference's default 90% overlap (curScanNonOverlap 0.1,
         kspecanal.py:45) at fft 2048 (T=512) and 16384 (T=64), kaiser,
         AVG: the dispatcher's kernel at each tpuPrecision (HIGHEST: K1's
         FFT kernel, which frames every misaligned start in its loads;
         HIGH and DEFAULT: Kernel A) with its worst bin against the float64
         oracle, beside the ``torch.fft`` chain
  small  the packed kernels at fft 64 (T=16384) and 128 (T=8192), kaiser
         50%: K2 (HIGHEST) and Kernel B (DEFAULT) through the dispatcher,
         with the oracle error, beside the direct DFT matmul

Times are CUDA events, the median of 10 after 3 warm-ups, in Gsamp/s.

    python -m kspecanal_tpu_torch.scripts.perf_r2 [ovl90|small] [--blocks B]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.ops import spectrum
from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched
from kspecanal_tpu_torch.scripts.perf_followup import rate, route
from kspecanal_tpu_torch.scripts.threemult_smoke import job_cfg, oracle_error
from kspecanal_tpu_torch.utils.profiling import card_line, require_cuda

OVL90 = ((2048, 512), (16384, 64))
SMALL = ((64, 16384), (128, 8192))


def _classes(cases, non_overlap, precs, base, blocks):
    out = {}
    dev = torch.device("cuda")
    for fft, t in cases:
        for prec in precs:
            cfg = job_cfg(fft, non_overlap, prec)
            gs = rate(f"{route(cfg):14s} fft={fft:5d} {prec:7s} T={t}", cfg,
                       t, curscan_auto_batched)
            err = oracle_error(cfg, False, blocks, dev)
            print(f"    max_rel_err={err:.2e}", flush=True)
            out[fft, prec] = (gs, err)
        name, fn = base
        out[fft, name] = (rate(f"{name:14s} fft={fft:5d} HIGHEST T={t}",
                                job_cfg(fft, non_overlap, "HIGHEST"), t, fn),
                          None)
    return out


def main(argv: Optional[List[str]] = None
         ) -> Dict[Tuple[int, str], Tuple[float, Optional[float]]]:
    """Print the table; returns ``{(fft, precision or row): (Gsamp/s,
    worst-bin error or None)}``."""
    ap = argparse.ArgumentParser(prog="perf_r2")
    ap.add_argument("which", nargs="?", default="ovl90",
                    choices=("ovl90", "small"))
    ap.add_argument("--blocks", type=int, default=2)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    require_cuda("perf_r2")
    print(f"device: {card_line()}", flush=True)
    if args.which == "ovl90":
        print("# deep overlap (curScanNonOverlap 0.1)", flush=True)
        return _classes(OVL90, 0.1, ("HIGHEST", "HIGH", "DEFAULT"),
                        ("chain", spectrum.curscan_batched), args.blocks)
    print("# packed small-fft kernels (overlap 50%)", flush=True)
    return _classes(SMALL, 0.5, ("HIGHEST", "DEFAULT"),
                    ("direct", spectrum.curscan_direct_batched), args.blocks)


if __name__ == "__main__":
    main()
