"""Follow-up measurements on the card — the port of
``scripts/perf_followup.py``:

  small      the kernel the dispatcher picks (K2 at fft 64 and 128, K1's
             FFT kernel at 256 and 512) against the direct DFT matmul
             (``spectrum.curscan_direct_batched``) and the ``torch.fft``
             chain (``spectrum.curscan_batched``) at small fft, kaiser 50%
  precision  each tpuPrecision class through the dispatcher (HIGHEST: K1's
             FFT kernel; HIGH and DEFAULT: Kernel A) at fft 2048, 4096 and
             16384: speed, and the worst bin against the float64 oracle
             (``threemult_smoke.oracle_error``: max of |got - oracle| /
             (|oracle| + 1e-6) over ``--blocks`` blocks)

Times are CUDA events, the median of 10 after 3 warm-ups, in Gsamp/s.

    python -m kspecanal_tpu_torch.scripts.perf_followup [small|precision|all]
        [--blocks B]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.ops import cuda_curscan, spectrum
from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched
from kspecanal_tpu_torch.scripts.threemult_smoke import (job_cfg,
                                                         oracle_error,
                                                         planes)
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    require_cuda

SMALL = ((64, 8192), (128, 8192), (256, 4096), (512, 4096))
PRECISION = ((2048, 2048), (4096, 1024), (16384, 256))


def rate(label: str, cfg, t: int, fn) -> float:
    """Gsamp/s of ``fn(re, im, cfg)`` on ``t`` blocks of seeded float32
    noise on the card (:func:`cuda_ms`), printed after ``label``."""
    re, im = planes(cfg, t, False, t, torch.device("cuda"))
    ms = cuda_ms(lambda: fn(re, im, cfg))
    gs = t * cfg.full_size / ms / 1e6
    print(f"{label}: {ms:9.3f} ms {gs:7.2f} Gsamp/s", flush=True)
    return gs


def route(cfg) -> str:
    """The kernel the dispatcher runs for ``cfg``."""
    r = cuda_curscan.kernel_route(cfg)
    if r == "tc":
        return "Kernel A"
    if r == "tc_split":
        return "Kernel C"
    if r == "fft":
        return "K1 FFT kernel"
    return "K2" if cfg.fft_size <= 128 else "chain"


def small() -> Dict[Tuple[int, str], float]:
    print("# the kernels vs the direct DFT and the torch.fft chain (small "
          "fft, kaiser 50%, HIGHEST)", flush=True)
    out = {}
    for fft, t in SMALL:
        cfg = job_cfg(fft, 0.5, "HIGHEST")
        for name, fn in ((route(cfg), curscan_auto_batched),
                         ("direct", spectrum.curscan_direct_batched),
                         ("chain", spectrum.curscan_batched)):
            out[fft, name] = rate(f"{name:14s} fft={fft:4d} T={t}", cfg, t,
                                   fn)
    return out


def precision(blocks: int) -> Dict[Tuple[int, str], Tuple[float, float]]:
    print(f"# tpuPrecision through the dispatcher (kaiser 50%; worst bin vs "
          f"the float64 oracle over {blocks} blocks)", flush=True)
    out = {}
    dev = torch.device("cuda")
    for fft, t in PRECISION:
        for prec in ("HIGHEST", "HIGH", "DEFAULT"):
            cfg = job_cfg(fft, 0.5, prec)
            err = oracle_error(cfg, False, blocks, dev)
            print(f"  fft={fft} {prec}: max_rel_err={err:.3e} ({route(cfg)})",
                  flush=True)
            out[fft, prec] = (err, rate(f"  {route(cfg):14s} fft={fft:5d} "
                                         f"{prec:7s} T={t}", cfg, t,
                                         curscan_auto_batched))
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(prog="perf_followup")
    ap.add_argument("which", nargs="?", default="all",
                    choices=("all", "small", "precision"))
    ap.add_argument("--blocks", type=int, default=2)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    require_cuda("perf_followup")
    print(f"device: {card_line()}", flush=True)
    out = {}
    if args.which in ("all", "small"):
        out["small"] = small()
    if args.which in ("all", "precision"):
        out["precision"] = precision(args.blocks)
    return out


if __name__ == "__main__":
    main()
