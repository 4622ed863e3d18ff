"""Stage ablation of the sublane curscan kernel (K1) on the card — the port
of ``scripts/kernel_ablate.py``.  It times the kernel at fft 2048 (or the
fft given), kaiser, 50% overlap, with stages removed through
``cuda_curscan.curscan_fused_sublane(..., ablate=keys)`` (the direct-DFT
kernel's forensic instantiation; 'base' is its production instantiation,
``cuda_curscan.curscan_sublane_direct``), and prints marginal rates
between T_lo and T_hi blocks (default 4096 and 8192), which cancel the fixed
cost of a launch.  (time(base) - time(variant)) at fixed work is the cost of
the removed stages.

    python -m kspecanal_tpu_torch.scripts.kernel_ablate [fft] [u8|f32] [T_lo T_hi]

The port computes in float32 only, where the JAX script took a precision
class; 'per-block (no cross-block concat)' is the base kernel on Hopper,
which never restacks blocks.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.config import WINDOW_KAISER, SpecConfig
from kspecanal_tpu_torch.ops import cuda_curscan as cc
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    require_cuda

VARIANTS = [
    ("base", ()),
    ("no-win", ("win",)),
    ("no-stage1", ("stage1",)),
    ("no-stage2", ("stage2",)),
    ("no-twiddle", ("twiddle",)),
    ("no-sqrt", ("sqrt",)),
    ("no-cumulate", ("cumulate",)),
    ("per-block (no cross-block concat)", ("concat",)),
    ("matmul-only", ("win", "twiddle", "sqrt", "cumulate")),
    ("floor (decode+frame+reduce)",
     ("win", "stage1", "twiddle", "stage2", "sqrt", "cumulate")),
]


def planes(cfg: SpecConfig, t: int, u8: bool, gen: torch.Generator):
    shape = (t, cfg.full_size)
    if u8:
        return tuple(torch.randint(0, 256, shape, generator=gen,
                                   dtype=torch.uint8, device="cuda")
                     for _ in range(2))
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 for _ in range(2))


def main(argv: Optional[List[str]] = None
         ) -> Dict[str, Tuple[float, float, float]]:
    """Print the marginal table; returns ``{variant: (ms at T_lo, ms at
    T_hi, marginal samples/s)}``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    fft = int(argv[0]) if argv else 2048
    dtype = argv[1] if len(argv) > 1 else "u8"
    if dtype not in ("u8", "f32"):
        raise SystemExit(f"dtype must be u8 or f32, got {dtype!r}")
    t_lo, t_hi = ((int(argv[2]), int(argv[3])) if len(argv) > 3
                  else (4096, 8192))
    require_cuda("kernel_ablate")
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                     window=WINDOW_KAISER, cur_scan_non_overlap=0.5,
                     x_res=min(512, fft)).finalize()
    print(f"device: {card_line()}; fft{fft} 50% float32 {dtype}: "
          f"T={t_lo}/{t_hi} marginal ablation (num_windows="
          f"{cfg.num_windows}, full={cfg.full_size})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lo_planes = planes(cfg, t_lo, dtype == "u8", gen)
    hi_planes = planes(cfg, t_hi, dtype == "u8", gen)
    w_lo, w_hi = t_lo * cfg.full_size, t_hi * cfg.full_size
    rows: Dict[str, Tuple[float, float, float]] = {}
    for name, ab in VARIANTS:
        def run(p, ab=ab):
            if not ab:
                return cc.curscan_sublane_direct(*p, cfg)
            return cc.curscan_fused_sublane(*p, cfg, ablate=ab)
        lo = cuda_ms(lambda: run(lo_planes), warm=2, reps=5)
        hi = cuda_ms(lambda: run(hi_planes), warm=2, reps=5)
        marg = (w_hi - w_lo) / ((hi - lo) * 1e-3) if hi > lo \
            else float("inf")
        rows[name] = (lo, hi, marg)
        base_hi = rows["base"][1]
        print(f"  {name:34s} T{t_lo} {lo:8.3f} ms  T{t_hi} {hi:8.3f} ms  "
              f"marginal {marg / 1e9:6.2f} Gsamp/s  (removes "
              f"{(base_hi - hi) / base_hi * 100:+5.1f}% of base T{t_hi} "
              f"time)", flush=True)
    print(f"\nbase marginal: {rows['base'][2] / 1e9:.2f} Gsamp/s", flush=True)
    return rows


if __name__ == "__main__":
    main()
