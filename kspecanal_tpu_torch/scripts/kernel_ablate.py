"""Stage ablation of the sublane curscan kernel (K1) on the card — the port
of ``scripts/kernel_ablate.py``.  It times the kernel that serves the
precision class at fft 2048 (or the fft given), kaiser, 50% overlap, with
stages removed through ``cuda_curscan.curscan_fused_sublane(...,
ablate=keys)``, and prints marginal rates between T_lo and T_hi blocks
(default 4096 and 8192), which cancel the fixed cost of a launch.
(time(base) - time(variant)) at fixed work is the cost of the removed
stages; beside it, each variant's saving against the forensic build's own
time with no stage removed, since the run-time mask costs time of its
own.

    python -m kspecanal_tpu_torch.scripts.kernel_ablate [fft] [precision] \
        [u8|f32] [T_lo T_hi]

The defaults are the JAX script's cell: fft 2048, DEFAULT, u8.  The
variants run the ablate build of Kernel A (fft <= 16384) or of Kernel C on
the split (fft / 128, 128), in the 4M form; 'base' is the kernel a session
of the class runs: at HIGH and DEFAULT the production kernel
(``cuda_tc.curscan_tc`` / ``curscan_tc_split``), at HIGHEST, whose variants
run the six-pass builds (``-DKSPEC_TC_HIGHEST=1``), the FFT kernel
(``cuda_curscan.curscan_fused_sublane``).  'per-block (no cross-block
concat)' removes nothing on Hopper, whose kernels never restack blocks: it
is the forensic build with an empty mask.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.config import WINDOW_KAISER, SpecConfig
from kspecanal_tpu_torch.ops import cuda_curscan as cc
from kspecanal_tpu_torch.ops import cuda_tc
from kspecanal_tpu_torch.ops.mxu_fft import PRECISIONS
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
# The forensic build with no stage removed (Hopper's kernels never restack).
NO_KEY = "per-block (no cross-block concat)"


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
    prec = argv[1].upper() if len(argv) > 1 else "DEFAULT"
    dtype = argv[2] if len(argv) > 2 else "u8"
    if prec not in PRECISIONS:
        raise SystemExit(f"precision must be one of {PRECISIONS}, got "
                         f"{argv[1]!r}")
    if dtype not in ("u8", "f32"):
        raise SystemExit(f"dtype must be u8 or f32, got {dtype!r}")
    t_lo, t_hi = ((int(argv[3]), int(argv[4])) if len(argv) > 4
                  else (4096, 8192))
    require_cuda("kernel_ablate")
    if prec == "HIGHEST":
        cuda_tc.build_stage_libraries(highest=True)
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                     window=WINDOW_KAISER, cur_scan_non_overlap=0.5,
                     x_res=min(512, fft), tpu_precision=prec).finalize()
    print(f"device: {card_line()}; fft{fft} 50% {prec} {dtype} on "
          f"{base_kernel(cfg)}: T={t_lo}/{t_hi} marginal ablation "
          f"(num_windows={cfg.num_windows}, full={cfg.full_size})",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lo_planes = planes(cfg, t_lo, dtype == "u8", gen)
    hi_planes = planes(cfg, t_hi, dtype == "u8", gen)
    w_lo, w_hi = t_lo * cfg.full_size, t_hi * cfg.full_size
    rows: Dict[str, Tuple[float, float, float]] = {}
    for name, ab in VARIANTS:
        def run(p, ab=ab):
            if not ab:
                return base(*p, cfg)
            return cc.curscan_fused_sublane(*p, cfg, ablate=ab)
        lo = cuda_ms(lambda: run(lo_planes), warm=2, reps=5)
        hi = cuda_ms(lambda: run(hi_planes), warm=2, reps=5)
        marg = (w_hi - w_lo) / ((hi - lo) * 1e-3) if hi > lo \
            else float("inf")
        rows[name] = (lo, hi, marg)
    # The forensic build with no stage removed: what each removal saves
    # within the build, whose mask costs time of its own.
    base_hi, nokey_hi = rows["base"][1], rows[NO_KEY][1]
    for name, (lo, hi, marg) in rows.items():
        print(f"  {name:34s} T{t_lo} {lo:8.3f} ms  T{t_hi} {hi:8.3f} ms  "
              f"marginal {marg / 1e9:6.2f} Gsamp/s  (removes "
              f"{(base_hi - hi) / base_hi * 100:+5.1f}% of base, "
              f"{(nokey_hi - hi) / nokey_hi * 100:+5.1f}% of the no-key "
              f"build's T{t_hi} time)", flush=True)
    print(f"\nbase marginal: {rows['base'][2] / 1e9:.2f} Gsamp/s; the "
          f"forensic build with no stage removed takes "
          f"{nokey_hi / base_hi:.3f} of base's time", flush=True)
    return rows


def base_kernel(cfg: SpecConfig) -> str:
    """The kernel the variants of ``cfg``'s class take apart."""
    kernel = ("Kernel A" if cfg.fft_size <= cc.TC_MAX_FFT_SIZE
              else f"Kernel C ({cfg.fft_size // 128} x 128)")
    if cfg.tpu_precision.upper() == "HIGHEST":
        return f"{kernel}'s six-pass build (base: the FFT kernel)"
    return kernel


def base(re: torch.Tensor, im: torch.Tensor, cfg: SpecConfig):
    """'base': the kernel a session of ``cfg``'s class runs (no
    ablation)."""
    if cfg.tpu_precision.upper() == "HIGHEST":
        return cc.curscan_fused_sublane(re, im, cfg)
    if cfg.fft_size <= cc.TC_MAX_FFT_SIZE:
        return cuda_tc.curscan_tc(re, im, cfg)
    return cuda_tc.curscan_tc_split(re, im, cfg,
                                    split=(cfg.fft_size // 128, 128))


if __name__ == "__main__":
    main()
