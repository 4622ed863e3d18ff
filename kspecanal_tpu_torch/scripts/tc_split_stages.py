"""Stage table of Kernel C (``csrc/curscan_tc_split.cuh``, the HIGH/DEFAULT
tensor-core two-stage DFT on any split) on the card: the kernel cut off
after each stage on the same planes,

    frame   the windowed frame staged as rounded bf16 operands
    s1      + stage 1 (B = F1 A)
    s1tw    + the twiddle (C = B o T written to the operand planes)
    s2      + stage 2 (D = C F2^T)
    full    + |D| and the fold: the production kernel

(each cut-off also folds its stage's weighted re + im into the output, so
the stage times include that reduction), in the production (4M) form, on
the split the JAX dispatcher takes (``cuda_curscan.tc_split``).  The
cut-offs are builds of Kernel C's two sources with ``-DKSPEC_TCS_STOP=1..4``
(``ops/cuda_tc.tc_split_stage_library``); 'full' is the port's library.
Each is timed with CUDA events (median of 10 after 3 warm-ups), and each
stage's share is its delta from the stage before.  Each cell also prints
its shared memory a block, the blocks an SM holds (the CUDA occupancy
calculator: registers and shared memory), its window groups and each
cut-off's largest error against its plain version on the first 8 IQ
blocks, as a share of ``TC_TOL``; the build prints ptxas' registers and
spills of Kernel C's instantiations.  The default cells are
``chip_smoke.py``'s Kernel C timing cells (kaiser, AVG).

Each cell then runs ROUNDS rounds, each timing in turn (the same way)
Kernel C, the FFT kernel at HIGHEST (``cuda_curscan.curscan_fused_sublane``)
and the float32 ``torch.fft`` chain (``curscan_fused_sublane_plain``, in
calls of at most 8 GiB of frames) on the same planes, and prints each
one's least, median and most, Kernel C's bound (its 4M tensor-core flops
on the split, x3 at HIGH, at 989 TFLOP/s, or the planes read once and the
output written once at 3.35 TB/s) and its share of it.

``--kernel-only`` times Kernel C alone, ROUNDS rounds a cell, through its
public wrapper ``cuda_tc.curscan_tc_split`` and nothing else of this
module's API, so the script also runs on a tree whose Kernel C has no
cut-offs (a ``git archive`` of an earlier commit, with this file copied
into its ``scripts``).

``--beside-kernel-a`` times instead Kernel C on Kernel A's split (n / 128
x 128, ``cuda_tc.launch_tc_split``) beside Kernel A (``cuda_tc.curscan_tc``)
at Kernel A's main cells (``KERNEL_A_CELLS``: zero-span fft 2048 and
fmScan's fft 16384 ones 90%), ROUNDS rounds of both, with Kernel C's
largest difference from Kernel A as a share of ``TC_TOL``; it routes
nothing.

    python -m kspecanal_tpu_torch.scripts.tc_split_stages [--kernel-only |
        --beside-kernel-a] [--rounds R] [--json PATH]
        [FFT:NONO:PREC:INPUT:T ...]
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from typing import Dict, List, Optional

import torch

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.ops import _build, cuda_curscan, cuda_tc
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    require_cuda

CELLS = ("3000:0.5:DEFAULT:f32:4096", "3000:0.5:DEFAULT:u8:4096",
         "3000:0.5:HIGH:f32:4096", "3000:0.1:DEFAULT:f32:4096",
         "3000:0.1:HIGH:f32:4096", "10000:0.5:DEFAULT:f32:4096",
         "10000:0.5:HIGH:f32:4096", "39800:0.5:DEFAULT:f32:64",
         "39800:0.5:HIGH:f32:64", "65536:0.5:DEFAULT:f32:64",
         "65536:0.5:DEFAULT:u8:64", "65536:0.5:HIGH:f32:64",
         "32768:0.1:DEFAULT:f32:64", "32768:0.1:HIGH:f32:64")
# Kernel A's main cells (fft, nono, window, T, class), as scripts/tc_stages.
KERNEL_A_CELLS = ((2048, 0.5, "WIN.KAISER", 4096, "DEFAULT"),
                  (2048, 0.5, "WIN.KAISER", 4096, "HIGH"),
                  (16384, 0.1, "WIN.ONES", 288, "DEFAULT"))
STAGES = ("frame", "s1", "s1tw", "s2", "full")
ROUNDS = 5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet
BF16_FLOPS = 989e12           # H100 SXM bf16 tensor cores, dense
PLAIN_FRAME_BYTES = 8 << 30   # the torch.fft chain's frames a call
CHECK_BLOCKS = 8              # IQ blocks of each cut-off's plain check
TC_TOL = {"DEFAULT": (1e-2, 1e-2), "HIGH": (5e-5, 5e-5)}


def cell_cfg(fft: int, nono: float, prec: str,
             window: str = "WIN.KAISER") -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=nono,
                      tpu_precision=prec, x_res=512).finalize()


def planes(cfg: SpecConfig, t: int, u8: bool, gen: torch.Generator):
    if u8:
        return tuple(torch.randint(0, 256, (t, cfg.full_size), generator=gen,
                                   device="cuda", dtype=torch.uint8)
                     for _ in range(2))
    return tuple(torch.randn((t, cfg.full_size), generator=gen,
                             device="cuda") for _ in range(2))


def bound_ms(cfg: SpecConfig, t: int, u8: bool, split) -> tuple:
    """Kernel C's least time (ms) and what bounds it: 4 real products a
    stage a window (2 n1 n1 n2 flops in stage 1, 2 n1 n2 n2 in stage 2), x3
    at HIGH, at 989 TFLOP/s, or the planes read once and the output written
    once at 3.35 TB/s."""
    n1, n2 = split
    flops = 4 * 2 * n1 * n2 * (n1 + n2) * t * cfg.num_windows
    if cfg.tpu_precision.upper() == "HIGH":
        flops *= 3
    nbytes = 2 * t * cfg.full_size * (1 if u8 else 4) + 4 * t * cfg.fft_size
    ops, mem = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops, mem), "operations" if ops > mem else "bytes"


def _spread(xs: List[float]) -> str:
    return (f"{min(xs):.3f} / {statistics.median(xs):.3f} / "
            f"{max(xs):.3f}")


def tol_share(got: torch.Tensor, want: torch.Tensor, prec: str) -> float:
    rtol, atol = TC_TOL[prec]
    err = (got - want).abs()
    return (err / (rtol * want.abs() + atol * want.abs().max())).max().item()


def ptxas_lines(log: str) -> List[str]:
    """ptxas' register and spill lines of Kernel C's instantiations, the
    first build of each (the port's library compiles first)."""
    seen, out, name = set(), [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "curscan_tc_split_kernel" in ln \
                else None
        elif name and ("Used" in ln or "spill" in ln):
            key = (name, "Used" in ln)
            if key not in seen:
                seen.add(key)
                out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def torch_fft_chain(re, im, cfg):
    rows = max(1, min(re.shape[0], PLAIN_FRAME_BYTES
                      // (cfg.num_windows * cfg.fft_size * 8)))
    return [cuda_curscan.curscan_fused_sublane_plain(re[i:i + rows],
                                                     im[i:i + rows], cfg)
            for i in range(0, re.shape[0], rows)]


def beside_kernel_a(rounds: int, gen: torch.Generator) -> Dict[str, dict]:
    """Kernel C on Kernel A's split beside Kernel A at Kernel A's main
    cells; returns ``{cell: {"rounds": {name: [ms, ...]}, "share": x}}``."""
    lib, table = _build.load(), {}
    for fft, nono, window, t, prec in KERNEL_A_CELLS:
        cfg = cell_cfg(fft, nono, prec, window)
        re, im = planes(cfg, t, False, gen)
        split = (fft // 128, 128)
        runs = {"Kernel A": lambda: cuda_tc.curscan_tc(re, im, cfg),
                "Kernel C": lambda: cuda_tc.launch_tc_split(
                    lib, re, im, cfg, False, split)}
        share = tol_share(runs["Kernel C"](), runs["Kernel A"](), prec)
        got = {k: [] for k in runs}
        for _ in range(rounds):
            for k, fn in runs.items():
                got[k].append(cuda_ms(fn))
        ratio = [c / a for a, c in zip(got["Kernel A"], got["Kernel C"])]
        name = (f"fft {fft} {window} {1 - nono:.0%} {prec} T={t} "
                f"({split[0]} x 128)")
        print(f"  {name}, {rounds} rounds, ms least / median / most: "
              + "; ".join(f"{k} {_spread(v)}" for k, v in got.items())
              + f"; Kernel C / Kernel A {_spread(ratio)}; Kernel C vs "
              f"Kernel A {share:.3f} of TC_TOL", flush=True)
        table[name] = {"rounds": got, "share": share}
        del re, im
    return table


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    """Print the stage table of each cell; returns ``{cell: {stage: ms,
    "smem": bytes, "blocks_per_sm": n, "groups": G, "split": [n1, n2],
    "check": {stage: share}, "rounds": {name: [ms, ...]}, "bound_ms": x,
    "bound_by": s}}`` (with ``--kernel-only`` the rounds alone)."""
    p = argparse.ArgumentParser(prog="tc_split_stages", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("cells", nargs="*", default=list(CELLS))
    p.add_argument("--kernel-only", action="store_true",
                   help="time Kernel C alone through its public wrapper")
    p.add_argument("--beside-kernel-a", action="store_true",
                   help="time Kernel C beside Kernel A at Kernel A's cells")
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--json", help="also write the table to this file")
    args = p.parse_args(argv)
    require_cuda("tc_split_stages")
    gpu = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.beside_kernel_a:
        print(f"device: {gpu}; Kernel C on Kernel A's split beside Kernel A "
              f"(4M, CUDA events, median of 10 after 3 warm-ups)", flush=True)
        table = beside_kernel_a(args.rounds, gen)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"device": gpu, "cells": table}, f, indent=1)
        return table
    print(f"device: {gpu}; Kernel C "
          f"{'alone' if args.kernel_only else 'stage table'} (4M, CUDA "
          f"events, median of 10 after 3 warm-ups)", flush=True)
    libs = {}
    if args.kernel_only:
        _build.load()
    else:
        _build.build(cuda_tc.tc_split_stage_variants())
        for ln in ptxas_lines(_build.build_log):
            print(f"  ptxas {ln}", flush=True)
        libs = {s: cuda_tc.tc_split_stage_library(s) for s in STAGES[:-1]}
        libs["full"] = _build.load()
    table = {}
    for cell in args.cells:
        fft, nono, prec, kind, t = cell.split(":")
        cfg, t, u8 = cell_cfg(int(fft), float(nono), prec), int(t), \
            kind == "u8"
        re, im = planes(cfg, t, u8, gen)
        split = cuda_curscan.tc_split(cfg, u8)
        bms, by = bound_ms(cfg, t, u8, split)
        name = (f"fft {cfg.fft_size} {1 - cfg.cur_scan_non_overlap:.0%} "
                f"{prec} {kind} T={t} ({split[0]} x {split[1]}, "
                f"{cfg.num_windows} windows)")
        row = {"split": list(split), "bound_ms": bms, "bound_by": by}

        def kernel_c():
            return cuda_tc.curscan_tc_split(re, im, cfg)
        if not args.kernel_only:
            high = prec == "HIGH"
            row["smem"] = libs["full"].kspec_curscan_tc_split_smem(
                *split, int(high), 0)
            row["blocks_per_sm"] = cuda_tc.tc_split_occupancy(
                libs["full"], u8, *split, high, False)
            groups = getattr(cuda_tc, "tc_split_launch_groups", None)
            row["groups"] = (groups(libs["full"], re, cfg, False, split)
                             if groups else 1)
            ms, check = {}, {}
            for stage in STAGES:
                ms[stage] = cuda_ms(lambda s=stage: cuda_tc.
                                    curscan_tc_split_stage(re, im, cfg, s))
                sub = (re[:CHECK_BLOCKS], im[:CHECK_BLOCKS])
                got = cuda_tc.curscan_tc_split_stage(*sub, cfg, stage)
                want = cuda_tc.curscan_tc_split_stage_plain(*sub, cfg, stage)
                check[stage] = (tol_share(got, want, prec)
                                if bool(got.isfinite().all()) else math.inf)
            prev, parts = 0.0, []
            for stage in STAGES:
                parts.append(f"{stage} {ms[stage]:.3f} (+"
                             f"{ms[stage] - prev:.3f}, "
                             f"{(ms[stage] - prev) / ms['full']:.0%})")
                prev = ms[stage]
            print(f"  {name}: {row['smem']} B of shared memory a block, "
                  f"{row['blocks_per_sm']} blocks an SM, {row['groups']} "
                  f"window group(s)\n    stages ms: " + "; ".join(parts)
                  + "\n    each cut-off vs its plain version (first "
                  f"{CHECK_BLOCKS} blocks), share of TC_TOL: "
                  + ", ".join(f"{s} {v:.3f}" for s, v in check.items()),
                  flush=True)
            row.update(ms, check=check)
        runs = {"Kernel C": kernel_c}
        if not args.kernel_only:
            highest = cell_cfg(cfg.fft_size, cfg.cur_scan_non_overlap,
                               "HIGHEST")
            runs["FFT kernel at HIGHEST"] = (
                lambda: cuda_curscan.curscan_fused_sublane(re, im, highest))
            runs["torch.fft chain"] = lambda: torch_fft_chain(re, im, highest)
        got = {k: [] for k in runs}
        for _ in range(args.rounds):
            for k, fn in runs.items():
                got[k].append(cuda_ms(fn, warm=1 if k == "torch.fft chain"
                                      else 3,
                                      reps=3 if k == "torch.fft chain"
                                      else 10))
        med = statistics.median(got["Kernel C"])
        extra = ""
        if not args.kernel_only:
            ratio = [a / f for a, f in zip(got["Kernel C"],
                                           got["FFT kernel at HIGHEST"])]
            extra = f"; Kernel C / FFT kernel {_spread(ratio)}"
        print(f"  {name}, {args.rounds} rounds, ms least / median / most: "
              + "; ".join(f"{k} {_spread(v)}" for k, v in got.items())
              + extra + f"; bound {bms:.4f} ms ({by}), Kernel C at "
              f"{bms / med:.4f} of it", flush=True)
        row["rounds"] = got
        table[cell] = row
        del re, im
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": gpu, "cells": table}, f, indent=1)
    return table


if __name__ == "__main__":
    main(sys.argv[1:])
