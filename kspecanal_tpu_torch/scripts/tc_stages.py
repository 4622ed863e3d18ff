"""Stage table of the tensor-core kernel (Kernel A, ``csrc/curscan_tc.cuh``)
on the card: the kernel cut off after each stage on the same planes,

    frame   the block's set-up (zero fill, the tables' copies) and the
            windowed frames staged as bf16 operand planes, every pass
    stage1  + stage 1 (B = F1 A) and the twiddle, C written over the frame
    full    + stage 2 (D = C F2^T), |D| and the fold: the production kernel

(frame and stage1 are K4's cut-offs 'frame' and 's1tw', each of which also
folds its stage's weighted re + im into the output: the stage times include
that reduction)

in the production (4M) form, with each cell's shared memory a block
(``layout()`` of ``csrc/curscan_tc.cuh``), the blocks an SM holds (the
CUDA occupancy calculator: registers and shared memory), its window groups
and windows a pass.  The cut-offs are builds of Kernel A's two
sources with ``-DKSPEC_TC_STOP=2`` (frame) and ``4`` (stage1) into
libraries of their own (``ops/cuda_tc.stage_library``); ``full`` is the
port's library.  Every build runs
the window groups that ``cuda_tc.tc_groups`` gives at the port's library's
occupancy, so all three time the same grid; where those are more than one,
the table is printed again at one group.  Each is timed with CUDA events
(median of 10 after 3 warm-ups), and each stage's share is its delta from
the stage before.  The default cells are the precision rows of
``chip_smoke.py``'s timing phase: zero-span fft 2048 kaiser 50% (T=4096),
fmScan's fft 16384 ones 90% and the lane kernel's cell fft 16384 kaiser 50%
(T=288), float32 planes.

Each cell then runs ROUNDS rounds, each timing in turn (the same way) the
production kernel at its groups, at one group (where its groups are more
than one) and the FFT kernel at HIGHEST on the same planes
(``cuda_curscan.curscan_fused_sublane``), and prints each one's least,
median and most, and those of the ratio Kernel A / FFT kernel in a round.

    python -m kspecanal_tpu_torch.scripts.tc_stages [FFT:NONO:WIN:T:PREC ...]
"""
from __future__ import annotations

import argparse
import statistics
import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.ops import _build, cuda_curscan, cuda_tc
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    require_cuda

CELLS = ("2048:0.5:WIN.KAISER:4096:DEFAULT", "2048:0.5:WIN.KAISER:4096:HIGH",
         "16384:0.1:WIN.ONES:288:DEFAULT", "16384:0.5:WIN.KAISER:288:DEFAULT",
         "16384:0.5:WIN.KAISER:288:HIGH")
SOURCES = cuda_tc.TC_SOURCES
STOPS = {"frame": "frame", "stage1": "s1tw"}     # name: K4's cut-off
ROUNDS = 10


def cell_cfg(fft: int, nono: float, window: str, prec: str) -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=nono,
                      tpu_precision=prec, x_res=512).finalize()


def _spread(xs: List[float]) -> str:
    return (f"{min(xs):.3f} / {statistics.median(xs):.3f} / "
            f"{max(xs):.3f}")


def main(argv: Optional[List[str]] = None
         ) -> Dict[Tuple[int, float, str, int, str], Dict[str, float]]:
    """Print the stage table of each cell; returns ``{(fft, nono, window,
    T, precision): {stage: ms, "one_group": {stage: ms} (G > 1), "smem":
    bytes, "blocks_per_sm": n, "groups": G, "rounds": {name: [ms,
    ...]}}}``."""
    p = argparse.ArgumentParser(prog="tc_stages", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("cells", nargs="*", default=list(CELLS))
    args = p.parse_args(argv)
    require_cuda("tc_stages")
    print(f"device: {card_line()}; Kernel A stage table (4M, float32 "
          f"planes, CUDA events, median of 10)", flush=True)
    _build.build([(SOURCES, (f"KSPEC_TC_STOP={cuda_tc.tc_stage_stop(s)}",))
                  for s in STOPS.values()], library=False)
    libs = {name: cuda_tc.stage_library(s) for name, s in STOPS.items()}
    libs["full"] = _build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    for cell in args.cells:
        fft, nono, window, t, prec = cell.split(":")
        cfg = cell_cfg(int(fft), float(nono), window, prec)
        t = int(t)
        re = torch.randn((t, cfg.full_size), generator=gen, device="cuda")
        im = torch.randn((t, cfg.full_size), generator=gen, device="cuda")
        n1 = cfg.fft_size // 128
        wb = cuda_tc.tc_windows_per_pass(n1, cfg.num_windows)
        high = prec == "HIGH"
        smem = libs["full"].kspec_curscan_tc_smem(n1, wb, int(high), 0)
        per_sm = cuda_tc.tc_occupancy(libs["full"], False, n1, wb, high,
                                      False)
        groups = cuda_tc.tc_groups(t, n1, cfg.num_windows, sms, per_sm)

        def kernel_a(lib=libs["full"], g=groups):
            return cuda_tc.launch_tc(lib, re, im, cfg, False, g)
        print(f"  fft {cfg.fft_size} {1 - cfg.cur_scan_non_overlap:.0%} "
              f"{cfg.window} {prec} T={t}: {smem} B of shared memory a "
              f"block, {per_sm} blocks an SM, {groups} window group(s), "
              f"{wb} window(s) a pass", flush=True)
        row = {}
        for g in dict.fromkeys((groups, 1)):
            ms = {stage: cuda_ms(lambda _l=lib: kernel_a(_l, g))
                  for stage, lib in libs.items()}
            prev, parts = 0.0, []
            for stage in ("frame", "stage1", "full"):
                parts.append(f"{stage} {ms[stage]:.3f} ms "
                             f"(+{ms[stage] - prev:.3f}, "
                             f"{(ms[stage] - prev) / ms['full']:.0%})")
                prev = ms[stage]
            print(f"    {g} group(s): " + "; ".join(parts), flush=True)
            if g == groups:
                row.update(ms)
            else:
                row["one_group"] = ms
        highest = cell_cfg(cfg.fft_size, cfg.cur_scan_non_overlap,
                           cfg.window, "HIGHEST")
        runs = {"Kernel A": kernel_a}
        if groups > 1:
            runs["Kernel A at 1 group"] = lambda: kernel_a(g=1)
        runs["FFT kernel at HIGHEST"] = (
            lambda: cuda_curscan.curscan_fused_sublane(re, im, highest))
        got = {name: [] for name in runs}
        for _ in range(ROUNDS):
            for name, fn in runs.items():
                got[name].append(cuda_ms(fn))
        ratio = [a / f for a, f in zip(got["Kernel A"],
                                       got["FFT kernel at HIGHEST"])]
        print(f"    {ROUNDS} rounds, ms least / median / most: "
              + "; ".join(f"{name} {_spread(v)}" for name, v in got.items())
              + f"; Kernel A / FFT kernel {_spread(ratio)}", flush=True)
        row.update(smem=smem, blocks_per_sm=per_sm, groups=groups,
                   rounds=got)
        table[cfg.fft_size, cfg.cur_scan_non_overlap, cfg.window, t,
              prec] = row
        del re, im
    return table


if __name__ == "__main__":
    main(sys.argv[1:])
