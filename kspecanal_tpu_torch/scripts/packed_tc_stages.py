"""Stage table of the tensor-core packed kernel (Kernel B,
``csrc/curscan_packed_tc.cu``) on the card: the kernel cut off after each
stage on the same planes,

    copy      the thread block's set-up (the table's fragments) and every
              span's copy (cp.async) and conversion into bf16 operand planes
    products  + the products (mma.sync) of every window n-tile
    full      + |X|, the window weights, the fold and the lanes' combine:
              the production kernel

with each cell's shared memory a block, the blocks an SM holds (the CUDA
occupancy calculator), the grid and the windows a staged span.  The
cut-offs are builds of the source with ``-DKSPEC_PTC_STOP=1`` (copy) and
``2`` (products) into libraries of their own (``ops/_build.load_variant``;
their spectra are wrong by construction); ``full`` is the port's library.
Every build runs the same plan and grid (the port's library's occupancy).
Each is timed with CUDA events, median of 10 after 3 warm-ups, one launch
between two events as ``chip_smoke.py`` times (the wrapper's host time
included where the card waits for it), and on the card alone: 20 launches
captured in one CUDA graph, whose replay is timed the same way, over 20
(no host time between them); each stage's share is its delta from the
stage before.  The default cells are
quickFullScan's geometry (fft 64, ones, 90% overlap, 512-sample blocks, 71
windows) at the catch-up batch T=19616 and the serial sweep's T=1226,
float32 and u8 planes, DEFAULT and HIGH.

Each cell then runs ROUNDS rounds, each timing in turn Kernel B and K2's
FFT kernel at HIGHEST on the same planes (``cuda_packed.
curscan_fused_packed``), and prints each one's least, median and most, and
those of the ratio Kernel B / FFT kernel in a round.

``--kernel-only`` times ``cuda_tc.curscan_packed_tc`` alone at each cell,
one launch and on the card alone: it needs nothing of the package but that
wrapper, so a parent tree unpacked beside the repo is timed the same way:

    python -m kspecanal_tpu_torch.scripts.packed_tc_stages [T:U8:PREC ...]
    PYTHONPATH=<tree> python <this file> --kernel-only
"""
from __future__ import annotations

import argparse
import statistics
import sys
from typing import Dict, List, Optional, Tuple

import torch

CELLS = ("19616:f32:DEFAULT", "19616:u8:DEFAULT", "19616:f32:HIGH",
         "19616:u8:HIGH", "1226:f32:DEFAULT", "1226:u8:DEFAULT",
         "1226:f32:HIGH", "1226:u8:HIGH")
SOURCES = ("curscan_packed_tc.cu",)
STOPS = {"copy": 1, "products": 2}
ROUNDS = 10
GRAPH = 20


def cell_cfg(prec: str):
    """quickFullScan's curscan geometry as a zero-span config: fft 64, ones
    window, 90% overlap, 512-sample blocks."""
    from kspecanal_tpu_torch.config import SpecConfig
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=64, sampling_rate=2.4e6,
                      window="WIN.ONES", cur_scan_non_overlap=0.1,
                      tpu_precision=prec, x_res=64,
                      fft2full_mult4less=8).finalize()


def planes(cfg, t: int, u8: bool, gen: torch.Generator):
    shape = (t, cfg.full_size)
    if u8:
        return tuple(torch.randint(0, 256, shape, generator=gen,
                                   device="cuda", dtype=torch.uint8)
                     for _ in range(2))
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 for _ in range(2))


def graph_ms(fn, warm: int = 3, reps: int = GRAPH) -> float:
    """Milliseconds a call of ``fn()`` takes on the card alone, without the
    host's time between calls: ``reps`` calls captured in one CUDA graph
    after ``warm`` calls, the graph's replay timed as ``cuda_ms`` times a
    call (median of 10 after 3), over ``reps``."""
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay) / reps


def _spread(xs: List[float]) -> str:
    return (f"{min(xs):.4f} / {statistics.median(xs):.4f} / "
            f"{max(xs):.4f}")


def _cells(args) -> List[Tuple[int, bool, str]]:
    out = []
    for cell in args:
        t, kind, prec = cell.split(":")
        out.append((int(t), kind == "u8", prec))
    return out


def kernel_only(cells) -> Dict[Tuple[int, bool, str], Tuple[float, float]]:
    """Ms of one ``cuda_tc.curscan_packed_tc`` call at each cell: one
    launch between two events, and on the card alone (:func:`graph_ms`)."""
    from kspecanal_tpu_torch.ops import cuda_tc
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    gen = torch.Generator(device="cuda").manual_seed(0)
    got = {}
    for t, u8, prec in cells:
        cfg = cell_cfg(prec)
        re, im = planes(cfg, t, u8, gen)
        def kernel_b():
            return cuda_tc.curscan_packed_tc(re, im, cfg)
        got[t, u8, prec] = ms = (cuda_ms(kernel_b), graph_ms(kernel_b))
        print(f"  Kernel B {prec} {'u8' if u8 else 'f32'} T={t}: one launch "
              f"{ms[0]:.4f} ms, on the card alone {ms[1]:.4f} ms",
              flush=True)
        del re, im
    return got


def main(argv: Optional[List[str]] = None) -> Dict:
    """Print the stage table of each cell; returns ``{(T, u8, precision):
    {stage: ms, "card": {stage: ms}, "smem": bytes, "blocks_per_sm": n,
    "grid": g, "chunk": c, "rounds": {name: [ms, ...]}}}`` (with
    ``--kernel-only``, ``{(T, u8, precision): (ms, card ms)}``)."""
    p = argparse.ArgumentParser(prog="packed_tc_stages", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("cells", nargs="*", default=list(CELLS))
    p.add_argument("--kernel-only", action="store_true")
    args = p.parse_args(argv)
    from kspecanal_tpu_torch.utils.profiling import card_line, require_cuda
    require_cuda("packed_tc_stages")
    cells = _cells(args.cells)
    if args.kernel_only:
        print(f"device: {card_line()}; Kernel B alone (quickFullScan fft 64 "
              f"ones 90%, CUDA events, median of 10; on the card alone: a "
              f"CUDA graph of {GRAPH} calls)", flush=True)
        return kernel_only(cells)

    from kspecanal_tpu_torch.ops import _build, cuda_packed, cuda_tc
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    print(f"device: {card_line()}; Kernel B stage table (quickFullScan fft "
          f"64 ones 90%, 4M, CUDA events, median of 10; on the card alone: "
          f"a CUDA graph of {GRAPH} calls)", flush=True)
    libs = {stage: _build.load_variant(SOURCES, (f"KSPEC_PTC_STOP={stop}",))
            for stage, stop in STOPS.items()}
    libs["full"] = _build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    for t, u8, prec in cells:
        cfg = cell_cfg(prec)
        high = prec == "HIGH"
        re, im = planes(cfg, t, u8, gen)
        plan = cuda_tc.packed_tc_plan(cfg.fft_size, cfg.window_starts, u8,
                                      high)
        per_sm = cuda_tc.packed_tc_occupancy(libs["full"], u8, cfg.fft_size,
                                             high, cfg.cur_scan_cumu_mode,
                                             plan.stride)
        grid = cuda_tc.packed_tc_grid(t, sms, per_sm)
        kind = "u8" if u8 else "f32"
        print(f"  {prec} {kind} T={t}: {plan.smem} B of shared memory a "
              f"block, {per_sm} blocks an SM, grid {grid}, "
              f"{plan.chunk} windows a span ({plan.n_chunks} span(s) a "
              f"block)", flush=True)

        def kernel_b(lib=libs["full"]):
            return cuda_tc.launch_packed_tc(lib, re, im, cfg)
        row = {}
        for name, timer in (("one launch", cuda_ms),
                            ("on the card alone", graph_ms)):
            ms = {stage: timer(lambda _l=lib: kernel_b(_l))
                  for stage, lib in libs.items()}
            prev, parts = 0.0, []
            for stage in ("copy", "products", "full"):
                parts.append(f"{stage} {ms[stage]:.4f} ms "
                             f"(+{ms[stage] - prev:.4f}, "
                             f"{(ms[stage] - prev) / ms['full']:.0%})")
                prev = ms[stage]
            print(f"    {name}: " + "; ".join(parts), flush=True)
            if timer is cuda_ms:
                row.update(ms)
            else:
                row["card"] = ms
        highest = cell_cfg("HIGHEST")
        runs = {"Kernel B": kernel_b,
                "FFT kernel at HIGHEST": (
                    lambda: cuda_packed.curscan_fused_packed(re, im,
                                                             highest))}
        got = {name: [] for name in runs}
        for _ in range(ROUNDS):
            for name, fn in runs.items():
                got[name].append(cuda_ms(fn))
        ratio = [b / f for b, f in zip(got["Kernel B"],
                                       got["FFT kernel at HIGHEST"])]
        print(f"    {ROUNDS} rounds, ms least / median / most: "
              + "; ".join(f"{name} {_spread(v)}" for name, v in got.items())
              + f"; Kernel B / FFT kernel {_spread(ratio)}", flush=True)
        row.update(smem=plan.smem, blocks_per_sm=per_sm, grid=grid,
                   chunk=plan.chunk, rounds=got)
        table[t, u8, prec] = row
        del re, im
    return table


if __name__ == "__main__":
    main(sys.argv[1:])
