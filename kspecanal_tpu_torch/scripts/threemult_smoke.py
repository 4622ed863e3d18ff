"""The precision classes on the card — the port of
``scripts/threemult_smoke.py``: each class's error against the float64
oracle and its marginal rate, for the same eight jobs.

Each job runs a config through the dispatcher
(``ops.spectrum.curscan_auto_batched``): at HIGH and DEFAULT the
tensor-core kernel of ``ops/cuda_tc.py`` (4M, where the JAX gate takes 3M
but for the deep-overlap u8 job), at HIGHEST the float64 FFT kernel (the
control).  Per job:

  max_rel_err   the worst bin over ``--blocks`` IQ blocks (default 64) of
                |got - oracle| / (|oracle| + 1e-6), the oracle a serial
                float64 NumPy transcription of the reference's curscan
                (kspecanal.py:368-397) on the same planes: float32 white
                noise, or raw u8 noise decoded exactly
  ms            the call's time at T_lo and T_hi blocks: CUDA events, the
                median of ``--reps`` calls after 3 warm-ups, with the spread
                (max - min) of those calls
  marginal      (T_hi - T_lo) * full_size / (ms(T_hi) - ms(T_lo)): the
                rate with the per-call fixed cost differenced out

``--forms`` prints instead why the tensor-core kernel runs 4M where the JAX
gate runs 3M (``cuda_tc.three_mult``): for each cell of ``FORM_CELLS``,
HIGH and DEFAULT, float32 and u8 planes, the kernel's worst bin in the 3M
and the 4M form (its ``form`` argument), and on the card each form's time
on ``form_blocks(cfg)`` blocks (CUDA events, median of ``--reps``).

    python -m kspecanal_tpu_torch.scripts.threemult_smoke [--blocks B]
        [--reps R] [--forms] [--device cpu]

``--device cpu`` runs the error columns only, on the CPU with the plain
versions (no device time).
"""
from __future__ import annotations

import argparse
import statistics
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kspecanal_tpu_torch.config import SpecConfig, window_lut
from kspecanal_tpu_torch.ops import cuda_curscan, cuda_tc
from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched
from kspecanal_tpu_torch.utils.profiling import card_line, require_cuda


class Job(NamedTuple):
    name: str
    fft: int
    non_overlap: float
    precision: str
    u8: bool
    t_lo: int
    t_hi: int


# The JAX script's eight jobs ("sublane" and "lane" name the JAX layout;
# fft 16384 at 50% is the lane kernel's cell).
JOBS = (
    Job("fft2048 50% DEFAULT u8", 2048, 0.5, "DEFAULT", True, 4096, 8192),
    Job("fft2048 50% DEFAULT f32", 2048, 0.5, "DEFAULT", False, 4096, 8192),
    Job("fft2048 90% DEFAULT u8 (deep)", 2048, 0.1, "DEFAULT", True,
        4096, 8192),
    Job("fft2048 50% HIGHEST f32 (FFT kernel, control)", 2048, 0.5,
        "HIGHEST", False, 4096, 8192),
    Job("fft2048 50% HIGH f32 (bf16x3)", 2048, 0.5, "HIGH", False, 4096,
        8192),
    Job("fft2048 50% HIGH u8", 2048, 0.5, "HIGH", True, 4096, 8192),
    Job("lane cell fft16384 50% DEFAULT f32", 16384, 0.5, "DEFAULT", False,
        512, 1024),
    Job("lane cell fft16384 50% HIGH f32", 16384, 0.5, "HIGH", False, 512,
        1024),
)

# --forms: (fft, non-overlap, window, blocks): the main cell, fft 8192, the
# lane kernel's cell, and the deep-overlap (90%, ones) geometry of fmScan at
# fft 2048, 8192 and fmScan's own fft 16384.
FORM_CELLS = (
    (2048, 0.5, "WIN.KAISER", 64), (8192, 0.5, "WIN.KAISER", 64),
    (16384, 0.5, "WIN.KAISER", 64), (2048, 0.1, "WIN.ONES", 64),
    (8192, 0.1, "WIN.ONES", 64), (16384, 0.1, "WIN.ONES", 16))
# The oracle's inputs pass through a kernel this many blocks at a time (the
# plain versions hold some twenty (T, W, fft) float32 intermediates).
CHUNK = 8


def job_cfg(fft: int, non_overlap: float, precision: str,
            window: str = "WIN.KAISER") -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=non_overlap,
                      x_res=512, tpu_precision=precision).finalize()


def oracle_curscan(iq: np.ndarray, fft_size: int, non_overlap: float,
                   window: np.ndarray, cumu_mode: str = "AVG") -> np.ndarray:
    """The reference's curscan in float64, window by window
    (kspecanal.py:368-397): windows start at int(i * fftSize * nonOverlap),
    winAdj * 2 * |fft(x * win)| / fftSize, the serial cumulate (AVG:
    (acc + mag) / 2), fftshift."""
    win_adj = len(window) / np.sum(window)
    acc = None
    for i in range(int(len(iq) / (fft_size * non_overlap))):
        s = int(i * fft_size * non_overlap)
        frame = iq[s:s + fft_size]
        if len(frame) < fft_size:
            break
        mag = win_adj * 2 * np.abs(np.fft.fft(frame * window)) / fft_size
        if acc is None:
            acc = mag
        elif cumu_mode == "AVG":
            acc = (acc + mag) / 2
        elif cumu_mode == "MAX":
            acc = np.maximum(acc, mag)
        elif cumu_mode == "MIN":
            acc = np.minimum(acc, mag)
        else:
            acc = mag
    return np.fft.fftshift(acc)


def planes(cfg: SpecConfig, t: int, u8: bool, seed: int,
           device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded noise planes ``(t, full_size)``: float32 white noise, or raw
    u8 bytes."""
    rng = np.random.default_rng(seed)
    if u8:
        arrs = [rng.integers(0, 256, (t, cfg.full_size), dtype=np.uint8)
                for _ in range(2)]
    else:
        arrs = [rng.standard_normal((t, cfg.full_size)).astype(np.float32)
                for _ in range(2)]
    return tuple(torch.from_numpy(a).to(device) for a in arrs)


def oracle_error(cfg: SpecConfig, u8: bool, t_blocks: int,
                 device: torch.device, seed: int = 7,
                 fn=curscan_auto_batched) -> float:
    """``fn``'s (the dispatcher's) worst-bin error against the float64
    oracle: max over bins and blocks of |got - oracle| / (|oracle| +
    1e-6)."""
    re, im = planes(cfg, t_blocks, u8, seed, device)
    got = torch.cat([fn(re[i:i + CHUNK], im[i:i + CHUNK], cfg)
                     for i in range(0, t_blocks, CHUNK)]).cpu().numpy(
                         ).astype(np.float64)
    x = re.cpu().numpy().astype(np.float64) + 1j * im.cpu().numpy().astype(
        np.float64)
    if u8:
        x = x - (127.0 + 127.0j)
    win = window_lut(cfg.window, cfg.fft_size)
    worst = 0.0
    for b in range(t_blocks):
        want = oracle_curscan(x[b], cfg.fft_size, cfg.cur_scan_non_overlap,
                              win, cfg.cur_scan_cumu_mode)
        worst = max(worst, float(np.max(np.abs(got[b] - want)
                                        / (np.abs(want) + 1e-6))))
    return worst


def timed(cfg: SpecConfig, u8: bool, t: int, reps: int,
          device: torch.device, fn=curscan_auto_batched
          ) -> Tuple[float, float]:
    """(median ms, spread ms) of ``fn`` (the dispatcher) on ``t`` blocks:
    CUDA events around each of ``reps`` calls after 3 warm-ups."""
    re, im = planes(cfg, t, u8, t, device)
    for _ in range(3):
        fn(re, im, cfg)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(re, im, cfg)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), max(times) - min(times)


def route(cfg: SpecConfig) -> str:
    r = cuda_curscan.kernel_route(cfg)
    if r == "tc":
        return "tensor-core 4M"
    if r == "tc_split":
        return "tensor-core split 4M"
    return "FFT kernel (float64)"


def form_blocks(cfg: SpecConfig) -> int:
    """--forms times each form on about 2^26 samples of blocks."""
    return max(64, (1 << 26) // cfg.full_size)


def forms(device: torch.device, reps: int) -> Dict[tuple, dict]:
    """The --forms table: by (fft, non-overlap, window, precision, u8) the
    3M and 4M errors and, on the card, each form's ms."""
    rows = {}
    for fft, nono, window, blocks in FORM_CELLS:
        for prec in ("DEFAULT", "HIGH"):
            cfg = job_cfg(fft, nono, prec, window)
            for u8 in (False, True):
                row = {}
                line = (f"fft {fft:5d} {1 - nono:.0%} {window:10s} {prec:7s} "
                        f"{'u8 ' if u8 else 'f32'} {blocks:2d} blocks:")
                for form, name in (("force3m", "3M"), ("no3m", "4M")):
                    def fn(a, b, c, _f=form):
                        return cuda_tc.curscan_tc(a, b, c, _f)
                    row[name] = oracle_error(cfg, u8, blocks, device, fn=fn)
                    line += f"  {name} {row[name]:.3e}"
                    if device.type == "cuda":
                        t = form_blocks(cfg)
                        row[name + "_ms"] = timed(cfg, u8, t, reps, device,
                                                  fn)[0]
                        line += f" ({row[name + '_ms']:.3f} ms at T={t})"
                print(line, flush=True)
                rows[fft, nono, window, prec, u8] = row
    return rows


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--forms", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda("threemult_smoke")
        print(f"threemult_smoke on {card_line()}")
    else:
        print("threemult_smoke on the CPU: errors only, no device time")
    if args.forms:
        return forms(device, args.reps)
    rows = {}
    for job in JOBS:
        cfg = job_cfg(job.fft, job.non_overlap, job.precision)
        row = {"route": route(cfg),
               "max_rel_err": oracle_error(cfg, job.u8, args.blocks, device)}
        line = (f"{job.name:46s} {row['route']:20s} max_rel_err "
                f"{row['max_rel_err']:.3e}")
        if device.type == "cuda":
            lo, lo_spread = timed(cfg, job.u8, job.t_lo, args.reps, device)
            hi, hi_spread = timed(cfg, job.u8, job.t_hi, args.reps, device)
            rate = ((job.t_hi - job.t_lo) * cfg.full_size / (hi - lo) * 1e3
                    if hi > lo else float("nan"))
            row.update(ms_lo=lo, spread_lo=lo_spread, ms_hi=hi,
                       spread_hi=hi_spread, marginal_samp_per_s=rate)
            line += (f"  T={job.t_lo}: {lo:.3f} ms (spread {lo_spread:.3f})"
                     f"  T={job.t_hi}: {hi:.3f} ms (spread {hi_spread:.3f})"
                     f"  marginal {rate / 1e9:.2f} Gsamp/s")
        print(line, flush=True)
        rows[job.name] = row
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
