"""quickFullScan sweep ablation on the card — the port of
``scripts/qfs_ablate.py``: where does one sweep's time go?

One quickFullScan sweep (1226 bands x 512 samples, fft 64, ones, 90%
overlap; nothing cut) split into its parts, beside the whole sweep as the
serial session runs it:

  acquire (host synth)  session.acquire_sweep over SynthIQSource: the host
  upload                the sweep's float32 planes to the card
  curscans (K2)         ops.spectrum.curscan_auto_batched on (B, 512) planes
  display chain         models.scan.band_display (sentinel, clip, LogNoGain)
  stitch                models.scan._gathered_curves (gathers, Max/Min/Avg)
  epilogue              models.scan._sweeps_epilogue (heatmap row, ring,
                        the new state)
  sweep_step            models.scan.sweep_step: the last four, as a session
                        calls them
  run_scan sweep        session.run_scan over the host synth, per sweep

Device rows take CUDA events, the median of 10 after 3 warm-ups
(``utils.profiling.cuda_ms``); the host rows (acquire, run_scan) the host
clock, ending in a synchronisation of the card.

    python -m kspecanal_tpu_torch.scripts.qfs_ablate [--bands B] [--sweeps K]
        [--device cpu]

``--bands B`` (even) keeps the first B bands; ``--device cpu`` runs the same
split on the CPU, every row on the host clock (a check of the script, no
device time).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from kspecanal_tpu_torch import session as sess_mod
from kspecanal_tpu_torch.cli import parse_args
from kspecanal_tpu_torch.io.sources import SynthIQSource
from kspecanal_tpu_torch.models import scan as scan_mod
from kspecanal_tpu_torch.ops import cuda_packed
from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched
from kspecanal_tpu_torch.utils.profiling import (card_line, cuda_ms,
                                                 require_cuda)


def host_ms(fn: Callable[[], object], device: torch.device, warm: int = 1,
            reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` on the host clock, each call ending
    in a synchronisation of ``device`` when it is a card."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warm):
        fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def qfs_config(bands: int = 0):
    """quickFullScan's config, cut to its first ``bands`` bands if given."""
    cfg = parse_args(["quickFullScan", "tpuLogIter", "false"])[0]
    if bands:
        span = cfg.sampling_rate * cfg.scan_range_non_overlap
        cfg = dataclasses.replace(
            cfg, end_freq=cfg.start_freq + bands * span).finalize()
    return cfg


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Print the table; returns ``{row: ms}``."""
    ap = argparse.ArgumentParser(prog="qfs_ablate")
    ap.add_argument("--bands", type=int, default=0)
    ap.add_argument("--sweeps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda("qfs_ablate")
        where = f"device: {card_line()}"

        def dev_ms(fn):
            return cuda_ms(fn)
    else:
        where = "device: cpu (host clock; no device time)"

        def dev_ms(fn):
            return host_ms(fn, device)
    cfg = qfs_config(args.bands)
    plan = sess_mod.make_plan_cached(cfg)
    b = plan.num_bands
    print(f"{where}; quickFullScan sweep: {b} bands x {cfg.full_size} "
          f"samples, fft {cfg.fft_size}, {cfg.num_windows} windows a band",
          flush=True)
    rows: Dict[str, float] = {}

    def row(label, ms):
        rows[label] = ms
        print(f"{label:22s} {ms:10.4f} ms", flush=True)

    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, gain=0.5, seed=0)
    sweep = sess_mod.acquire_sweep(src, cfg, plan)
    row("acquire (host synth)",
        host_ms(lambda: sess_mod.acquire_sweep(src, cfg, plan), device))
    row("upload", dev_ms(lambda: (torch.from_numpy(sweep[0]).to(device),
                                  torch.from_numpy(sweep[1]).to(device))))
    re = torch.from_numpy(sweep[0]).to(device)
    im = torch.from_numpy(sweep[1]).to(device)
    oks = torch.ones(b, dtype=torch.bool, device=device)
    state = scan_mod.init_state(cfg, plan, device)
    tbl = scan_mod._gather_tables(cfg, plan, device)
    lin = curscan_auto_batched(re, im, cfg)
    spectra = scan_mod.band_display(lin, oks, cfg)
    curves = scan_mod._gathered_curves(state, spectra[None], cfg, tbl)
    row("curscans (K2)", dev_ms(lambda: curscan_auto_batched(re, im, cfg)))
    row("display chain", dev_ms(lambda: scan_mod.band_display(lin, oks, cfg)))
    row("stitch", dev_ms(lambda: scan_mod._gathered_curves(
        state, spectra[None], cfg, tbl)))
    row("epilogue", dev_ms(lambda: scan_mod._sweeps_epilogue(
        state, curves, cfg, None)))
    row("sweep_step", dev_ms(lambda: scan_mod.sweep_step(
        state, re, im, oks, cfg, plan)))

    k = args.sweeps
    sess = sess_mod.Session(cfg, SynthIQSource(
        center_freq=cfg.center_freq, sample_rate=cfg.sampling_rate, gain=0.5,
        seed=0), renderer=None, device=device)
    before = cuda_packed.launches
    row("run_scan sweep", host_ms(lambda: sess_mod.run_scan(sess, k), device,
                                  warm=0, reps=1) / k)
    sweep_ms = rows["run_scan sweep"]
    parts = sum(rows[r] for r in ("acquire (host synth)", "upload",
                                  "sweep_step"))
    print(f"run_scan: {k} sweeps, K2 launches {cuda_packed.launches - before};"
          f" acquire + upload + sweep_step = {parts:.4f} ms, "
          f"{parts / sweep_ms * 100:.1f}% of a sweep; curscans "
          f"{rows['curscans (K2)'] / sweep_ms * 100:.2f}% of it", flush=True)
    check = np.isfinite(sess.final_avg).all()
    print(f"final average finite: {bool(check)}", flush=True)
    if not check:
        raise RuntimeError("qfs_ablate: the session's final average is not "
                           "finite")
    return rows


if __name__ == "__main__":
    main()
