"""fmScan sweep ablation on the card — the port of ``scripts/fm_ablate.py``:
where does a batched fmScan step (``models.scan.sweep_steps``) spend its
time?

At fmScan's plan (18 bands of 88-109.6 MHz; fft 2048 as in the JAX script,
``--fft`` for another) over S sweeps (default 64) of float32 planes
``(S, B, full_size)``:

  curscans (K1)        ops.spectrum.curscan_auto_batched on (S*B, full)
  curscans + display   models.scan.band_spectra (+ sentinel, clip,
                       LogNoGain)
  curscans + stitch    band_spectra, then the gathered stitch's curves
                       (models.scan._gathered_curves) without the epilogue
  sweep_steps          the whole batched step (+ heatmap rows, ring, state)
  stitch alone         models.scan._stitch_sweeps_gathered on the spectra
  gathers alone        the stitch's two column gathers over (S, B*fft)

Device rows take CUDA events, the median of 10 after 3 warm-ups
(``utils.profiling.cuda_ms``), with Gsamp/s over the S*B*full samples.

    python -m kspecanal_tpu_torch.scripts.fm_ablate [--fft N] [--sweeps S]
        [--bands B] [--device cpu]

``--bands B`` (even) keeps the first B bands; ``--device cpu`` runs the same
split on the CPU, every row on the host clock (a check of the script, no
device time).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Optional

import torch

from kspecanal_tpu_torch import session as sess_mod
from kspecanal_tpu_torch.cli import parse_args
from kspecanal_tpu_torch.models import scan as scan_mod
from kspecanal_tpu_torch.ops import cuda_curscan
from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched
from kspecanal_tpu_torch.scripts.qfs_ablate import host_ms
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    require_cuda


def fm_config(fft: int, bands: int = 0):
    """fmScan's config at ``fft``, cut to its first ``bands`` bands if
    given."""
    cfg = parse_args(["fmScan", "fftSize", str(fft), "tpuLogIter",
                      "false"])[0]
    if bands:
        span = cfg.sampling_rate * cfg.scan_range_non_overlap
        cfg = dataclasses.replace(
            cfg, end_freq=cfg.start_freq + bands * span).finalize()
    return cfg


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Print the table; returns ``{row: ms}``."""
    ap = argparse.ArgumentParser(prog="fm_ablate")
    ap.add_argument("--fft", type=int, default=2048)
    ap.add_argument("--sweeps", type=int, default=64)
    ap.add_argument("--bands", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda("fm_ablate")
        where = f"device: {card_line()}"

        def dev_ms(fn):
            return cuda_ms(fn)
    else:
        where = "device: cpu (host clock; no device time)"

        def dev_ms(fn):
            return host_ms(fn, device)
    cfg = fm_config(args.fft, args.bands)
    plan = sess_mod.make_plan_cached(cfg)
    s, b = args.sweeps, plan.num_bands
    samples = s * b * cfg.full_size
    print(f"{where}; fmScan fft {cfg.fft_size}: {b} bands x "
          f"{cfg.full_size} samples, {s} sweeps ({samples / 1e6:.1f} Msamp), "
          f"{plan.total_entries} bins", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    re = torch.randn((s, b, cfg.full_size), generator=gen, device=device)
    im = torch.randn((s, b, cfg.full_size), generator=gen, device=device)
    oks = torch.ones((s, b), dtype=torch.bool, device=device)
    state = scan_mod.init_state(cfg, plan, device)
    tbl = scan_mod._gather_tables(cfg, plan, device)
    if tbl is None:
        raise ValueError("fm_ablate: the plan admits no gathered stitch")
    re2, im2 = (x.reshape(s * b, -1) for x in (re, im))
    oks2 = oks.reshape(s * b)
    rows: Dict[str, float] = {}

    def row(label, fn):
        rows[label] = dev_ms(fn)
        print(f"{label:20s} {rows[label]:10.4f} ms "
              f"{samples / rows[label] / 1e6:8.3f} Gsamp/s", flush=True)

    before = cuda_curscan.launches
    row("curscans (K1)", lambda: curscan_auto_batched(re2, im2, cfg))
    row("curscans + display", lambda: scan_mod.band_spectra(re2, im2, oks2,
                                                            cfg))
    row("curscans + stitch", lambda: scan_mod._gathered_curves(
        state, scan_mod.band_spectra(re2, im2, oks2, cfg).reshape(
            s, b, -1), cfg, tbl))
    row("sweep_steps", lambda: scan_mod.sweep_steps(state, re, im, oks, cfg,
                                                    plan))
    spectra = scan_mod.band_spectra(re2, im2, oks2, cfg).reshape(s, b, -1)
    row("stitch alone", lambda: scan_mod._stitch_sweeps_gathered(
        state, spectra, cfg, tbl, None))
    flat = spectra.reshape(s, -1)
    g1, g2 = tbl[0], tbl[2]
    row("gathers alone", lambda: (flat.index_select(1, g1)
                                  + flat.index_select(1, g2)))
    print(f"K1 launches over the rows: {cuda_curscan.launches - before}",
          flush=True)
    return rows


if __name__ == "__main__":
    main()
