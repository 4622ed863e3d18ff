"""Session-loop ablation on the card — the port of
``scripts/session_ablate.py``: where does one catch-up batch spend its
time, and what binds the CLI loop once acquisition runs on the card?

At the main path's geometry (fft 2048, kaiser, 50% overlap; batches of k
blocks of 16384 samples, default k = 16384 = 268 M samples; renderer off):

  synth-only        DeviceSynthIQSource.read_device_batch (tone bank)
  noise-only        DeviceNoiseIQSource.read_device_batch (u8 noise)
  dsp-only          models.zerospan.zero_span_steps on staged u8 planes
  loop(synth)       session.run_zero_span over devicesynth, 4 batches
  loop(noise)       the same over devicenoise
  loop(noise-reuse) over one staged noise buffer: the session machinery

Each row is the best of two means on the host clock, ending in a
synchronisation of the card.

    python -m kspecanal_tpu_torch.scripts.session_ablate [k]
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import torch

from kspecanal_tpu_torch.config import WINDOW_KAISER, SpecConfig
from kspecanal_tpu_torch import session as sess_mod
from kspecanal_tpu_torch.io.sources import (DeviceNoiseIQSource,
                                            DeviceSynthIQSource)
from kspecanal_tpu_torch.models import zerospan as zs
from kspecanal_tpu_torch.utils.profiling import card_line, require_cuda


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Print the table; returns ``{row: samples/s}``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    k = int(argv[0]) if argv else 16384
    require_cuda("session_ablate")
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=2048, sampling_rate=2.4e6,
                     window=WINDOW_KAISER, cur_scan_non_overlap=0.5,
                     x_res=512).finalize()
    n = cfg.full_size
    print(f"device: {card_line()}; batch={k} blocks x {n} samp = "
          f"{k * n / 1e6:.1f} Msamp", flush=True)
    rows: Dict[str, float] = {}

    def timed(label, fn, warm=1, iters=4, samples=k * n):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
            best = dt if best is None else min(best, dt)
        rows[label] = samples / best
        print(f"{label:18s} {best * 1e3:9.2f} ms   "
              f"{samples / best / 1e9:6.2f} Gsamp/s", flush=True)

    synth = DeviceSynthIQSource(seed=0)
    noise = DeviceNoiseIQSource(seed=0)
    timed("synth-only", lambda: synth.read_device_batch(k, n))
    timed("noise-only", lambda: noise.read_device_batch(k, n))
    planes = noise.read_device_batch(k, n)
    state = zs.init_state(cfg, "cuda")
    timed("dsp-only", lambda: zs.zero_span_steps(state, planes[0], planes[1],
                                                 cfg, None, False))
    del planes

    def loop(kind, batches=4):
        if kind == "synth":
            src = DeviceSynthIQSource(seed=0)
        elif kind == "noise":
            src = DeviceNoiseIQSource(seed=0)
        else:
            src = DeviceNoiseIQSource(seed=0, reuse=True)
        sess = sess_mod.Session(cfg, src, renderer=None, device="cuda",
                                catch_up=k)
        sess_mod.run_zero_span(sess, max_iters=batches * k)

    # 4 batches per run amortise the set-up as a session does; the rates
    # are per sample, comparable with the rows above.
    for kind in ("synth", "noise", "noise-reuse"):
        timed(f"loop({kind})", lambda kk=kind: loop(kk), warm=1, iters=1,
              samples=4 * k * n)
    return rows


if __name__ == "__main__":
    main()
