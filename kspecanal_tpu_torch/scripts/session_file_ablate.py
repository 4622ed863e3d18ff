"""Stage reconciliation of the file-source session on the card — the port
of ``scripts/session_file_ablate.py``: do the session's stages explain each
thread's wall time?

A zero-span catch-up session (fft 2048, kaiser, 50% overlap, renderer off)
reads a u8 capture file (64 blocks of random bytes, wrapping), with
``tpuCatchUp`` batches of ``catch_up`` blocks, after a warm-up session of
one batch.  The port's ``StageTimer`` splits it:

  main thread    acquire (with wait.acquire_worker, waiting for the
                 batch), dsp, render, wait.drain (the final read-back)
  worker thread  acquire.read (source pops), acquire.split (deinterleave),
                 acquire.xfer (pinned upload on the copy stream, with
                 wait.upload for its own copy)

The worker overlaps the main thread, so the two columns are not summed:
each must account for its own thread's time.  The table gives each
stage's seconds, its share of the wall and its rate, and the share of
the wall the main thread's stages explain (target >= 95%).

    python -m kspecanal_tpu_torch.scripts.session_file_ablate [n_iters]
        [catch_up] [--device cpu]

``--device cpu`` runs the same session on the CPU (a check of the script;
the stages then time the plain versions).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kspecanal_tpu_torch import session as sess_mod
from kspecanal_tpu_torch.config import WINDOW_KAISER, SpecConfig
from kspecanal_tpu_torch.io import sources
from kspecanal_tpu_torch.utils.profiling import card_line, require_cuda

MAIN_STAGES = ("acquire", "dsp", "render", "wait.drain")
WORKER_STAGES = ("acquire.read", "acquire.split", "acquire.xfer")


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Print the table; returns ``{stage: seconds, 'wall': seconds}``."""
    ap = argparse.ArgumentParser(prog="session_file_ablate")
    ap.add_argument("n_iters", type=int, nargs="?", default=8192)
    ap.add_argument("catch_up", type=int, nargs="?", default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda("session_file_ablate")
        where = f"device: {card_line()}"
    else:
        where = "device: cpu (host clock)"
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=2048, sampling_rate=2.4e6,
                     window=WINDOW_KAISER, cur_scan_non_overlap=0.5,
                     x_res=512).finalize()
    rng = np.random.default_rng(0)
    fd, path = tempfile.mkstemp(suffix=".iq")
    with os.fdopen(fd, "wb") as f:
        f.write(rng.integers(0, 256, 64 * 2 * cfg.full_size,
                             dtype=np.uint8).tobytes())
    try:
        src, fallback = sources.make_file_source(
            path, center_freq=cfg.center_freq, sample_rate=cfg.sampling_rate,
            gain=cfg.gain)
        print(f"{where}; source: {type(src).__name__}"
              f"{f' (fallback: {fallback})' if fallback else ''}; "
              f"full_size={cfg.full_size}, {args.n_iters} blocks "
              f"({args.n_iters * cfg.full_size / 1e6:.0f} Msamp, "
              f"{2 * args.n_iters * cfg.full_size / 1e6:.0f} MB of u8), "
              f"tpuCatchUp {args.catch_up}", flush=True)
        warm = sess_mod.Session(cfg, src, renderer=None, device=device,
                                catch_up=args.catch_up)
        sess_mod.run_zero_span(warm, max_iters=args.catch_up)
        sess = sess_mod.Session(cfg, src, renderer=None, device=device,
                                catch_up=args.catch_up)
        t0 = time.perf_counter()
        sess_mod.run_zero_span(sess, max_iters=args.n_iters)
        wall = time.perf_counter() - t0
        src.close()
    finally:
        os.unlink(path)
    total = args.n_iters * cfg.full_size
    print(f"wall {wall:.3f} s = {total / wall / 1e6:.1f} Msamp/s", flush=True)
    out: Dict[str, float] = {"wall": wall}
    for group, names in (("main", MAIN_STAGES), ("worker", WORKER_STAGES)):
        tot = 0.0
        for name in names:
            st = sess.timer.total(name)
            out[name] = st
            tot += st
            rate = sess.timer.rate(name) / 1e6
            print(f"  [{group}] {name:14s} {st:8.3f} s {st / wall:6.1%} of "
                  f"wall ({rate:.1f} Msamp/s)", flush=True)
        print(f"  [{group}] TOTAL          {tot:8.3f} s {tot / wall:6.1%} of "
              f"wall", flush=True)
    explained = sum(out[n] for n in MAIN_STAGES) / wall
    print(f"main-thread stages explain {explained:.1%} of the wall "
          f"(target >= 95%)", flush=True)
    return out


if __name__ == "__main__":
    main()
