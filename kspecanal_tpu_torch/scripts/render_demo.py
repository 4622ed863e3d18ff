"""Render a demo session to PNG (headless Agg) — the port of
``scripts/render_demo.py``, a visual smoke artifact: the levels plot with
peak markers and the waterfall heatmap (``gui.MatplotlibRenderer``), driven
by the synthetic multi-tone source through the zero-span session on the
card (tones must land on MHz gridlines, the reference's visual correctness
check — SURVEY.md §4.1).

    python -m kspecanal_tpu_torch.scripts.render_demo [out.png] [--device cpu]

Needs matplotlib.  The session runs on the card unless ``--device cpu``
asks for the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from kspecanal_tpu_torch import session as sess_mod
from kspecanal_tpu_torch.cli import parse_args
from kspecanal_tpu_torch.io.sources import SynthIQSource


def main(argv: Optional[List[str]] = None) -> str:
    """Render 24 iterations and save the figure; returns its path."""
    ap = argparse.ArgumentParser(prog="render_demo")
    ap.add_argument("out", nargs="?", default="kspec_demo.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: render_demo runs the session on "
                           "the card (pass --device cpu to run its plain "
                           "PyTorch path)")
    import matplotlib
    matplotlib.use("Agg")
    from kspecanal_tpu_torch.gui import MatplotlibRenderer

    cfg, _ = parse_args(["zeroSpan", "centerFreq", "92e6", "samplingRate",
                         "2.4e6", "fftSize", "1024", "xRes", "512",
                         "window", "hanning"])
    renderer = MatplotlibRenderer(cfg, interactive=False)
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, gain=3.0, seed=42)
    sess = sess_mod.Session(cfg, src, renderer=renderer, device=device)
    sess_mod.run_zero_span(sess, max_iters=24)
    renderer.fig.savefig(args.out, dpi=110)
    renderer.close()
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
