"""The card's read rate — the port of ``scripts/probe_membw.py``: what
rate can any implementation get when it streams the curscan's planes, the
roofline's memory bound for the curscan kernels.

At several T of float32 planes ``(T, 16384)`` (fft 2048's full_size):

  sum      ``torch.sum`` of both planes (a pure read)
  row-sum  ``sum(dim=1)`` of both planes (the kernels' output shape)
  copy     both planes copied (a read plus a write)
  K4 read  K4's 'read' stage, every sample read once into (T, 16, 128):
           Kernel A's read cut-off, of the HIGHEST build and the DEFAULT
           one

each timed with CUDA events around 10 back-to-back calls (median of 10,
per call: ``utils.profiling.cuda_ms_each``), with the
bytes it moves (each input read once, each output written once) over its
time in GB/s, beside the card's name and power limit.

    python -m kspecanal_tpu_torch.scripts.probe_membw [T ...]
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.ops import cuda_curscan as cc
from kspecanal_tpu_torch.ops import cuda_tc
from kspecanal_tpu_torch.scripts.roofline_r2 import stage_cfg
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms_each, \
    require_cuda


def main(argv: Optional[List[str]] = None
         ) -> Dict[Tuple[int, str], float]:
    """Print the table; returns ``{(T, row): GB/s}``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ts = [int(a) for a in argv] or [1024, 2048, 4096]
    require_cuda("probe_membw")
    cfgs = {"HIGHEST": stage_cfg(2048), "DEFAULT": stage_cfg(2048,
                                                             "DEFAULT")}
    full = cfgs["HIGHEST"].full_size
    cuda_tc.build_stage_libraries()
    cuda_tc.build_stage_libraries(highest=True)
    print(f"device: {card_line()}; float32 planes (T, {full}), CUDA "
          f"events around 10 calls, median of 10", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rates: Dict[Tuple[int, str], float] = {}
    for t in ts:
        planes = torch.randn((2, t, full), generator=gen, device="cuda")
        re, im = planes[0], planes[1]
        nbytes = planes.numel() * 4
        out_k4 = t * 2048 * 4
        dst = torch.empty_like(planes)
        rows = {
            "sum": (lambda: torch.sum(re) + torch.sum(im), nbytes),
            "row-sum": (lambda: re.sum(dim=1) + im.sum(dim=1),
                        nbytes + 4 * t * 2),
            "copy": (lambda: dst.copy_(planes), 2 * nbytes),
        }
        for prec, cfg in cfgs.items():
            rows[f"K4 read {prec}"] = (
                lambda c=cfg: cc.curscan_stage_ablate(re, im, c, "read"),
                nbytes + out_k4)
        for name, (fn, moved) in rows.items():
            ms = cuda_ms_each(fn)
            rates[t, name] = moved / ms / 1e6
            print(f"T={t:5d} {name:16s} {ms:9.4f} ms {moved / 1e6:9.1f} MB "
                  f"{rates[t, name]:8.1f} GB/s", flush=True)
        del planes, re, im, dst
    return rates


if __name__ == "__main__":
    main()
