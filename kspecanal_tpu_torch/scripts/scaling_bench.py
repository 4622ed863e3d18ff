"""Scaling of the sharded waterfall stream over world sizes — the port of
``scripts/scaling_bench.py``.

    python -m kspecanal_tpu_torch.scripts.scaling_bench [fft] [blocks_per_rank]
        [--ranks 1,2,4] [--share-card] [--device cpu]

For each world size S (a world of S ranks, ``parallel/spawn.run_world``)
the rate of ``parallel/stream.waterfall_stream_sharded`` (fft kaiser 50%,
the zero-span main cell's chain) in two methodologies:

  weak    ``blocks_per_rank`` blocks a rank (T = blocks_per_rank * S): the
          total rate should grow with S where each rank has its own card;
  strong  fixed total work (T = blocks_per_rank * max S): the rate against
          one rank's isolates what splitting costs.

Rank 0 owns the planes on its device, so each call includes their scatter.
A call is timed on the host clock between barriers, ending in a read of
the result (the card synchronised), the median of ``--iters`` after one
warm-up.  On cards one rank a card over NCCL; ``--share-card`` puts every
rank on ``cuda:0`` over gloo (the collectives cross the host): those
rates are not scaling figures, since the card's capacity does not grow
with the ranks.  ``--device cpu`` runs gloo on the CPU (a check of the
script, no device rate).
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.parallel import mesh as mesh_mod
from kspecanal_tpu_torch.parallel.spawn import run_world
from kspecanal_tpu_torch.parallel.stream import waterfall_stream_sharded


def stream_cfg(fft: int) -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window="WIN.KAISER", cur_scan_non_overlap=0.5,
                      x_res=min(512, fft)).finalize()


def stream_rate(cfg: SpecConfig, mesh, t_blocks: int, iters: int = 5,
                seed: int = 0) -> float:
    """Samples/s of the sharded stream over ``t_blocks`` blocks of noise
    made on rank 0's device; every rank of the world calls it."""
    dev = mesh_mod.rank_device(mesh)
    planes = (None, None)
    if mesh_mod.is_root(mesh):
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = torch.randn((2, t_blocks, cfg.full_size), generator=gen,
                        device=dev)
        planes = (p[0], p[1])

    def call():
        out = waterfall_stream_sharded(*planes, cfg, mesh)
        float(out.fft_avg[0])          # the result read, the card synced

    call()
    times = []
    for _ in range(iters):
        dist.barrier()
        t0 = time.perf_counter()
        call()
        dist.barrier()
        times.append(time.perf_counter() - t0)
    return t_blocks * cfg.full_size / statistics.median(times)


def rank_main(args: Dict) -> Dict:
    """One rank of a world: the weak and strong rates."""
    s = dist.get_world_size()
    mesh = mesh_mod.make_mesh(time=s, device_type=args["device_type"],
                              share_card=args["share_card"])
    cfg = stream_cfg(args["fft"])
    bpr, max_s = args["blocks_per_rank"], args["max_ranks"]
    return {"rank": dist.get_rank(),
            "device": str(mesh_mod.rank_device(mesh)),
            "backend": dist.get_backend(),
            "weak": stream_rate(cfg, mesh, bpr * s, args["iters"]),
            "strong": stream_rate(cfg, mesh, bpr * max_s, args["iters"])}


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fft", nargs="?", type=int, default=2048)
    ap.add_argument("blocks_per_rank", nargs="?", type=int, default=1024)
    ap.add_argument("--ranks", default="")
    ap.add_argument("--share-card", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    if a.device == "cuda":
        from kspecanal_tpu_torch.utils.profiling import card_line, \
            require_cuda
        require_cuda("scaling_bench")
        from kspecanal_tpu_torch.ops import _build
        _build.load()          # one build, before the ranks load it
        print(card_line())
        cards = torch.cuda.device_count()
    backend = "nccl" if a.device == "cuda" and not a.share_card else "gloo"
    ranks = ([int(r) for r in a.ranks.split(",")] if a.ranks else
             [r for r in (1, 2, 4, 8) if a.device == "cpu" or a.share_card
              or r <= cards][:3])
    args = {"fft": a.fft, "blocks_per_rank": a.blocks_per_rank,
            "max_ranks": max(ranks), "iters": a.iters}
    rows, base = [], None
    for s in ranks:
        res = run_world("kspecanal_tpu_torch.scripts.scaling_bench:rank_main",
                        s, args, backend=backend, device_type=a.device,
                        share_card=a.share_card)[0]
        base = base or res
        rows.append({"ranks": s, **res})
        print(f"ranks={s} ({res['backend']}, rank 0 on {res['device']}): "
              f"weak {res['weak'] / 1e6:.2f} Msamp/s total "
              f"({res['weak'] / base['weak'] / s:.3f} a rank vs 1 rank), "
              f"strong {res['strong'] / 1e6:.2f} Msamp/s "
              f"({res['strong'] / base['strong']:.3f} vs 1 rank)",
              flush=True)
    if a.share_card:
        print("NOTE: the ranks share one card: not scaling figures")
    return rows


if __name__ == "__main__":
    main()
