"""The sharded programs at S ranks against the unsharded port — the
counterpart of ``__graft_entry__.dryrun_multichip``.

    python -m kspecanal_tpu_torch.scripts.dryrun_multichip [S] [--device cpu]
        [--share-card]

A world of S ranks (``parallel/spawn.run_world``: one rank a card over
NCCL, ranks sharing ``cuda:0`` over gloo with ``--share-card``, gloo on
the CPU with ``--device cpu``) runs each case of :data:`SMALL` (fft 128,
hanning, 50% overlap):

  * ``stream``: the sharded stream over the ``time`` ranks, float32 or raw
    u8 planes, against ``waterfall_stream`` (rows gathered to rank 0);
  * ``time`` / ``fft``: the time-sharded curscan (halo exchange) and the
    fft-sharded curscan against ``ops.spectrum.curscan``, the same
    ``torch.fft`` chain unsharded;
  * ``band``: one band-sharded sweep (one band failing its retune) on a
    ``(S/2, 2)`` mesh where S >= 4 is even (the time ranks hold replicas)
    else ``(1, S)``, against ``models.scan.sweep_step``.

Rank 0 holds each result to the unsharded port within the per-bin bound
(rtol 5e-5 plus atol 1e-6 of the peak).  On the card each rank counts the
launches of the FFT kernel (K1) and the packed kernel (K2) in its sharded
calls only, and each case must launch the kernel its route names.  The
script prints ``dryrun ok``.  :func:`rank_main` also serves
``chip_smoke.py``'s mesh phase and the card tests, which hand it the
full-width cases, ``cli.main`` runs and stream rates.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import torch
import torch.distributed as dist

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.models import scan as scan_mod
from kspecanal_tpu_torch.ops import cuda_curscan, cuda_packed, spectrum
from kspecanal_tpu_torch.parallel import mesh as mesh_mod
from kspecanal_tpu_torch.parallel import stream
from kspecanal_tpu_torch.parallel.bandshard import sweep_step_band_sharded
from kspecanal_tpu_torch.parallel.fftshard import (curscan_fft_sharded,
                                                   supports_fft_sharding)
from kspecanal_tpu_torch.parallel.spawn import run_world
from kspecanal_tpu_torch.parallel.timeshard import curscan_time_sharded

SMALL_ZS = {"fft": 128, "nono": 0.5, "window": "WIN.HANNING", "mode": "AVG"}
SMALL = {
    "stream": [dict(SMALL_ZS, blocks=8, u8=False),
               dict(SMALL_ZS, blocks=8, u8=True)],
    "time": [SMALL_ZS], "fft": [SMALL_ZS],
    "band": ["small"],
}
TARGET = "kspecanal_tpu_torch.scripts.dryrun_multichip:rank_main"


def zs_cfg(c: Dict) -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=c["fft"],
                      sampling_rate=2.4e6, window=c["window"],
                      cur_scan_non_overlap=c["nono"],
                      cur_scan_cumu_mode=c["mode"],
                      x_res=min(512, c["fft"])).finalize()


def scan_cfg(preset: str) -> SpecConfig:
    """``"FMSCAN"`` / ``"QUICKFULLSCAN"`` (the presets), or ``"small"``: 7
    bands of fft 128 (sentinel padding at 2 and 4 ranks)."""
    if preset != "small":
        return SpecConfig(prg_mode=preset).finalize()
    return SpecConfig(prg_mode="SCAN", start_freq=88e6, end_freq=97e6,
                      sampling_rate=2e6, fft_size=128, x_res=128,
                      window="WIN.HANNING", cur_scan_non_overlap=0.5,
                      scan_range_non_overlap=0.75).finalize()


def bound_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-bin error as a share of the bound (<= 1 passes)."""
    err = (got.double() - want.double()).abs()
    ref = want.double().abs()
    return (err / (5e-5 * ref + 1e-6 * ref.max())).max().item()


def _kernel(cfg: SpecConfig) -> int:
    """Which counter the dispatcher's route for ``cfg`` moves on the card:
    0 the FFT kernel (K1), 1 the packed kernel (K2), None neither."""
    if cuda_curscan.supports_fused_sublane(cfg):
        return 0
    return 1 if cuda_packed.supports_fused_packed(cfg) else None


def rank_main(args: Dict) -> Dict:
    """One rank: every case of ``args`` (keys of :data:`SMALL`, plus
    ``band_mesh``: ``[time, band]`` of the band cases' mesh, ``cli``:
    ``[argv, time, band]`` runs of ``cli.main`` on the mesh, and
    ``rates``: ``{"fft", "blocks"}`` stream rates).  Returns the rank's
    device, backend, launches by case and, on rank 0, the bound shares and
    max abs errors by case."""
    from kspecanal_tpu_torch import cli
    s, root = dist.get_world_size(), dist.get_rank() == 0
    kw = dict(device_type=args["device_type"], share_card=args["share_card"])
    t_start = time.perf_counter()
    mesh_t = mesh_mod.make_mesh(time=s, **kw)
    bt, bb = args.get("band_mesh") or ((s // 2, 2) if s >= 4 and s % 2 == 0
                                       else (1, s))
    mesh_b = mesh_mod.make_mesh(time=bt, band=bb, **kw)
    dev = mesh_mod.rank_device(mesh_t)
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"rank": dist.get_rank(), "device": str(dev),
           "backend": dist.get_backend(), "launches": {}, "shares": {},
           "max_abs_err": {}}

    def sharded(name, cfg, fn, routed=True):
        """``fn()`` with the kernels' launches on this rank counted and,
        where ``routed``, the route's kernel required to have launched on
        the card."""
        before = (cuda_curscan.launches, cuda_packed.launches)
        out = fn()
        counts = [cuda_curscan.launches - before[0],
                  cuda_packed.launches - before[1]]
        res["launches"][name] = counts
        k = _kernel(cfg)
        if routed and on_card and k is not None and counts[k] == 0:
            raise RuntimeError(f"{name}: rank {dist.get_rank()} launched "
                               f"no kernel")
        return out

    def check(name, got, want):
        if not root:
            return
        share = bound_share(got, want)
        res["shares"][name] = share
        res["max_abs_err"][name] = (got.double() - want.double()).abs() \
            .max().item()
        if got.shape != want.shape or not share <= 1.0:
            raise RuntimeError(f"{name}: {share:.3f} of the bound")

    def noise(shape, u8=False):
        """Planes of noise on rank 0 (None on the others: rank 0 owns the
        source)."""
        if not root:
            return (None,) * shape[0]
        if u8:
            return torch.randint(0, 256, shape, generator=gen, device=dev,
                                 dtype=torch.uint8)
        return torch.randn(shape, generator=gen, device=dev)

    for c in args.get("stream", []):
        cfg = zs_cfg(c)
        name = (f"stream fft {cfg.fft_size} T={c['blocks']} "
                f"{'u8' if c['u8'] else 'f32'}")
        re, im = noise((2, c["blocks"], cfg.full_size), c["u8"])
        out = sharded(name, cfg, lambda: stream.waterfall_stream_sharded(
            re, im, cfg, mesh_t))
        rows = mesh_mod.gather_rows(out.rows, mesh_t)
        if root:
            want = stream.waterfall_stream(re, im, cfg)
            check(f"{name} rows", rows, want.rows)
            for f in ("fft_max", "fft_min", "fft_avg", "fft_cur"):
                check(f"{name} {f}", getattr(out, f), getattr(want, f))
        del re, im
    for kind, fn in (("time", curscan_time_sharded),
                     ("fft", curscan_fft_sharded)):
        for c in args.get(kind, []):
            cfg = zs_cfg(c)
            if kind == "fft" and not supports_fft_sharding(cfg, s):
                continue
            name = (f"{kind}-sharded curscan fft {cfg.fft_size} "
                    f"{cfg.cur_scan_non_overlap} {cfg.cur_scan_cumu_mode}")
            re, im = noise((2, cfg.full_size))
            got = fn(re, im, cfg, mesh_t)
            if root:
                check(name, got, spectrum.curscan(re, im, cfg))
    for preset in args.get("band", []):
        cfg = scan_cfg(preset)
        plan = scan_mod.make_scan_plan(cfg)
        b = plan.num_bands
        name = f"band-sharded sweep {preset} ({b} bands)"
        re, im = noise((2, b, cfg.full_size))
        oks = None
        if root:
            oks = torch.ones(b, dtype=torch.bool, device=dev)
            oks[1] = False
        state0 = scan_mod.init_state(cfg, plan, dev)
        state = sharded(name, cfg, lambda: sweep_step_band_sharded(
            state0, re, im, oks, cfg, plan, mesh_b))
        if root:
            want = scan_mod.sweep_step(state0, re, im, oks, cfg, plan)
            for f in ("fft_max", "fft_min", "fft_avg", "fft_cur", "heatmap"):
                check(f"{name} {f}", getattr(state, f), getattr(want, f))
    for i, (argv, t, b) in enumerate(args.get("cli", [])):
        mesh = mesh_t if (t, b) == (s, 1) else mesh_b
        cfg = cli.parse_args(argv)[0]
        rc = sharded(f"cli {i}", cfg, lambda: cli.main(argv, mesh=mesh),
                     routed=False)
        if rc != 0:
            raise RuntimeError(f"cli run {i} exited {rc}")
    if args.get("rates"):
        from kspecanal_tpu_torch.scripts.scaling_bench import (stream_cfg,
                                                               stream_rate)
        r = args["rates"]
        res["rates"] = [stream_rate(stream_cfg(r["fft"]), mesh_t, t, iters=3)
                        for t in r["blocks"]]
    if on_card:
        torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t_start
    return res


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ranks", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--share-card", action="store_true")
    a = ap.parse_args(argv)
    if a.device == "cuda":
        from kspecanal_tpu_torch.ops import _build
        from kspecanal_tpu_torch.utils.profiling import require_cuda
        require_cuda("dryrun_multichip")
        _build.load()          # one build, before the ranks load it
    backend = "nccl" if a.device == "cuda" and not a.share_card else "gloo"
    res = run_world(TARGET, a.ranks, SMALL, backend=backend,
                    device_type=a.device, share_card=a.share_card)
    worst = max(res[0]["shares"].values())
    print(f"{a.ranks} ranks ({backend}, {a.device}): worst share of the "
          f"bound {worst:.3f}")
    print("dryrun ok")
    return res[0]


if __name__ == "__main__":
    main()
