"""Bytes of each collective call site of the port's sharded paths, per
call, from the configs and plans alone (host code, no device) — the port
of ``scripts/collective_bytes.py``.

    python -m kspecanal_tpu_torch.scripts.collective_bytes [n_shards]

One row per call site of ``parallel/{timeshard,stream,fftshard,
bandshard}.py`` and the sessions, for the BASELINE configurations (the
deep config 5 is the time-sharded zero-span cell; fmScan and
quickFullScan the band-sharded presets).  "Per rank" is what one rank
sends or receives in that call (the payload, not the wire protocol's
overhead): a scatter delivers each rank its slice, a ring shift moves one
halo each way, an all_reduce or broadcast carries the whole tensor, an
all_gather delivers every rank the whole gathered tensor.
"""
from __future__ import annotations

import sys
from typing import List, Tuple

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.models.scan import make_scan_plan
from kspecanal_tpu_torch.ops.cuda_curscan import _factorize
from kspecanal_tpu_torch.parallel.mesh import _HEADER_TENSORS

F32, U8, I64 = 4, 1, 8
HEADER = 4 * _HEADER_TENSORS * I64   # the row scatters' shape broadcast
STREAM_T = 4096                      # blocks of the sharded stream's cell

# (name, config, the sharded paths it takes)
CONFIGS = (
    ("2 waterfall fft2048", SpecConfig(
        prg_mode="ZEROSPAN", fft_size=2048, sampling_rate=2.4e6,
        window="WIN.KAISER", cur_scan_non_overlap=0.5).finalize(),
     ("stream", "time", "fft")),
    ("5 deep fft16384 ovl90", SpecConfig(
        prg_mode="ZEROSPAN", fft_size=16384, sampling_rate=2.4e6,
        window="WIN.KAISER", cur_scan_non_overlap=0.1).finalize(),
     ("time", "fft")),
    ("3 fmScan fft16384", SpecConfig(prg_mode="FMSCAN").finalize(),
     ("band",)),
    ("4 quickFullScan fft64", SpecConfig(
        prg_mode="QUICKFULLSCAN").finalize(), ("band",)),
)


def rows(s: int) -> List[Tuple[str, str, str, int]]:
    """(config, call site, collective, bytes per rank per call)."""
    out = []
    for name, cfg, paths in CONFIGS:
        full, n = cfg.full_size, cfg.fft_size

        def add(site, coll, nbytes):
            out.append((name, site, coll, int(nbytes)))

        if "time" in paths:
            add("timeshard header", "broadcast", HEADER)
            add("timeshard planes", "scatter x2", 2 * full // s * F32)
            add("timeshard halo", "ring shift (batch_isend_irecv)",
                2 * n * F32 if s > 1 else 0)
            add("timeshard reduce", "all_reduce", n * F32)
            add("session stop flag", "broadcast", I64)
        if "fft" in paths and _factorize(n)[1] % s == 0:
            n1, n2 = _factorize(n)
            add("fftshard header", "broadcast", HEADER)
            add("fftshard planes", "broadcast x2", 2 * full * F32)
            add("fftshard partial D", "all_reduce",
                2 * cfg.num_windows * n1 * n2 * F32)
        if "stream" in paths:
            add("stream header", "broadcast", HEADER)
            add(f"stream planes T={STREAM_T} f32", "scatter x2",
                2 * STREAM_T // s * full * F32)
            add(f"stream planes T={STREAM_T} u8", "scatter x2",
                2 * STREAM_T // s * full * U8)
            add("stream max / min / avg", "all_reduce x3", 3 * n * F32)
            add("stream cur", "broadcast", n * F32)
        if "band" in paths:
            b = make_scan_plan(cfg).num_bands
            padded = -(-b // s) * s
            add("bandshard header", "broadcast", HEADER)
            add(f"bandshard sweep ({b} bands, {padded} padded)",
                "scatter x3", padded // s * (2 * full * F32 + U8))
            add("bandshard spectra", "all_gather", padded * n * F32)
            add("session stop flag", "broadcast", I64)
    return out


def fmt(b: int) -> str:
    if b >= 1 << 20:
        return f"{b / (1 << 20):.2f} MiB"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.2f} KiB"
    return f"{b} B"


def main(argv=None) -> List[Tuple[str, str, str, int]]:
    argv = sys.argv[1:] if argv is None else argv
    s = int(argv[0]) if argv else 2
    table = rows(s)
    print(f"| config | call site | collective | bytes per rank per call "
          f"({s} ranks) |")
    print("|---|---|---|---|")
    for name, site, coll, nbytes in table:
        print(f"| {name} | {site} | {coll} | {fmt(nbytes)} |")
    return table


if __name__ == "__main__":
    main()
