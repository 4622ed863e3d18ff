"""Stage table of the power-of-two FFT kernel (``csrc/curscan_fft.cu``) on
the card: the kernel cut off after each stage of
``cuda_curscan.FFT_STAGES`` on the same planes
(``cuda_curscan.curscan_fft_stage``, its forensic builds
``-DKSPEC_FFT_STOP=1..4``, counted in ``fft_stage_launches``):

    input    the block input: loads, u8 decode, window (and the cluster's
             radix-c step), re + im folded per point
    pass1    + the first pass (radix 2, 4, 8 or 16)
    radix16  + the radix-16 passes
    full     + |.| and the fold: the production kernel, built alone

Per cell it prints each stage's time (CUDA events, median of 10) and its
delta from the stage before, with the 64-bit conversions a window the
production kernel has made by the end of that stage (:func:`conversions`,
counted from the code); then the production call, the kernel's registers,
local memory (spills and stack), shared memory a block and resident blocks
an SM (``kspec_curscan_fft_attrs``), and one ``torch.fft.fft`` over the
same windowed frames, ``(T*W, N)`` complex64: the library FFT alone, no
window, magnitude or fold, not the same function (a yardstick the port
never calls).  Each cut-off is first checked against its plain version
(``curscan_fft_stage_plain``) on a few IQ blocks.  ``--parent`` runs the
parent form's builds (``-DKSPEC_FFT_PARENT=1``) instead, and its 'full'
stands for the production call.  The default cells:
the zero-span main cell (fft 2048 kaiser 50%, T=4096, f32 and u8),
fmScan's (fft 16384 ones 90%, T=288), fft 65536 (T=64, a cluster) and fft
256 (T=4096).

``--versus-parent`` times instead the production kernel beside the parent
form (its forensic build ``-DKSPEC_FFT_PARENT=1``, 'full') on the same
planes, in the order parent, production, production, parent (each CUDA
events, median of 10; the two medians of each averaged), with each one's
share of the cell's bound: the default cells, the lane kernel's cell (fft
16384 kaiser 50%, T=288) and every power of two 256-131072 at T=64;
``--kernel-only`` times the production kernel built alone (the 'full'
build) in place of the library, so a tree (an older one unpacked with
``git archive``, a variant of this one) needs only this file's builds.

``--staging`` times the production kernel built alone with no frame
staged by ``cp.async`` (``-DKSPEC_FFT_STAGE_BYTES=0``) and with every
frame of one block a window staged (``=131072``) on the same planes, in
the order none, all, all, none for ``ROUNDS`` rounds (each CUDA events,
median of 10), at every single-block power of two 256-8192, f32 and u8,
and at fmScan's 90% overlap at fft 2048 (never staged: its starts are not
16-byte aligned), printing every run: the rule that picks the staged
frames (``KSPEC_FFT_STAGE_BYTES`` in ``csrc/curscan_fft.cu``) reads this
table.

    python -m kspecanal_tpu_torch.scripts.fft_stages [--parent |
        --versus-parent [--kernel-only] | --staging] [CELL ...]

A CELL is a default cell's name or ``FFT:T:NONO:WINDOW:f32|u8`` (e.g.
``2048:4096:0.5:WIN.KAISER:u8``).
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.config import (CUMU_AVG, WINDOW_KAISER, WINDOW_ONES,
                                        SpecConfig, window_lut)
from kspecanal_tpu_torch.ops import cuda_curscan as cc
from kspecanal_tpu_torch.ops import spectrum
from kspecanal_tpu_torch.utils.profiling import card_line, cuda_ms, \
    require_cuda

CELLS = {
    "main": (2048, 4096, 0.5, WINDOW_KAISER, False),
    "main-u8": (2048, 4096, 0.5, WINDOW_KAISER, True),
    "fmScan": (16384, 288, 0.1, WINDOW_ONES, False),
    "fft65536": (65536, 64, 0.5, WINDOW_KAISER, False),
    "fft256": (256, 4096, 0.5, WINDOW_KAISER, False),
}
VERSUS = {**CELLS, "lane": (16384, 288, 0.5, WINDOW_KAISER, False),
          **{f"sweep{1 << e}": (1 << e, 64, 0.5, WINDOW_KAISER, False)
             for e in range(8, 18)}}
# The bound's rates (chip_smoke.py's): float32 flops and HBM bytes a second.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# IQ blocks a cut-off is checked on against its plain version.
CHECK_BLOCKS = 4
# --staging: its cells (T = min(4096, 2^23 / fft)) and rounds.
STAGING = {f"{n}{'-u8' * u8}": (n, min(4096, (1 << 23) // n), 0.5,
                                WINDOW_KAISER, u8)
           for n in (256, 512, 1024, 2048, 4096, 8192) for u8 in (False, True)}
STAGING["2048-90"] = (2048, 4096, 0.1, WINDOW_ONES, False)
ROUNDS = 4


def stage_cfg(fft: int, nono: float, window: str,
              mode: str = CUMU_AVG) -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=nono,
                      cur_scan_cumu_mode=mode,
                      x_res=min(512, fft)).finalize()


def parse_cell(cell: str) -> Tuple[int, int, float, str, bool]:
    if cell in VERSUS:
        return VERSUS[cell]
    if cell in STAGING:
        return STAGING[cell]
    fft, t, nono, window, kind = cell.split(":")
    return int(fft), int(t), float(nono), window, kind == "u8"


def conversions(n: int, parent: bool = False) -> Dict[str, int]:
    """The 64-bit conversions (float to double and back, integer to double)
    of one n-point window, counted from the code, cumulative by the end of
    each stage of the production kernel (``parent``: the parent form).
    Parent form, per point: the block input converts
    nothing in one block, and in a cluster of c widens the c chunk values
    and their c - 1 twiddles, widens its own twiddle (blocks q > 0) and
    narrows; pass 1 of radix r <= 4 widens and narrows each point (4), of
    radix 8 or 16 also narrows and widens between its stages (8; pass 1's
    twiddles are roots[0], loaded and widened once a thread, not counted);
    a radix-16 pass widens each point and its twiddle (15 of 16), narrows
    and widens between its stages and narrows at its end (10 - 1/8); the
    magnitude runs in float32.  Float64 form: two a point at the load
    (float32 or u8 to double) in each of the c blocks that read it (the c
    chunks of a window in every block above 8192 points), none in the
    passes or the blocks' radix-c step, one at the magnitude (|X|^2
    narrowed).  The parent form's u8 decode (u8 to float32, 2 a point) is
    not a 64-bit conversion and not counted."""
    c, f64 = cc.fft_plan(n, parent)[0], not parent
    m = n // c
    if f64:
        return {"input": 2 * n * c, "pass1": 2 * n * c,
                "radix16": 2 * n * c, "full": 2 * n * c + n}
    r0 = cc.pass1_radix(m)
    q_passes = (m.bit_length() - 2) // 4
    cluster = 0 if c == 1 else sum(m * (4 * c + (2 if q else 0))
                                   for q in range(c))
    pass1 = n * (4 if r0 <= 4 else 8)
    radix16 = q_passes * c * (m * 10 - 2 * (m // 16))
    return {"input": cluster, "pass1": cluster + pass1,
            "radix16": cluster + pass1 + radix16,
            "full": cluster + pass1 + radix16}


def bound_ms(cfg: SpecConfig, t: int, u8: bool) -> float:
    """The least time (ms) of one call: the larger of the FFT's flops (5 N
    log2 N + 4 N a window) at 67 TFLOP/s and the planes read once plus the
    output written once at 3.35 TB/s (``chip_smoke.bound``)."""
    n = cfg.fft_size
    flops = t * cfg.num_windows * (5 * n * (n.bit_length() - 1) + 4 * n)
    nbytes = 2 * t * cfg.full_size * (1 if u8 else 4) + 4 * t * n
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3


def planes(cfg: SpecConfig, t: int, u8: bool, gen: torch.Generator):
    shape = (t, cfg.full_size)
    if u8:
        return tuple(torch.randint(0, 256, shape, generator=gen,
                                   device="cuda", dtype=torch.uint8)
                     for _ in range(2))
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 for _ in range(2))


def versus_parent(cells: List[str], gen: torch.Generator,
                  kernel_only: bool = False) -> Dict[str, Dict[str, float]]:
    """The production kernel (``kernel_only``: built alone) and the parent
    form on the same planes, timed parent, production, production, parent;
    returns ``{cell: {'kernel': ms, 'parent': ms, 'bound': ms}}``."""
    out = {}
    for cell in cells:
        fft, t, nono, window, u8 = parse_cell(cell)
        cfg = stage_cfg(fft, nono, window)
        re, im = planes(cfg, t, u8, gen)

        def prod():
            if kernel_only:
                return cc.curscan_fft_stage(re, im, cfg, "full")
            return cc.curscan_fused_sublane(re, im, cfg)

        def parent():
            return cc.curscan_fft_stage(re, im, cfg, "full", True)
        p1, k1, k2, p2 = (cuda_ms(f) for f in (parent, prod, prod, parent))
        row = {"kernel": (k1 + k2) / 2, "parent": (p1 + p2) / 2,
               "bound": bound_ms(cfg, t, u8)}
        print(f"fft {fft} {window} {1 - nono:.0%} T={t} "
              f"{'u8' if u8 else 'f32'}: production {k1:.3f} / {k2:.3f} ms, "
              f"parent form {p1:.3f} / {p2:.3f} ms; bound {row['bound']:.4f} "
              f"ms, shares {row['bound'] / row['kernel']:.3f} / "
              f"{row['bound'] / row['parent']:.3f}; parent / production "
              f"{row['parent'] / row['kernel']:.2f}x", flush=True)
        out[cell] = row
        del re, im
    return out


def staging(cells: List[str], gen: torch.Generator) -> Dict[str, Dict]:
    """The production kernel built with no frame staged and with every
    frame of one block a window staged, on the same planes, none, all,
    all, none for ``ROUNDS`` rounds; returns ``{cell: {'none': [ms], 'all':
    [ms]}}``."""
    out = {}
    for cell in cells:
        fft, t, nono, window, u8 = parse_cell(cell)
        cfg = stage_cfg(fft, nono, window)
        re, im = planes(cfg, t, u8, gen)
        runs: Dict[str, List[float]] = {"none": [], "all": []}
        for _ in range(ROUNDS):
            for key in ("none", "all", "all", "none"):
                runs[key].append(cuda_ms(lambda k=key: cc.curscan_fft_stage(
                    re, im, cfg, "full",
                    stage_bytes=0 if k == "none" else 1 << 17)))
        mean = {k: sum(v) / len(v) for k, v in runs.items()}
        print(f"fft {fft} {window} {1 - nono:.0%} T={t} "
              f"{'u8' if u8 else 'f32'}: " + "; ".join(
                  f"{'unstaged' if k == 'none' else 'staged'} "
                  + " ".join(f"{x:.3f}" for x in v)
                  + f" (mean {mean[k]:.3f}, {min(v):.3f}-{max(v):.3f})"
                  for k, v in runs.items())
              + f"; unstaged / staged {mean['none'] / mean['all']:.3f}; bound "
              f"{bound_ms(cfg, t, u8):.4f} ms", flush=True)
        out[cell] = runs
        del re, im
    return out


def check_stages(re, im, cfg, parent: bool) -> Dict[str, float]:
    """Each cut-off on the first ``CHECK_BLOCKS`` IQ blocks against its
    plain version: ``share_<stage>``, the largest error as a share of 1e-6
    of the peak below 'full', of the per-bin bound (5e-5 of the bin plus
    1e-6 of the peak) at 'full', and ``err_<stage>``, the max abs error;
    raises where a share passes 1."""
    re, im = re[:CHECK_BLOCKS], im[:CHECK_BLOCKS]
    out = {}
    for stage in cc.FFT_STAGES:
        got = cc.curscan_fft_stage(re, im, cfg, stage, parent).double()
        want = cc.curscan_fft_stage_plain(re, im, cfg, stage, parent)
        err = (got - want).abs()
        peak = want.abs().max()
        bound = (1e-6 * peak if stage != "full"
                 else 5e-5 * want.abs() + 1e-6 * peak)
        share = out[f"share_{stage}"] = (err / bound).max().item()
        out[f"err_{stage}"] = err.max().item()
        if not share <= 1.0:
            raise RuntimeError(f"fft {cfg.fft_size} cut-off {stage!r}: "
                               f"{share:.3f} of its bound")
    return out


def library_fft_ms(re, im, cfg) -> float:
    """One ``torch.fft.fft`` over the windowed frames ``(T*W, N)``
    complex64 (framed and windowed outside the timing)."""
    n = cfg.fft_size
    win = torch.as_tensor(window_lut(cfg.window, n), dtype=torch.float32,
                          device=re.device)
    fr, fi = (spectrum.frame_signal(spectrum.decode_u8(p), cfg.window_starts,
                                    n) for p in (re, im))
    frames = torch.complex(fr * win, fi * win).reshape(-1, n)
    del fr, fi
    return cuda_ms(lambda: torch.fft.fft(frames))


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    """Print the stage table of each cell; returns ``{cell: {stage: ms,
    'kernel': ms, 'library_fft': ms, 'share_<stage>' and 'err_<stage>':
    the cut-off's share of its bound and max abs error, ...}}``
    (``--versus-parent``: those of :func:`versus_parent`; ``--staging``:
    those of :func:`staging`)."""
    p = argparse.ArgumentParser(prog="fft_stages", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--parent", action="store_true",
                      help="the parent form's builds (-DKSPEC_FFT_PARENT=1)")
    mode.add_argument("--versus-parent", action="store_true",
                      help="time production beside the parent form")
    mode.add_argument("--staging", action="store_true",
                      help="time no frame staged against every frame "
                           "staged")
    p.add_argument("--kernel-only", action="store_true",
                   help="with --versus-parent: the production kernel built "
                        "alone, no library build")
    p.add_argument("cells", nargs="*")
    args = p.parse_args(argv)
    require_cuda("fft_stages")
    from kspecanal_tpu_torch.ops import _build
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.staging:
        _build.build([cc.fft_staging_variant(b) for b in (0, 1 << 17)],
                     library=False)
        print(f"device: {card_line()}; power-of-two FFT kernel, no frame "
              f"staged and every frame staged, AVG", flush=True)
        return staging(args.cells or list(STAGING), gen)
    if args.versus_parent:
        _build.build(cc.fft_stage_variants(True)[-1:]
                     + cc.fft_stage_variants()[-1:] * args.kernel_only,
                     library=not args.kernel_only)
        print(f"device: {card_line()}; power-of-two FFT kernel, production "
              f"beside the parent form, AVG", flush=True)
        return versus_parent(args.cells or list(VERSUS), gen,
                             args.kernel_only)
    _build.build(cc.fft_stage_variants(args.parent))
    form = "parent form" if args.parent else "production form"
    print(f"device: {card_line()}; power-of-two FFT kernel stage table, "
          f"{form}, AVG", flush=True)
    results: Dict[str, Dict[str, float]] = {}
    for cell in args.cells or list(CELLS):
        fft, t, nono, window, u8 = parse_cell(cell)
        cfg = stage_cfg(fft, nono, window)
        kind = "u8" if u8 else "f32"
        c, f64 = cc.fft_plan(fft, args.parent)[0], not args.parent
        re, im = planes(cfg, t, u8, gen)
        name = (f"fft {fft} {window} {1 - nono:.0%} T={t} {kind} (c={c}, "
                f"{'float64' if f64 else 'parent'} form)")
        checks = check_stages(re, im, cfg, args.parent)
        print(f"{name}: cut-offs vs plain on {CHECK_BLOCKS} blocks, share "
              f"of the bound (max abs error): " + ", ".join(
                  f"{s} {checks['share_' + s]:.3f} ({checks['err_' + s]:.3e})"
                  for s in cc.FFT_STAGES), flush=True)
        conv = conversions(fft, args.parent)
        row: Dict[str, float] = {}
        prev = 0.0
        for stage in cc.FFT_STAGES:
            row[stage] = cuda_ms(lambda s=stage: cc.curscan_fft_stage(
                re, im, cfg, s, args.parent))
            print(f"{name} {stage:7s} {row[stage]:9.3f} ms  delta "
                  f"{row[stage] - prev:+9.3f} ms  64-bit conversions a "
                  f"window {conv[stage]}", flush=True)
            prev = row[stage]
        row["kernel"] = row["full"] if args.parent else cuda_ms(
            lambda: cc.curscan_fused_sublane(re, im, cfg))
        attrs = cc.fft_attrs(cc.fft_stage_library("full", args.parent), fft,
                             u8)
        prod = cc.fft_attrs(_build.load(), fft, u8)
        row["library_fft"] = library_fft_ms(re, im, cfg)
        print(f"{name}: production {row['kernel']:9.3f} ms; the {form}: "
              f"{attrs['registers']} registers, {attrs['local_bytes']} B "
              f"local, {attrs['smem_bytes']} B shared a block, "
              f"{attrs['blocks_per_sm']} blocks an SM (production: "
              f"{prod['registers']} / {prod['local_bytes']} / "
              f"{prod['smem_bytes']} / {prod['blocks_per_sm']}); library "
              f"FFT alone (torch.fft.fft over the ({t * cfg.num_windows}, "
              f"{fft}) windowed frames, complex64: no window, magnitude or "
              f"fold, not the same function) {row['library_fft']:9.3f} ms",
              flush=True)
        results[cell] = {**row, **{f"{k}_{s}": v for s, d in
                                   (("form", attrs), ("prod", prod))
                                   for k, v in d.items()},
                         **checks}
        del re, im
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
