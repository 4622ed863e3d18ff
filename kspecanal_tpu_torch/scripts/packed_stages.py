"""Stage table of the packed FFT kernel (K2 at HIGHEST,
``csrc/curscan_packed.cu``) on the card: the kernel cut off after each
stage of ``cuda_packed.STAGES`` on the same planes
(``cuda_packed.curscan_packed_stage``, its forensic builds
``-DKSPEC_PACKED_STOP=1..4``, counted in ``stage_launches``):

    input    the thread block's set-up, the staged spans, decode and the
             window; |re + im| folded per value
    regs     + the P-point FFT in registers and the lane twiddle
    lanes    + the L-point DFT across the lanes of a window
    full     + |X|, the fold and the groups' combine: the production
             kernel, built alone

Per cell it prints each stage's time (CUDA events, median of 10) with one
launch between the events and on the card alone (``GRAPH`` launches
captured in one CUDA graph, its replay timed the same way, over
``GRAPH``), and its delta from the stage before; the float64 operations,
64-bit conversions and 32-bit shuffles a window the form has made by the
end of that stage (:func:`counts`, counted from the code); then the
production call, the form's registers, local memory (spills and stack),
shared memory a block and resident blocks an SM
(``kspec_curscan_packed_attrs``), and one ``torch.fft.fft`` over the same
frames, ``(T*W, N)`` complex64: the library FFT alone, no window,
magnitude or fold, not the same function (a yardstick the port never
calls).  Each cut-off is first checked against its plain version
(``curscan_packed_stage_plain``) on a few IQ blocks, within the per-bin
bound.  ``--parent`` runs the parent form's builds
(``-DKSPEC_PACKED_PARENT=1``) instead, its 'full' standing for the
production call.  The cells: quickFullScan's geometry (fft 64, ones, 90%
overlap, 512-sample blocks, 71 windows) at the catch-up batch T=19616,
f32 and u8, and at the serial sweep's T=1226; fft 128 kaiser 50% and fft
32 RAW at curScanNonOverlap 0.25, T=4096; the C2 cell fft 64 kaiser 90%
with fft2FullMult 96 (951 windows), MIN, T=1024.

``--versus-parent`` times instead the production kernel beside the parent
form (its build ``-DKSPEC_PACKED_PARENT=1``, 'full') on the same planes,
in the order parent, production, production, parent for ``ROUNDS`` rounds,
one launch and on the card alone, printing each one's mean, least and most
and its share of the cell's bound: the cells above, u8 at T=1226 and fft
128 x 399 (T=64, the chunked walk); ``--kernel-only`` times the production
kernel built alone (the 'full' build) in place of the library, so a tree
(an older one unpacked with ``git archive``) needs only this file's
builds.

    python -m kspecanal_tpu_torch.scripts.packed_stages [--parent |
        --versus-parent [--kernel-only]] [CELL ...]

A CELL is a cell's name or ``FFT:T:NONO:WINDOW:MODE:MULT:f32|u8`` (e.g.
``64:19616:0.1:WIN.ONES:AVG:8:u8``).
"""
from __future__ import annotations

import argparse
import statistics
import sys
from typing import Dict, List, Optional, Tuple

import torch

from kspecanal_tpu_torch.config import (WINDOW_KAISER, WINDOW_ONES,
                                        SpecConfig)
from kspecanal_tpu_torch.ops import cuda_packed as cp
from kspecanal_tpu_torch.ops import spectrum

Cell = Tuple[int, int, float, str, str, int, bool]
CELLS: Dict[str, Cell] = {
    "qfs": (64, 19616, 0.1, WINDOW_ONES, "AVG", 8, False),
    "qfs-u8": (64, 19616, 0.1, WINDOW_ONES, "AVG", 8, True),
    "qfs-1226": (64, 1226, 0.1, WINDOW_ONES, "AVG", 8, False),
    "fft128": (128, 4096, 0.5, WINDOW_KAISER, "AVG", 8, False),
    "fft32": (32, 4096, 0.25, WINDOW_KAISER, "RAW", 8, False),
    "c2": (64, 1024, 0.1, WINDOW_KAISER, "MIN", 96, False),
}
VERSUS: Dict[str, Cell] = {
    **CELLS, "qfs-1226-u8": (64, 1226, 0.1, WINDOW_ONES, "AVG", 8, True),
    "fft128x399": (128, 64, 0.5, WINDOW_KAISER, "AVG", 399, False)}
# The bound's rates (chip_smoke.py's): float32 flops and HBM bytes a second.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
CHECK_BLOCKS = 8        # IQ blocks a cut-off is checked on
GRAPH = 20              # launches in the CUDA graph of "on the card alone"
ROUNDS = 3              # --versus-parent: rounds of parent, new, new, parent


def cell_cfg(fft: int, nono: float, window: str, mode: str,
             mult: int) -> SpecConfig:
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=nono,
                      cur_scan_cumu_mode=mode, x_res=fft,
                      fft2full_mult4less=mult).finalize()


def parse_cell(cell: str) -> Cell:
    if cell in VERSUS:
        return VERSUS[cell]
    fft, t, nono, window, mode, mult, kind = cell.split(":")
    return int(fft), int(t), float(nono), window, mode, int(mult), \
        kind == "u8"


def _pass_ops(p: int) -> int:
    """float64 operations of a radix-2 P-point FFT in registers (the parent
    form's ``fft_regs``, the production form's ``dif`` and ``dit_conj``):
    4 a butterfly (a complex add and subtract) and 4 a twiddle other than
    +-1 and +-i (two multiplies and two fused multiply-adds, or two adds and
    two multiplies at +-sqrt(1/2) (1 +- i))."""
    ops, half = 0, p // 2
    while half:
        for i in range(half):
            m = i * (p // (2 * half))
            ops += (p // (2 * half)) * (4 + (0 if m == 0 or 4 * m == p
                                              else 4))
        half //= 2
    return ops


def counts(n: int, u8: bool = False,
           parent: bool = False) -> Dict[str, Dict[str, int]]:
    """The float64 operations ('f64'), 64-bit conversions ('conv') and
    32-bit shuffles ('shfl') of one n-point window, counted from the code,
    cumulative by the end of each stage (``parent``: the parent form).
    N = P L (``cuda_packed.SPLIT``), C = P / L where L > 1.  Both forms:
    |X|^2 is 2 operations a bin and its rounding to float32 one conversion.
    Parent form: the input converts each of the 2N plane values to double
    and multiplies it by the window (2N operations; u8 also subtracts 127,
    2N more); the P-point FFT in registers is :func:`_pass_ops` a lane and
    the lane twiddle P - 1 complex multiplies (4 each) where L > 1; the
    L-point DFT across lanes log2(L) radix-2 passes, each P/2 butterflies a
    lane of a complex add and subtract (4), a twiddle multiply (4; the last
    pass a sign, 2) and the sign folded into the pass twiddle (2 a pass but
    the last), exchanging P/2 complex values (2P shuffles) a lane a pass.
    Production form: float32 values convert (2N), u8 values decode with
    one add each and no conversion (2N operations); the window is a real
    multiply (2N), at C = 1 a complex one (4N, the rotation with it); at
    C = 2 a first radix-2 pass (L butterflies and the twiddles W_P^j) and
    the rotation (2(L - 1) complex multiplies) a lane; C L-point DFTs in
    registers and P lane twiddles (4 each) a lane; the exchange C(L - 1)
    complex values (4 shuffles each) a lane and C L-point DFTs."""
    p, lanes = cp.SPLIT[n]
    c = p // lanes if lanes > 1 else 1
    if parent:
        f64, conv = 2 * n + (2 * n if u8 else 0), 2 * n
    else:
        f64 = (4 if c == 1 and lanes > 1 else 2) * n + (2 * n if u8 else 0)
        conv = 0 if u8 else 2 * n
    shfl = 0
    out = {"input": {"f64": f64, "conv": conv, "shfl": shfl}}
    if parent or lanes == 1:
        f64 += lanes * (_pass_ops(p) + (4 * (p - 1) if lanes > 1 else 0))
    else:
        first = (4 * lanes + 4 * sum(1 for j in range(lanes)
                                     if (j * 16 // p) % 4)
                 + 8 * (lanes - 1)) if c == 2 else 0
        f64 += lanes * (first + c * _pass_ops(lanes) + 4 * p)
    out["regs"] = {"f64": f64, "conv": conv, "shfl": shfl}
    if parent:
        for s in range(lanes.bit_length() - 1):
            h = lanes >> (s + 1)
            f64 += lanes * ((p // 2) * (4 + (4 if h > 1 else 2))
                            + (2 if h > 1 else 0))
            shfl += lanes * 2 * p
    elif lanes > 1:
        f64 += lanes * c * _pass_ops(lanes)
        shfl += lanes * 4 * c * (lanes - 1)
    out["lanes"] = {"f64": f64, "conv": conv, "shfl": shfl}
    out["full"] = {"f64": f64 + 2 * n, "conv": conv + n, "shfl": shfl}
    return out


def bound_ms(cfg: SpecConfig, t: int, u8: bool) -> float:
    """The least time (ms) of one call (``chip_smoke.bound``): the larger
    of the FFT's flops (5 N log2 N + 4 N a window) at 67 TFLOP/s and the
    planes read once plus the output written once at 3.35 TB/s."""
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


def graph_ms(fn, warm: int = 3, reps: int = GRAPH) -> float:
    """Milliseconds a call of ``fn()`` takes on the card alone, without the
    host's time between calls: ``reps`` calls captured in one CUDA graph
    after ``warm`` calls, the replay timed as ``cuda_ms`` times a call,
    over ``reps``."""
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay) / reps


def bound_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-bin error as a share of the bound (5e-5 of the bin
    plus 1e-6 of the peak)."""
    err = (got.double() - want.double()).abs()
    ref = want.double().abs()
    return (err / (5e-5 * ref + 1e-6 * ref.max())).max().item()


def check_stages(re, im, cfg, parent: bool) -> Dict[str, float]:
    """Each cut-off on the first ``CHECK_BLOCKS`` IQ blocks against its
    plain version: ``share_<stage>``, its largest error as a share of the
    per-bin bound, and ``err_<stage>``, its max abs error; raises where a
    share passes 1."""
    re, im = re[:CHECK_BLOCKS], im[:CHECK_BLOCKS]
    out = {}
    for stage in cp.STAGES:
        got = cp.curscan_packed_stage(re, im, cfg, stage, parent)
        want = cp.curscan_packed_stage_plain(re, im, cfg, stage, parent)
        out[f"err_{stage}"] = (got.double() - want).abs().max().item()
        share = out[f"share_{stage}"] = bound_share(got, want)
        if not share <= 1.0:
            raise RuntimeError(f"fft {cfg.fft_size} cut-off {stage!r}: "
                               f"{share:.3f} of its bound")
    return out


def library_fft_ms(re, im, cfg) -> float:
    """One ``torch.fft.fft`` over the frames ``(T*W, N)`` complex64
    (framed outside the timing)."""
    n = cfg.fft_size
    fr, fi = (spectrum.frame_signal(spectrum.decode_u8(p), cfg.window_starts,
                                    n) for p in (re, im))
    frames = torch.complex(fr, fi).reshape(-1, n)
    del fr, fi
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    return cuda_ms(lambda: torch.fft.fft(frames))


def cell_name(cell: Cell) -> str:
    fft, t, nono, window, mode, mult, u8 = cell
    return (f"fft {fft} {window} {1 - nono:.0%} {mode}"
            f"{f' mult {mult}' if mult != 8 else ''} T={t} "
            f"{'u8' if u8 else 'f32'}")


def _summary(xs: List[float]) -> str:
    return (f"{statistics.mean(xs):.4f} ({min(xs):.4f}-{max(xs):.4f})")


def versus_parent(cells: List[str], gen: torch.Generator,
                  kernel_only: bool = False) -> Dict[str, Dict]:
    """The production kernel (``kernel_only``: built alone) and the parent
    form on the same planes, timed parent, production, production, parent
    for ``ROUNDS`` rounds, one launch and on the card alone; returns
    ``{cell: {'kernel': [ms], 'parent': [ms], 'kernel_card': [ms],
    'parent_card': [ms], 'bound': ms}}``."""
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    out = {}
    for cell in cells:
        fft, t, nono, window, mode, mult, u8 = parse_cell(cell)
        cfg = cell_cfg(fft, nono, window, mode, mult)
        re, im = planes(cfg, t, u8, gen)

        def prod():
            if kernel_only:
                return cp.curscan_packed_stage(re, im, cfg, "full")
            return cp.curscan_fused_packed(re, im, cfg)

        def parent():
            return cp.curscan_packed_stage(re, im, cfg, "full", True)
        row = {k: [] for k in ("kernel", "parent", "kernel_card",
                               "parent_card")}
        for _ in range(ROUNDS):
            for name, fn in (("parent", parent), ("kernel", prod),
                             ("kernel", prod), ("parent", parent)):
                row[name].append(cuda_ms(fn))
                row[f"{name}_card"].append(graph_ms(fn))
        row["bound"] = bound = bound_ms(cfg, t, u8)
        k, p = (statistics.mean(row[x]) for x in ("kernel", "parent"))
        kc, pc = (statistics.mean(row[x]) for x in ("kernel_card",
                                                     "parent_card"))
        print(f"{cell_name(parse_cell(cell))}: one launch production "
              f"{_summary(row['kernel'])} ms, parent form "
              f"{_summary(row['parent'])} ms (parent / production "
              f"{p / k:.2f}x); on the card alone production "
              f"{_summary(row['kernel_card'])}, parent "
              f"{_summary(row['parent_card'])} ({pc / kc:.2f}x); bound "
              f"{bound:.4f} ms, shares {bound / k:.3f} / {bound / p:.3f} "
              f"(card alone {bound / kc:.3f} / {bound / pc:.3f})",
              flush=True)
        out[cell] = row
        del re, im
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    """Print the stage table of each cell; returns ``{cell: {stage: ms,
    'card': {stage: ms}, 'kernel': ms, 'library_fft': ms, 'share_<stage>':
    the cut-off's share of its bound, 'form' and 'prod': attrs}}``
    (``--versus-parent``: those of :func:`versus_parent`)."""
    p = argparse.ArgumentParser(prog="packed_stages", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--parent", action="store_true",
                      help="the parent form's builds "
                           "(-DKSPEC_PACKED_PARENT=1)")
    mode.add_argument("--versus-parent", action="store_true",
                      help="time production beside the parent form")
    p.add_argument("--kernel-only", action="store_true",
                   help="with --versus-parent: the production kernel built "
                        "alone, no library build")
    p.add_argument("cells", nargs="*")
    args = p.parse_args(argv)
    from kspecanal_tpu_torch.utils.profiling import (card_line, cuda_ms,
                                                     require_cuda)
    require_cuda("packed_stages")
    from kspecanal_tpu_torch.ops import _build
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.versus_parent:
        _build.build(cp.stage_variants(True)[-1:]
                     + cp.stage_variants()[-1:] * args.kernel_only,
                     library=not args.kernel_only)
        print(f"device: {card_line()}; packed FFT kernel (K2), production "
              f"beside the parent form, CUDA events, median of 10; on the "
              f"card alone: a CUDA graph of {GRAPH} calls", flush=True)
        return versus_parent(args.cells or list(VERSUS), gen,
                             args.kernel_only)
    _build.build(cp.stage_variants(args.parent), library=not args.parent)
    form = "parent form" if args.parent else "production form"
    print(f"device: {card_line()}; packed FFT kernel (K2) stage table, "
          f"{form}, CUDA events, median of 10; on the card alone: a CUDA "
          f"graph of {GRAPH} calls", flush=True)
    results: Dict[str, Dict] = {}
    for cell in args.cells or list(CELLS):
        spec_ = parse_cell(cell)
        fft, t, nono, window, mode_, mult, u8 = spec_
        cfg = cell_cfg(fft, nono, window, mode_, mult)
        name = f"{cell_name(spec_)} ({form})"
        re, im = planes(cfg, t, u8, gen)
        checks = check_stages(re, im, cfg, args.parent)
        print(f"{name}: cut-offs vs plain on {CHECK_BLOCKS} blocks, share "
              f"of the per-bin bound: " + ", ".join(
                  f"{s} {checks['share_' + s]:.4f}" for s in cp.STAGES),
              flush=True)
        ops = counts(fft, u8, args.parent)
        row: Dict = {"card": {}}
        prev = prev_card = 0.0
        for stage in cp.STAGES:
            def run(s=stage):
                return cp.curscan_packed_stage(re, im, cfg, s, args.parent)
            row[stage] = cuda_ms(run)
            row["card"][stage] = graph_ms(run)
            c = ops[stage]
            print(f"{name} {stage:5s} one launch {row[stage]:8.4f} ms "
                  f"(delta {row[stage] - prev:+8.4f}), card alone "
                  f"{row['card'][stage]:8.4f} ms (delta "
                  f"{row['card'][stage] - prev_card:+8.4f}); a window: "
                  f"{c['f64']} float64 ops, {c['conv']} conversions, "
                  f"{c['shfl']} shuffles", flush=True)
            prev, prev_card = row[stage], row["card"][stage]
        row["kernel"] = row["full"] if args.parent else cuda_ms(
            lambda: cp.curscan_fused_packed(re, im, cfg))
        form_attrs = cp.attrs(cp.stage_library("full", args.parent), cfg, t,
                              u8, args.parent)
        row["library_fft"] = library_fft_ms(re, im, cfg)
        bound = bound_ms(cfg, t, u8)
        print(f"{name}: production {row['kernel']:8.4f} ms, bound "
              f"{bound:.4f} ms ({bound / row['kernel']:.3f} of it); the "
              f"{form}: {form_attrs['registers']} registers, "
              f"{form_attrs['local_bytes']} B local, "
              f"{form_attrs['smem_bytes']} B shared a block, "
              f"{form_attrs['blocks_per_sm']} blocks an SM; library FFT "
              f"alone (torch.fft.fft over the ({t * cfg.num_windows}, "
              f"{fft}) frames, complex64: no window, magnitude or fold, not "
              f"the same function) {row['library_fft']:8.4f} ms", flush=True)
        results[cell] = {**row, "form": form_attrs, "bound": bound,
                         **checks}
        del re, im
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
