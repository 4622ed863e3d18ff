"""Smoke test of the PyTorch/CUDA port (``kspecanal_tpu_torch``) on one
NVIDIA card: builds the CUDA kernels from ``kspecanal_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the
zero-span waterfall path, the scan path, the performance-forensics path
(device sources, ``tpuProfile``, the stage ablation K4 at every class), the
offline capture analyzer and the renderer's toggles through their entry
points and checks the results.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. environment: torch, CUDA, nvcc, the card and its power limit;
  2. build of the kernels, of Kernel A's five K4 cut-offs, of Kernel C's
     four stage cut-offs, of Kernels A and C's ablate builds, of the
     HIGHEST forensic builds (``cuda_tc.highest_variants``: Kernel A whole,
     its cut-offs and ablate build, Kernel C's ablate build, all with
     ``-DKSPEC_TC_HIGHEST=1``) and of the power-of-two FFT kernel's four
     cut-offs and its parent form (``csrc/curscan_fft.cu`` alone with
     ``-DKSPEC_FFT_STOP=1..4``, and ``-DKSPEC_FFT_PARENT=1``) and of K2's
     four cut-offs and its parent form (``csrc/curscan_packed.cu`` alone
     with ``-DKSPEC_PACKED_STOP=1..4``, and ``-DKSPEC_PACKED_PARENT=1``; one
     nvcc per source and build, all in parallel), with ptxas'
     register/shared-memory report and the time the forensic builds'
     compiles took;
 2b. the display fold kernel (``csrc/display_fold.cu``) against its plain
     version at both benchmark cells' shapes (K=4096 x fft 2048, K=512 x
     fft 16384), and its times cold and warm beside its bound and the
     plain chain's;
  3. K1 against its plain version (``torch.fft``) run in float64 on the
     same planes: the FFT kernel at the zero-span path's config (fft 2048,
     kaiser, 50% overlap, 2.4 Msps) in all four cumulate modes, fft 2048 at
     90% overlap, fft 256 hanning, fft 16384, and the multi-block sizes fft
     32768, 65536 and 131072 (2, 4, 8 and 16 blocks of 8192) at 50% and
     90% overlap (AVG and MIN), each
     power of two with the parent form's share of the bound beside its own
     (the float64 form's may not pass 1.1 times the parent's); its
     mixed-radix form at fft 384, 1280, 3072, 16256 (one block), 20480,
     98304, 130944 (clusters of 2, 8 and 8) and 262144 (the scratch route),
     all four modes at 50% and 90%; the float32 plain chain's own error
     against the same float64 reference; the direct kernel at fft 1280
     (counted in ``direct_launches``); u8 input bit-identical to decoded
     float32 at fft 2048, 65536, 1280, 20480 and 262144, 50% and 90%;
 3b. K3's cells off the 128 grid (the lane kernel's sizes, run by the
     mixed-radix form) against the plain version in float64: fft 2500,
     3000, 10000, 2050 and 11110 (one block; 41 and 101 run the large-prime
     pass), 39800 (a cluster of 4), 33250 (2 * odd, the scratch route) and
     131100 (above 131072), all four modes at 50% and 90% (where the JAX
     dispatcher sends them to its lane kernel), with the share of the
     per-bin bound each reached (phase 3 holds fft 16256, the radix-127
     pass, at 90% MIN); u8 bit-identical to decoded float32 at fft 3000,
     11110 and 131100; fft 3000 and 16256 (MIN, 90%) twice, bit-identical;
  4. the scan kernels against their plain versions run in float64: K2 (the
     packed FFT kernel) through the dispatcher, each case one launch and no
     call of the direct-DFT matmul, at quickFullScan's geometry (fft 64,
     ones, 90%)
     in all four modes at one sweep and 16 sweeps of blocks (T = 1226 and
     19616), every fft 2-128 in all four modes at curScanNonOverlap 0.5,
     0.75, 0.25 and 0.1, the two cells of fault C2 (fft 128 at 50% with
     fft2FullMult 81, fft 64 at 90% with 96) and fft 128 x 399 (the chunked
     walk), each case beside the parent form (``-DKSPEC_PACKED_PARENT=1``)
     on the same planes, whose worst share of the per-bin bound K2's may
     not pass by more than 10%; u8 bit-identical to decoded float32 at
     quickFullScan and at the C2 cells; two runs at quickFullScan
     bit-identical; K1 (float64 plain)
     at fmScan's geometry (fft 16384, ones, 90%) and at the lane kernel's
     cell (fft 16384, kaiser, 50%);
  5. ``parallel.stream`` over 16384 blocks (268 M samples, ~112 s of
     2.4 Msps IQ made on the card) in chunks of 1024, against the plain
     path on the same data;
  6. the zero-span path: ``kspecanal_tpu_torch.cli.main`` serial, catch-up
     and on a u8 capture file at fft 2048, catch-up at fft 16384, serial
     at fft 65536 (eight blocks of 8192 a window), at fft 1280 and at fft
     20480 (the mixed-radix form, in one block and in a cluster of two);
     every run must launch the FFT kernel and never the direct kernel, and
     put the synth peaks of its final average on 91/92/93 MHz; every
     catch-up run must launch the display fold kernel, and no step may
     take the plain display chain on the card (``display_fold``'s
     launches in the kernels line are these sessions');
 6b. K3's sizes through ``cli.main``: zeroSpan at fft 3000 serial and at
     fft 10000 with ``tpuCatchUp 16``, ``zeroSpanSave`` at fft 3000 from a
     u8 capture file and ``zeroSpanPlay`` of that recording, and a
     ``tpuStateFile`` pair whose second session resumes the first; each
     that computes spectra launches the FFT kernel (the count over them is
     K3's launches), and each final average has its peaks on 91/92/93 MHz;
  7. the scan path through ``cli.main``: fmScan serial, catch-up and from a
     u8 capture file, fmScan at the lane kernel's cell, quickFullScan serial
     and catch-up with sweep read-ahead; each must launch its kernel and put
     the strongest peaks of its final average on integer MHz;
  8. times (CUDA events, median of 10) of K1's FFT kernel, the direct
     kernel (K1 before its redesign) and the plain chain at each cell and at
     fft 1280, 3072 (T=4096) and 16256 (T=1024), and of the FFT kernel and
     the plain chain at fft 20480 and 98304 (T=64, 50%
     and 90%), 130944 and 262144 (T=8), K3's fft 3000 and 10000 (T=4096,
     50% and 90%) and 39800 (T=64), with the mixed kernel's stage table
     (``scripts.mixed_stages``: cut off after its input, odd passes and
     power-of-two passes) at fft 3000, 10000, 16256 and 39800; the
     power-of-two kernel's parent form (``-DKSPEC_FFT_PARENT=1``) timed
     beside it at the main, fmScan, lane and fft 65536 cells (its T=64
     sweep over the powers of two is ``scripts.fft_stages
     --versus-parent``'s), and its stage table (``scripts.fft_stages``: cut
     off after the block input, pass 1 and the radix-16 passes, each
     checked against its plain version) at the main cell (f32, u8) and
     fmScan's; K2, its parent form (``-DKSPEC_PACKED_PARENT=1``) and the
     plain chain at quickFullScan (T=19616 and 1226, f32 and u8), fft 128
     kaiser 50% and fft 32 RAW at curScanNonOverlap 0.25 (T=4096), and at
     the C2 cell fft 128 mult 81 (T=1024) with the direct-DFT matmul it
     took before beside them, and K2's stage table (``scripts.
     packed_stages``: cut off after its input, the FFT in registers and
     the exchange across lanes, each checked against its plain version) at
     quickFullScan T=19616 (f32, u8); each
     beside its bound: the larger of 5 N log2 N + 4 N flops a window at 67
     TFLOP/s and the planes read once plus the output written once at 3.35
     TB/s;
  9. the on-device sources: devicesynth planes against the same start times
     synthesised on the CPU, its tone purity (>= 120 dB, peaks on 91/92/93
     MHz), devicenoise's u8 planes (mean 127.5 +- 0.5);
 10. K4 and K1's ablate keys at HIGHEST, on the six-pass forensic builds:
     each of Kernel A's cut-offs against its plain version within TC_TOL at
     fft 2048 kaiser 50% AVG (T=256) and fft 16384 (T=32, the fold in the
     output rows), one launch each, 'full' after the layout map bitwise
     equal to the no-key ablate build; every variant of the kernel-ablation
     script on Kernel A's HIGHEST ablate build (fft 2048, T=256, u8 and
     f32) and Kernel C's (fft 32768 on (256, 128), T=16, f32 and u8),
     within TC_TOL of its plain version, one launch of its build, u8
     bit-identical to decoded f32; the no-key builds against the float64
     oracle at fft 2048 and 32768 beside HIGH's;
 10b. K4 at HIGH and DEFAULT: each of Kernel A's cut-offs (read, frame,
     s1, s1tw, s2; ``cuda_tc.stage_library``) against its plain version
     within TC_TOL at fft 2048 (T=256) and fft 16384 (T=32, four window
     groups), 'full' bitwise equal to Kernel A's production output after
     the layout map;
 11. at HIGH and DEFAULT every variant of the kernel-ablation script on
     Kernel A's ablate build (fft 2048, T=256, DEFAULT u8 and f32, HIGH
     f32) and on Kernel C's (fft 32768 on (256, 128), T=16, HIGH f32 and
     DEFAULT u8) within TC_TOL of its plain version, one launch of its
     build and none of the FFT kernel's, u8 bit-identical to decoded f32,
     no key and 'concat' bitwise equal to the production kernel in all four
     modes;
 12. the forensics path's sessions through ``cli.main`` at fft 2048 kaiser
     50%: devicesynth and devicenoise with ``tpuCatchUp 1024`` (8 batches),
     then again with ``tpuProfile``, and the host synth with ``tpuProfile``:
     each launches K1 (u8 planes for devicenoise), writes a trace and logs
     the card's busy share; devicesynth puts its peaks on 91/92/93 MHz;
 13. the forensics scripts on the card: the stage table of
     ``scripts.roofline_r2`` at HIGHEST (Kernel A's six-pass cut-offs, fft
     2048 T=4096; fft 16384 T=288), the marginal tables of
     ``scripts.kernel_ablate`` at HIGHEST (fft 2048 u8 and f32,
     T=4096/8192; fft 32768 u8, T=64/128; 'base' the FFT kernel) and
     ``scripts.session_ablate`` at k=4096 (cut from 16384 to save time),
     with the launches of the HIGHEST builds and of the direct kernel (the
     roofline table's yardstick) counted over them, K4 HIGHEST 'full' and
     each HIGHEST ablate build with no stage removed beside its plain
     version and bound, then ``roofline_r2``'s DEFAULT table
     (Kernel A's cut-offs, fft 2048 T=4096, launches counted in
     ``cuda_tc.tc_stage_launches``) and its HIGH table with the plain
     version's time, ``kernel_ablate``'s class tables
     (fft 2048 DEFAULT u8 and HIGH f32 on Kernel A, T=4096/8192; fft 32768
     DEFAULT u8 on Kernel C, T=64/128) with the launches of each ablate
     build, and each ablate build's time with no stage removed beside its
     plain version and bound;
 13b. the offline analyzer: ``tools.main`` on a capture from
     ``scripts.make_fixture`` (1,024,000 samples at 92 MHz) at fft 2048
     (K1) and 128 (K2), with and without ``decimate 4``, each launching its
     kernel, each spectrum against the float64 plain chain (BOUND), peaks
     on the synth's tones;
 13c. the renderer's toggles: a renderer without matplotlib turns
     b_data_min off after its second frame in the zero-span serial,
     catch-up and replay sessions and in fmScan serial and catch-up; the
     min curve freezes after the toggle; then a ``tpuRenderer png:`` session
     where matplotlib is installed (the script says which case applied);
 14. ``scripts.qfs_ablate``: one quickFullScan sweep (1226 bands x 512)
     split into band curscans (K2), display chain, stitch and epilogue on
     the card, beside the serial session's whole sweep;
 15. the precision classes HIGH and DEFAULT (``ops/cuda_tc.py``): Kernel A
     (``csrc/curscan_tc.cu``, the tensor-core two-stage DFT) against its
     plain version at every instantiation (class x 3M/4M x f32/u8 x 1, 2,
     4 and 8 m-tiles a pass, all four modes) at the zero-span main shape
     (fft 2048, 50%), fmScan's (fft 16384, ones, 90%), fft 10240 at 90%
     (stage 1 by m-tiles, F1 in shared memory), fft 1280 at 75% (n1 = 10,
     misaligned) and fft 2048 with one and two windows a block, Kernel B
     (``csrc/curscan_packed_tc.cu``) at quickFullScan's (fft 64, ones, 90%),
     fft 128 kaiser 50%, fft 8 hanning 50% and fft 32 ones 90% (every
     instantiation), u8 bit-identical to decoded float32 in each form; each
     class against the float64 oracle at full size
     (``scripts.threemult_smoke``'s eight jobs, 64 blocks, with their
     marginal rates; fmScan and quickFullScan f32 and u8, quickFullScan
     also at HIGH), within HIGH 5e-5 and DEFAULT 3.9e-2; the kernels'
     times beside the FFT kernels at HIGHEST and the plain versions (each
     output held to the plain version's: the main path's shapes, one
     window group a block), with their bound (the tensor-core flops at 989
     TFLOP/s or the bytes at 3.35 TB/s) and the FFT-flops bound; Kernel
     B's stage table (``scripts.packed_tc_stages``: copy, products, full at
     quickFullScan, T=19616 and 1226, f32/u8, DEFAULT/HIGH, with 10 rounds
     against K2's FFT kernel); sessions through ``cli.main`` at tpuPrecision
     DEFAULT (zero-span devicesynth catch-up, also at HIGH, devicenoise u8,
     a u8 capture file, fmScan catch-up and from a u8 file, the lane
     kernel's cell, quickFullScan), each launching its tensor-core kernel
     and no FFT kernel, peaks on the synth tones;
 15b. Kernel C (``cuda_tc.curscan_tc_split``, ``csrc/curscan_tc_split.cu``,
     the tensor-core two-stage DFT on the JAX dispatcher's split: K3 off
     the 128 grid and the grid above fft 16384 at HIGH and DEFAULT) against
     its plain version at every class x 3M/4M x f32/u8 x mode at fft 2050,
     3000, 10000, 39800 and 131100 (lane splits), 32768 and 131072
     (sublane split), 50% and 90%, and 65536 at 50% (256 x 256 on f32, 512
     x 128 on u8), u8 bit-identical to decoded float32 on the same split;
     the classes against the float64 oracle through the dispatcher at fft
     3000, 10000, 32768 and 65536; its times at fft 3000 and 10000 (T=4096)
     and 39800, 65536 and 32768 at 90% (T=64) beside the FFT kernel at
     HIGHEST, the float32 ``torch.fft`` chain and the plain version, each
     output held to the plain version's, with the bound (4M tensor-core
     flops of the split, x3 at HIGH, at 989 TFLOP/s, or the bytes), each
     cell's stage table (Kernel C's ``-DKSPEC_TCS_STOP`` cut-offs, as
     ``scripts/tc_split_stages.py`` times them), its shared memory a block,
     blocks an SM and window groups; zeroSpan through ``cli.main`` at
     fft 3000 DEFAULT serial, fft 10000 HIGH catch-up, fft 65536 DEFAULT on
     a u8 capture file (the sublane split) and on synth (the lane split),
     each launching Kernel C on that split and no other curscan kernel,
     peaks on 91/92/93 MHz;
 16. mesh: the sharded paths (``parallel/``) in worlds of ranks started by
     ``parallel/spawn.run_world`` after the build (the ranks only load the
     library): one rank on NCCL, 2 and 4 ranks sharing the card over gloo
     (every collective copied through the host), and NCCL worlds of 2 and
     4 where there are as many cards.  Each world runs BASELINE config 5
     (fft 16384, kaiser, 90%, full_size 131072) time-sharded in all four
     modes and fft-sharded (AVG, MAX), the zero-span main cell's stream
     sharded at T=4096, the fmScan and quickFullScan presets band-sharded
     (18 and 1226 bands, padded to a multiple of the ranks), each against
     the unsharded port on the card within the per-bin bound, each rank
     launching K1 and K2; at two ranks ``cli.main`` runs zeroSpan fft 16384
     90% with ``tpuMeshTime 2`` (peaks on 91/92/93 MHz) and fmScan with
     ``tpuMeshBand 2`` (peaks on integer MHz); the stream's rates at each
     world size (not scaling figures where ranks share a card).
The line before the last lists each kernel with its launches on its path,
its error, its times and its bound; ``library_ms`` is null throughout: no
single PyTorch call computes a curscan (the plain version, cuFFT plus
elementwise calls, is timed as ``plain_ms``).  The last line is the device
record.
"""
import json
import logging
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ZS_ARGS = ["zeroSpan", "centerFreq", "92e6", "window", "kaiser",
           "curScanNonOverlap", "0.5", "tpuLogIter", "false"]
MAIN_ARGS = ZS_ARGS + ["fftSize", "2048"]
PEAKS_HZ = (91e6, 92e6, 93e6)
FM_ARGS = ["fmScan", "tpuLogIter", "false"]
QFS_ARGS = ["quickFullScan", "tpuLogIter", "false"]
LANE_CELL_ARGS = FM_ARGS + ["window", "kaiser", "curScanNonOverlap", "0.5"]
BOUND = ("bound: |err| <= 5e-5*|plain| + 1e-6*peak per bin, and max-rel "
         "< 1e-5")
# The float32 torch.fft chain misses that bound against float64 on MIN folds
# at 90% overlap (up to 1.5 times it at fft 32768), so K1 is held to its
# plain version run in float64 on the same planes.
BOUND64 = BOUND + "; plain run in float64 on the same planes"
MODES = ("AVG", "MAX", "MIN", "RAW")
# K1's mixed-radix form: one block (384, 1280, 3072, 16256), clusters of 2,
# 8 and 8 (20480, 98304, 130944), the scratch route (262144).
MIXED = (384, 1280, 3072, 16256, 20480, 98304, 130944, 262144)
# K3's cells off the 128 grid, with the overlaps at which the JAX dispatcher
# sends them to its lane kernel: one block (2500, 3000; 10000 with 16 points
# a thread; 2050 = 2 * 5^2 * 41 and 11110 = 2 * 5 * 11 * 101, a prime >= 17
# in the ragged plan), a cluster of 4 (39800 = 200 * 199), the scratch route
# (33250 = 2 * odd, c = 5; 131100, c = 10).
LANE = ((2500, (0.5, 0.1)), (3000, (0.5, 0.1)), (10000, (0.5, 0.1)),
        (39800, (0.5, 0.1)), (33250, (0.5,)), (131100, (0.5, 0.1)),
        (2050, (0.5, 0.1)), (11110, (0.5, 0.1)))
# K2: every fft it takes, and (fft, curScanNonOverlap, fft2FullMult) of the
# two cells of fault C2 (JAX's kernel and the port's matmul before; the
# port's kernel and JAX's matmul) and of the chunked walk.
PACKED_FFTS = (2, 4, 8, 16, 32, 64, 128)
PACKED_C2 = ((128, 0.5, 81), (64, 0.1, 96))
PACKED_WALK = (128, 0.5, 399)
# The plain chain holds several (T, W, N) complex64 tensors at once: it is
# timed in chunks of IQ blocks whose frames stay within this many bytes.
PLAIN_FRAME_BYTES = 8 << 30
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM bf16 tensor cores, dense
# The tensor-core kernels against their plain versions, per bin (rtol, atol
# of the peak) by class (tests/torch_parity.TC_TOL): only the order of the
# float32 sums inside each product differs, which at DEFAULT can move a
# stage-1 value across a bf16 rounding boundary.
TC_TOL = {"DEFAULT": (1e-2, 1e-2), "HIGH": (5e-5, 5e-5),
          "HIGHEST": (5e-5, 1e-6)}
# The classes' worst-bin bounds against the float64 oracle (ROADMAP.md C);
# HIGHEST: the six-pass forensic builds, held to HIGH's bound.
ORACLE_BOUND = {"HIGH": 5e-5, "DEFAULT": 3.9e-2, "HIGHEST": 5e-5}
# The tensor-core plain versions hold some twenty (T, W, N) float32
# intermediates: they are timed in chunks of this many frame bytes.
TC_PLAIN_FRAME_BYTES = 1 << 30


def bound(cfg, t, u8):
    """The least time (ms) the card could take for one curscan call, and
    what bounds it: the larger of the FFT's flops (5 N log2 N + 4 N a
    window) at 67 TFLOP/s and the planes read once plus the output written
    once at 3.35 TB/s."""
    n = cfg.fft_size
    flops = t * cfg.num_windows * (5 * n * math.log2(n) + 4 * n)
    nbytes = 2 * t * cfg.full_size * (1 if u8 else 4) + 4 * t * n
    ops_ms, bytes_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms
                                   else "bytes")


def tc_bound(cfg, t, u8, split=None):
    """The least time (ms) the card could take for one tensor-core kernel
    call, what bounds it, and the FFT-flops bound of :func:`bound` beside
    it.  Operations: the kernel's own tensor-core flops at 989 TFLOP/s bf16,
    times 3 at HIGH (the bf16x3 split) and 6 at HIGHEST (the forensic
    builds' six passes): Kernels A and C (fft n = n1 n2;
    Kernel A's n2 = 128, Kernel C's ``split``) 4 real products (the
    production 4M form) a stage a window, each 2 n1 n1 n2 flops in stage 1
    and 2 n1 n2 n2 in stage 2; Kernel B (fft <= 128) 4 products of 2 n n.
    Bytes: the planes read once plus the output written once at 3.35
    TB/s."""
    from kspecanal_tpu_torch.ops import cuda_tc
    n = cfg.fft_size
    if n <= 128:
        per_window = 4 * 2 * n * n
    else:
        n1, n2 = split or (n // 128, 128)
        per_window = 4 * 2 * n1 * n2 * (n1 + n2)
    per_window *= {"HIGH": 3, "HIGHEST": 6}.get(cuda_tc.precision_class(cfg),
                                               1)
    ops_ms = t * cfg.num_windows * per_window / BF16_FLOPS * 1e3
    nbytes = 2 * t * cfg.full_size * (1 if u8 else 4) + 4 * t * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms > bytes_ms else "bytes", bound(cfg, t, u8))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def cfg_of(fft=2048, nono=0.5, mode="AVG", window="WIN.KAISER", mult=8):
    from kspecanal_tpu_torch import SpecConfig
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=nono,
                      cur_scan_cumu_mode=mode, x_res=min(512, fft),
                      fft2full_mult4less=mult).finalize()


def noise(cfg, t, u8, gen):
    shape = (t, cfg.full_size)
    if u8:
        return tuple(torch.randint(0, 256, shape, generator=gen,
                                   device="cuda", dtype=torch.uint8)
                     for _ in range(2))
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 for _ in range(2))


def spectra_error(got, want):
    """(max abs error, max-rel = max abs / peak, worst per-bin relative
    error, whether |err| <= 5e-5*|want| + 1e-6*peak holds everywhere)."""
    err = (got.double() - want.double()).abs()
    ref = want.double().abs()
    peak = ref.max().item()
    ok = bool((err <= 5e-5 * ref + 1e-6 * peak).all())
    return (err.max().item(), err.max().item() / peak,
            (err / ref.clamp_min(1e-30)).max().item(), ok)


def bound_share(got, want):
    """The largest per-bin error as a share of the bound (<= 1 passes)."""
    err = (got.double() - want.double()).abs()
    ref = want.double().abs()
    return (err / (5e-5 * ref + 1e-6 * ref.max())).max().item()


def plain64(cc, re, im, cfg):
    """K1's plain version in float64 on the same (float) planes."""
    return cc.curscan_fused_sublane_plain(re.double(), im.double(), cfg)


def counts(cc):
    return cc.launches, cc.direct_launches


def fft_kernel_case(cc, cfg, t, gen, parent_errs=None):
    """One FFT-kernel case on noise planes: one launch through the wrapper,
    held to the plain version in float64 (the float32 plain chain's share
    of the bound beside it, and at a power of two the parent form's, which
    the kernel's may not pass by more than 10%; its max abs error goes into
    ``parent_errs`` by fft where given).  Returns the max abs error."""
    route = cc.kernel_route(cfg)
    re, im = noise(cfg, t, False, gen)
    before = counts(cc)
    got = cc.curscan_fused_sublane(re, im, cfg)
    after = counts(cc)
    want = plain64(cc, re, im, cfg)
    f32 = cc.curscan_fused_sublane_plain(re, im, cfg)
    torch.cuda.synchronize()
    check(got.shape == (t, cfg.fft_size) and bool(got.isfinite().all()),
          "FFT kernel output shape/finite")
    launched = (after[0] - before[0], after[1] - before[1])
    check(route == "fft" and launched == (1, 0),
          f"fft {cfg.fft_size} launched the FFT kernel once")
    mx, mrel, bin_rel, ok = spectra_error(got, want)
    share = bound_share(got, want)
    pow2 = not cc.runs_mixed_kernel(cfg.fft_size)
    c, via_scratch = cc.fft_plan(cfg.fft_size)
    if pow2:
        old = cc.curscan_fft_stage(re, im, cfg, "full", True)
        parent = bound_share(old, want)
        ok = ok and share <= 1.1 * parent
        if parent_errs is not None:
            parent_errs.setdefault(cfg.fft_size, spectra_error(old, want)[0])
    print(f"{route} kernel: fft {cfg.fft_size} (c={c}"
          f"{', scratch' if via_scratch else ''}) ovl "
          f"{1 - cfg.cur_scan_non_overlap:.1f} {cfg.window} "
          f"{cfg.cur_scan_cumu_mode} W={cfg.num_windows} T={t}: max_abs "
          f"{mx:.3e} max_rel {mrel:.3e} worst_bin_rel {bin_rel:.3e}, "
          f"{share:.4f} of the bound (float32 plain "
          f"{bound_share(f32, want):.3f}"
          f"{f', parent form {parent:.4f}' if pow2 else ''}) "
          f"{'PASS' if ok and mrel < 1e-5 else 'FAIL'}")
    check(ok and mrel < 1e-5, f"FFT kernel vs plain at {cfg.fft_size}/"
          f"{cfg.cur_scan_non_overlap}/{cfg.cur_scan_cumu_mode}")
    return mx


def u8_case(cc, spec, cfg, t, gen):
    """u8 planes through the FFT kernel bit-identical to the decoded
    float32 planes."""
    re, im = noise(cfg, t, True, gen)
    got = cc.curscan_fused_sublane(re, im, cfg)
    dec = cc.curscan_fused_sublane(spec.decode_u8(re), spec.decode_u8(im),
                                   cfg)
    same = torch.equal(got, dec)
    print(f"u8 planes vs decoded f32 through the FFT kernel, fft "
          f"{cfg.fft_size} ovl {1 - cfg.cur_scan_non_overlap:.1f}: "
          f"{'bit-identical' if same else 'DIFFER'}")
    check(same, "u8 kernel input bit-identical to decoded f32")


def phase_kernels(cc, spec, gen):
    """K1 vs its plain version in float64 on the card.  Returns the max abs
    errors of the FFT kernel (AVG, 50%) by fft, and of the direct kernel at
    fft 1280 under the key 'direct'."""
    print(f"== K1 vs plain ({BOUND64})")
    errs = {}
    cases = [(cfg_of(2048, 0.5, m), 256) for m in MODES]
    cases += [(cfg_of(2048, 0.1, m), 64) for m in ("AVG", "MIN")]
    cases += [(cfg_of(256, 0.5, "AVG", "WIN.HANNING"), 256),
              (cfg_of(16384, 0.5, "AVG"), 64),
              (cfg_of(16384, 0.5, "MAX"), 64)]
    cases += [(cfg_of(n, nono, m), 4) for n in (32768, 65536, 131072)
              for nono in (0.5, 0.1) for m in ("AVG", "MIN")]
    cases += [(cfg_of(n, nono, m), 4 if n <= 16384 else 2) for n in MIXED
              for nono in (0.5, 0.1) for m in MODES]
    parent = {}
    for cfg, t in cases:
        first = (cfg.cur_scan_non_overlap == 0.5
                 and cfg.cur_scan_cumu_mode == "AVG")
        mx = fft_kernel_case(cc, cfg, t, gen, parent if first else None)
        if first:
            errs.setdefault(cfg.fft_size, mx)
    errs["parent2048"] = parent[2048]
    for mode in ("AVG", "MIN"):
        cfg = cfg_of(1280, 0.5, mode, "WIN.HANNING")
        before = counts(cc)
        mx = compare(cc.curscan_sublane_direct,
                     lambda re_, im_, c: plain64(cc, re_, im_, c), cfg, 256,
                     gen, "direct kernel")
        check(counts(cc) == (before[0], before[1] + 1),
              "the direct kernel's entry launched it once")
        errs.setdefault("direct", mx)
    for fft, nono, t in ((2048, 0.5, 256), (2048, 0.1, 256), (65536, 0.5, 4),
                         (65536, 0.1, 4), (1280, 0.5, 64), (1280, 0.1, 64),
                         (20480, 0.5, 4), (20480, 0.1, 4), (262144, 0.5, 2),
                         (262144, 0.1, 2)):
        u8_case(cc, spec, cfg_of(fft, nono), t, gen)
    return errs


def phase_lane_kernels(cc, spec, gen):
    """K3's cells off the 128 grid (the lane kernel's sizes, served by the
    FFT kernel's mixed-radix form) vs the plain version in float64, every
    cumulate mode at each overlap the JAX dispatcher sends to K3; u8
    bit-identical at fft 3000 and 131100.  Returns the max abs error at
    fft 3000 AVG 50%."""
    print(f"== K3's cells off the 128 grid vs plain ({BOUND64})")
    err = None
    for fft, overlaps in LANE:
        for nono in overlaps:
            for mode in MODES:
                cfg = cfg_of(fft, nono, mode)
                check(fft % 128 and cc.kernel_route(cfg) == "fft",
                      f"fft {fft} ovl {1 - nono:.1f} is a K3 cell")
                mx = fft_kernel_case(cc, cfg, 4 if fft <= 16384 else 2, gen)
                if (fft, nono, mode) == (3000, 0.5, "AVG"):
                    err = mx
    for fft, t in ((3000, 64), (11110, 4), (131100, 2)):
        for nono in (0.5, 0.1):
            u8_case(cc, spec, cfg_of(fft, nono), t, gen)
    for fft, t in ((3000, 64), (16256, 16)):
        cfg = cfg_of(fft, 0.1, "MIN")
        re, im = noise(cfg, t, False, gen)
        same = torch.equal(cc.curscan_fused_sublane(re, im, cfg),
                           cc.curscan_fused_sublane(re, im, cfg))
        print(f"FFT kernel twice, fft {fft} ovl 0.9 MIN T={t}: "
              f"{'bit-identical' if same else 'DIFFER'}")
        check(same, f"two runs at fft {fft} give identical bits")
    return err


def compare(kernel, plain, cfg, t, gen, what):
    """One kernel-vs-plain case on noise planes; returns the max abs
    error."""
    re, im = noise(cfg, t, False, gen)
    got = kernel(re, im, cfg)
    want = plain(re, im, cfg)
    torch.cuda.synchronize()
    check(got.shape == (t, cfg.fft_size) and bool(got.isfinite().all()),
          f"{what} output shape/finite")
    mx, mrel, bin_rel, ok = spectra_error(got, want)
    print(f"{what}: fft {cfg.fft_size} ovl {1 - cfg.cur_scan_non_overlap:.2f} "
          f"{cfg.window} {cfg.cur_scan_cumu_mode} W={cfg.num_windows} T={t}: "
          f"max_abs {mx:.3e} max_rel {mrel:.3e} worst_bin_rel {bin_rel:.3e} "
          f"{'PASS' if ok and mrel < 1e-5 else 'FAIL'}")
    check(ok and mrel < 1e-5, f"{what} vs plain at {cfg.fft_size}/"
          f"{cfg.cur_scan_non_overlap}/{cfg.cur_scan_cumu_mode}/T={t}")
    return mx


def via_dispatcher(cp, spec):
    """K2 as the scan path reaches it, ``curscan_auto_batched``, with the
    direct-DFT matmul made to fail: the call must launch K2 once."""
    def run(re_, im_, cfg):
        before = cp.launches
        with mock.patch.object(spec, "curscan_direct_batched",
                               side_effect=RuntimeError("FAILED: the "
                                                        "matmul ran")):
            out = spec.curscan_auto_batched(re_, im_, cfg)
        check(cp.launches == before + 1,
              f"fft {cfg.fft_size} full {cfg.full_size} launched K2 once")
        return out
    return run


def packed_u8_case(cp, spec, cfg, t, gen):
    """u8 planes through K2 bit-identical to the decoded float32 planes."""
    re_, im_ = noise(cfg, t, True, gen)
    same = torch.equal(
        cp.curscan_fused_packed(re_, im_, cfg),
        cp.curscan_fused_packed(spec.decode_u8(re_), spec.decode_u8(im_),
                                cfg))
    print(f"K2 u8 planes vs decoded f32, fft {cfg.fft_size} full "
          f"{cfg.full_size} nono {cfg.cur_scan_non_overlap} T={t}: "
          f"{'bit-identical' if same else 'DIFFER'}")
    check(same, "K2 u8 input bit-identical to decoded f32")


def packed_case(cp, spec, cfg, t, gen, what, shares):
    """One K2 case on noise planes through the dispatcher (one launch, no
    matmul), held to its plain version in float64 within the per-bin
    bound, the parent form (``-DKSPEC_PACKED_PARENT=1``) on the same
    planes beside it: K2's worst share of the bound may not pass 1.1 times
    the parent's.  Appends (share, parent's share) to ``shares``; returns
    the max abs errors of K2 and of the parent form."""
    re, im = noise(cfg, t, False, gen)
    got = via_dispatcher(cp, spec)(re, im, cfg)
    want = cp.curscan_fused_packed_plain(re.double(), im.double(), cfg)
    old = cp.curscan_packed_stage(re, im, cfg, "full", True)
    torch.cuda.synchronize()
    check(got.shape == (t, cfg.fft_size) and bool(got.isfinite().all()),
          f"{what} output shape/finite")
    mx, mrel, bin_rel, ok = spectra_error(got, want)
    share, parent = bound_share(got, want), bound_share(old, want)
    ok = ok and mrel < 1e-5 and share <= 1.1 * parent
    print(f"{what}: fft {cfg.fft_size} ovl "
          f"{1 - cfg.cur_scan_non_overlap:.2f} {cfg.window} "
          f"{cfg.cur_scan_cumu_mode} W={cfg.num_windows} T={t}: max_abs "
          f"{mx:.3e} max_rel {mrel:.3e} worst_bin_rel {bin_rel:.3e}, "
          f"{share:.4f} of the bound (parent form {parent:.4f}) "
          f"{'PASS' if ok else 'FAIL'}")
    check(ok, f"{what} vs plain at {cfg.fft_size}/"
          f"{cfg.cur_scan_non_overlap}/{cfg.cur_scan_cumu_mode}/T={t}")
    shares.append((share, parent))
    return mx, spectra_error(old, want)[0]


def phase_scan_kernels(cc, cp, spec, gen):
    """The scan path's kernels vs plain (K1's in float64).  Returns the max
    abs errors of K2 and its parent form at quickFullScan (AVG, 16
    sweeps), K1 at fmScan (AVG, T=288) and at the lane kernel's cell, and
    K2's largest share of the per-bin bound over the parent form's
    ('packed_ratio')."""
    qfs = cfg_of(64, 0.1, "AVG", "WIN.ONES")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"== scan kernels vs plain ({BOUND64}); quickFullScan geometry: "
          f"{qfs.num_windows} windows over {qfs.full_size} samples, "
          f"{len({s % 64 for s in qfs.window_starts})} start residues")
    sublane = (cc.curscan_fused_sublane,
               lambda re_, im_, cfg: plain64(cc, re_, im_, cfg))
    errs, shares = {}, []

    def plan(cfg, t):
        return cp.plan_for(cfg, t, False, sms)
    for t in (1226, 1226 * 16):     # one and 16 quickFullScan sweeps
        for mode in MODES:
            cfg = cfg_of(64, 0.1, mode, "WIN.ONES")
            mx = packed_case(cp, spec, cfg, t, gen, f"K2 ({plan(cfg, t)})",
                             shares)
            if mode == "AVG":
                errs["packed"], errs["packed_parent"] = mx
        packed_u8_case(cp, spec, qfs, t, gen)
    re_, im_ = noise(qfs, 1226 * 16, False, gen)
    same = torch.equal(cp.curscan_fused_packed(re_, im_, qfs),
                       cp.curscan_fused_packed(re_, im_, qfs))
    print(f"K2 twice at quickFullScan, T=19616: "
          f"{'bit-identical' if same else 'DIFFER'}")
    check(same, "two K2 runs give identical bits")
    del re_, im_
    for fft in PACKED_FFTS:
        for nono in (0.5, 0.75, 0.25, 0.1):
            for mode in MODES:
                packed_case(cp, spec, cfg_of(fft, nono, mode,
                                             mult=max(8, 256 // fft)), 256,
                            gen, "K2", shares)
    for fft, nono, mult in PACKED_C2 + (PACKED_WALK,):
        for mode in MODES:
            cfg = cfg_of(fft, nono, mode, mult=mult)
            packed_case(cp, spec, cfg, 64, gen,
                        f"K2 mult {mult} (plan {plan(cfg, 64)})", shares)
    errs["packed_ratio"] = max(a / b for a, b in shares)
    print(f"K2 over {len(shares)} cases: largest share of the per-bin bound "
          f"{max(a for a, _ in shares):.4f} (parent form "
          f"{max(b for _, b in shares):.4f}); largest ratio to the parent "
          f"form's share on the same planes {errs['packed_ratio']:.3f}")
    for fft, nono, mult in PACKED_C2:
        packed_u8_case(cp, spec, cfg_of(fft, nono, mult=mult), 64, gen)
    for t in (18, 288):                # one and 16 fmScan sweeps
        for mode in ("AVG", "MAX", "MIN"):
            mx = compare(*sublane, cfg_of(16384, 0.1, mode, "WIN.ONES"), t,
                         gen, "K1")
            if mode == "AVG" and t == 288:
                errs["fm"] = mx
    errs["lane_cell"] = compare(*sublane, cfg_of(16384, 0.5, "AVG"), 64, gen,
                                "K1 at the lane kernel's cell")
    return errs


def stream_iq(cfg, blocks, gen):
    """1-D float32 planes of ``blocks`` main-path blocks made on the card:
    tones at -1/0/+1 MHz (91/92/93 MHz) over white noise."""
    n = blocks * cfg.full_size
    re = torch.randn(n, generator=gen, device="cuda")
    im = torch.randn(n, generator=gen, device="cuda")
    step = 1 << 24
    for f in (-1e6, 0.0, 1e6):
        for s in range(0, n, step):
            k = torch.arange(s, min(n, s + step), device="cuda",
                             dtype=torch.float64)
            ph = (2 * np.pi * torch.frac(k * (f / cfg.sampling_rate))).float()
            re[s:s + k.numel()] += 8.0 * torch.cos(ph)
            im[s:s + k.numel()] += 8.0 * torch.sin(ph)
    return re, im


def assert_db_close(got, want, what, span_db=100.0, tol_db=1e-3):
    got, want = got.double().cpu(), want.double().cpu()
    mask = want >= want.max() - span_db
    err = (got - want).abs()[mask].max().item()
    print(f"  {what}: max |dB err| {err:.3e} over {int(mask.sum())} bins")
    check(err <= tol_db, f"{what} within {tol_db} dB")


def phase_stream(cc, st, gen):
    cfg = cfg_of()
    blocks, chunk = 16384, 1024
    re, im = stream_iq(cfg, blocks, gen)
    torch.cuda.synchronize()
    print(f"== stream: {blocks} blocks x {cfg.full_size} samples "
          f"({blocks * cfg.full_size / 1e6:.0f} M samples, "
          f"{blocks * cfg.full_size / cfg.sampling_rate:.1f} s of IQ) in "
          f"chunks of {chunk}")
    # In turns (plain, kernel, kernel, plain): the first run of each pays
    # one-time set-up; compare the two within this call only.
    results = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        before = cc.launches
        t0 = time.perf_counter()
        if name == "kernel":
            res = st.run_stream_session(re, im, cfg, "cuda", chunk)
        else:
            with mock.patch.object(cc, "curscan_fused_sublane",
                                   cc.curscan_fused_sublane_plain):
                res = st.run_stream_session(re, im, cfg, "cuda", chunk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        results[name] = res
        print(f"  {name}: {dt:.3f} s, {blocks * cfg.full_size / dt / 1e6:.1f}"
              f" Msamp/s, kernel launches {cc.launches - before}")
        want = blocks // chunk if name == "kernel" else 0
        check(cc.launches - before == want, f"stream {name} launches")
    k, p = results["kernel"], results["plain"]
    check(k.rows.shape == (blocks, cfg.x_res), "stream rows shape")
    for f in ("fft_max", "fft_min", "fft_avg", "fft_cur"):
        check(bool(getattr(k, f).isfinite().all()), f"stream {f} finite")
        assert_db_close(getattr(k, f), getattr(p, f), f"stream {f}")
    assert_db_close(k.rows[::997], p.rows[::997], "stream rows (every 997th)")


def write_capture(path, cfg, n_samples, seed):
    """An rtl_sdr capture (u8, value-127 offset, I then Q) of tones at every
    integer MHz in the band over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / cfg.sampling_rate
    x = rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples)
    for f in PEAKS_HZ:
        x += 30 * np.exp(2j * np.pi * (f - cfg.center_freq) * t)
    raw = np.empty(2 * n_samples, np.uint8)
    raw[0::2] = np.clip(np.round(x.real + 127), 0, 255)
    raw[1::2] = np.clip(np.round(x.imag + 127), 0, 255)
    raw.tofile(path)


def avg_peaks(cfg, avg):
    """The three strongest peaks of a final average curve, compressed for
    display as the session's views are."""
    from kspecanal_tpu_torch.ops import dsp
    from kspecanal_tpu_torch.ops.peaks import find_peaks
    from kspecanal_tpu_torch.ops.spectrum import fft_freqs
    x, y = dsp.compress_xy(torch.as_tensor(fft_freqs(cfg), dtype=torch.float32),
                           torch.as_tensor(avg, dtype=torch.float32),
                           cfg.plt_compress, cfg.x_res)
    return sorted(p.freq for p in find_peaks(
        x.numpy(), y.numpy(), cfg.plt_highs_num_markers,
        cfg.plt_highs_delta4marking)[:3])


def load_avg(path):
    """The final average a session saved with ``saveSigLvls`` (pickled
    start, end, curve; kspecanal.py:736-748)."""
    with open(path, "rb") as f:
        pickle.load(f)
        pickle.load(f)
        return np.asarray(pickle.load(f))


def phase_sessions(cc, cli, tmp):
    """The zero-span path through the entry point.  Every catch-up or u8
    session folds its display half in the display fold kernel
    (``models/zerospan.display_updates``): its launches rise and no step
    takes the plain chain on the card.  Returns the FFT kernel's launches
    by fft (2048, 16384, 65536, 1280, 20480) and the display fold kernel's
    by fft (2048, 16384)."""
    from kspecanal_tpu_torch.cli import parse_args
    from kspecanal_tpu_torch.models import zerospan as zs
    from kspecanal_tpu_torch.ops import cuda_display as cd
    cfg = cfg_of()
    cap = os.path.join(tmp, "capture.iq")
    write_capture(cap, cfg, 64 * cfg.full_size, seed=7)
    runs = [("serial", "2048", ["tpuSource", "synth", "prgLoopCnt", "8"], 8),
            ("catch-up", "2048", ["tpuSource", "synth", "prgLoopCnt", "512",
                                  "tpuCatchUp", "128"], 512),
            ("u8 file", "2048", ["tpuSource", f"file:{cap}", "prgLoopCnt",
                                 "64", "tpuCatchUp", "16"], 64),
            ("catch-up", "16384", ["tpuSource", "synth", "prgLoopCnt", "64",
                                   "tpuCatchUp", "16"], 64),
            ("serial, 8 blocks of 8192 a window", "65536",
             ["tpuSource", "synth", "prgLoopCnt", "4"], 4),
            ("serial, the mixed-radix kernel in one block", "1280",
             ["tpuSource", "synth", "prgLoopCnt", "8"], 8),
            ("serial, the mixed-radix kernel in a cluster of 2", "20480",
             ["tpuSource", "synth", "prgLoopCnt", "4"], 4)]
    print("== zero-span sessions through kspecanal_tpu_torch.cli.main")
    cc.launches = cc.direct_launches = cd.launches = 0
    plain_before = zs.plain_cuda_steps
    launches, display = {}, {}
    for name, fft, args, iters in runs:
        args = ZS_ARGS + ["fftSize", fft] + args
        run_cfg = parse_args(args)[0]
        lvls = os.path.join(tmp, f"lvls_{len(launches)}.bin")
        before = counts(cc)
        folds = cd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(args + ["tpuHeadless", "true", "saveSigLvls", lvls])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(rc == 0, f"fft {fft} {name} session rc")
        avg = load_avg(lvls)
        # -inf is a legitimate LogNoGain of an exactly-zero bin (the
        # noiseless synth has some); NaN and +inf are not.
        check(avg.shape == (run_cfg.fft_size,) and not np.isnan(avg).any()
              and not np.isposinf(avg).any(), f"fft {fft} {name} average")
        peaks = avg_peaks(run_cfg, avg)
        cell = run_cfg.sampling_rate / run_cfg.x_res
        on = len(peaks) == 3 and all(abs(p - w) <= cell
                                     for p, w in zip(peaks, PEAKS_HZ))
        fft_n, direct_n = (a - b for a, b in zip(counts(cc), before))
        fold_n = cd.launches - folds
        print(f"  fft {fft} {name}: {iters} iterations in {dt:.3f} s "
              f"({iters * run_cfg.full_size / dt / 1e6:.2f} Msamp/s end to "
              f"end, host source included), launches FFT kernel {fft_n} "
              f"direct kernel {direct_n} display fold {fold_n}, peaks "
              f"{[round(p / 1e6, 4) for p in peaks]} MHz "
              f"{'PASS' if on else 'FAIL'}")
        check(cc.kernel_route(run_cfg) == "fft" and fft_n > 0
              and direct_n == 0,
              f"fft {fft} {name} session launched the FFT kernel (only)")
        check(on, f"fft {fft} {name} peaks on 91/92/93 MHz")
        if "tpuCatchUp" in args:
            check(fold_n > 0, f"fft {fft} {name} session launched the "
                  "display fold kernel")
            display[fft] = display.get(fft, 0) + fold_n
        launches[fft] = launches.get(fft, 0) + fft_n
    check(zs.plain_cuda_steps == plain_before,
          f"no zero-span session step took the plain display chain on the "
          f"card ({zs.plain_cuda_steps - plain_before} did)")
    return launches, display


def phase_lane_sessions(cc, cli, tmp):
    """The zero-span path at K3's sizes through the entry point: zeroSpan
    at fft 3000 serial and fft 10000 with ``tpuCatchUp``; ``zeroSpanSave``
    at fft 3000 from a u8 capture file, then ``zeroSpanPlay`` of the
    recording; a ``tpuStateFile`` pair at fft 3000 whose second session
    resumes the first one's state.  Every session that computes spectra
    launches the FFT kernel (never the direct kernel), and every final
    average puts its peaks on 91/92/93 MHz.  Returns the FFT kernel's
    launches over these sessions, counted from 0."""
    from kspecanal_tpu_torch.cli import parse_args
    log = LogLines()
    logging.getLogger("kspecanal_tpu_torch").addHandler(log)
    cap = os.path.join(tmp, "lane_capture.iq")
    rec = os.path.join(tmp, "lane.save")
    state = os.path.join(tmp, "lane_state")
    write_capture(cap, cfg_of(3000), 32 * cfg_of(3000).full_size, seed=9)
    zs3000 = ZS_ARGS + ["fftSize", "3000"]
    state_args = zs3000 + ["tpuSource", "synth", "tpuStateFile", state]
    runs = [  # (name, args, blocks, launches the kernel, peaks to check)
        ("zeroSpan fft 3000 serial", zs3000 + ["tpuSource", "synth",
                                               "prgLoopCnt", "8"], 8, True,
         True),
        ("zeroSpan fft 10000 tpuCatchUp 16", ZS_ARGS + [
            "fftSize", "10000", "tpuSource", "synth", "prgLoopCnt", "64",
            "tpuCatchUp", "16"], 64, True, True),
        ("zeroSpanSave fft 3000 from a u8 capture, tpuCatchUp 8",
         ["zeroSpanSave"] + zs3000[1:] + [
             "tpuSource", f"file:{cap}", "zeroSpanSaveFile", rec,
             "prgLoopCnt", "32", "tpuCatchUp", "8"], 32, True, False),
        ("zeroSpanPlay of that recording", ["zeroSpanPlay"] + zs3000[1:] + [
            "zeroSpanPlayFile", rec, "tpuCatchUp", "8"], 32, False, True),
        ("tpuStateFile, first session", state_args + ["prgLoopCnt", "4"], 4,
         True, True),
        ("tpuStateFile, second session (resumes)", state_args + [
            "prgLoopCnt", "4", "tpuCatchUp", "4"], 4, True, True)]
    print("== K3's sizes through kspecanal_tpu_torch.cli.main (zero-span, "
          "save, play, tpuStateFile)")
    cc.launches = cc.direct_launches = 0
    for i, (name, args, blocks, launches_kernel, want_peaks) in \
            enumerate(runs):
        run_cfg = parse_args(args)[0]
        lvls = os.path.join(tmp, f"lane_lvls_{i}.bin")
        before, n_log = counts(cc), len(log.lines)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(args + ["tpuHeadless", "true", "saveSigLvls", lvls])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(rc == 0, f"{name} rc")
        fft_n, direct_n = (a - b for a, b in zip(counts(cc), before))
        line = (f"  {name}: {blocks} blocks in {dt:.3f} s, launches FFT "
                f"kernel {fft_n} direct kernel {direct_n}")
        if want_peaks:
            avg = load_avg(lvls)
            check(avg.shape == (run_cfg.fft_size,)
                  and not np.isnan(avg).any(), f"{name} average")
            peaks = avg_peaks(run_cfg, avg)
            cell = run_cfg.sampling_rate / run_cfg.x_res
            on = len(peaks) == 3 and all(abs(p - w) <= cell
                                         for p, w in zip(peaks, PEAKS_HZ))
            line += (f", peaks {[round(p / 1e6, 4) for p in peaks]} MHz "
                     f"{'PASS' if on else 'FAIL'}")
        resumed = any("resume: restored state" in m
                      for m in log.lines[n_log:])
        if "tpuStateFile" in name:
            line += f", resumed: {resumed}"
        print(line)
        check(direct_n == 0 and (fft_n > 0) == launches_kernel,
              f"{name} launched the FFT kernel (only)"
              if launches_kernel else f"{name} launched no kernel")
        if want_peaks:
            check(on, f"{name} peaks on 91/92/93 MHz")
        if "tpuStateFile" in name:
            check(resumed == name.endswith("(resumes)"),
                  f"{name}: resumed only in the second session")
    with np.load(state + ".npz") as z:
        it = int(z["iteration"])
    print(f"  checkpoint after both sessions: {it} iterations")
    check(it == 8, "the second session continued the first one's state")
    logging.getLogger("kspecanal_tpu_torch").removeHandler(log)
    return cc.launches


def write_scan_capture(path, cfg, plan, sweeps, seed):
    """An rtl_sdr capture (u8, value-127 offset, I then Q) of ``sweeps``
    whole sweeps as a stepping receiver records them: band after band,
    ``full_size`` samples each, with a tone at every integer MHz of the band
    over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.full_size) / cfg.sampling_rate
    with open(path, "wb") as f:
        for _ in range(sweeps):
            for b in plan.bands:
                lo = b.center_freq - cfg.sampling_rate / 2
                hi = b.center_freq + cfg.sampling_rate / 2
                x = (rng.standard_normal(cfg.full_size)
                     + 1j * rng.standard_normal(cfg.full_size))
                for mhz in range(int(np.ceil(lo / 1e6)),
                                 int(np.floor(hi / 1e6)) + 1):
                    x += 30 * np.exp(2j * np.pi * (mhz * 1e6 - b.center_freq)
                                     * t + 1j * rng.uniform(0, 2 * np.pi))
                raw = np.empty(2 * cfg.full_size, np.uint8)
                raw[0::2] = np.clip(np.round(x.real + 127), 0, 255)
                raw[1::2] = np.clip(np.round(x.imag + 127), 0, 255)
                raw.tofile(f)


def scan_peaks(cfg, plan, avg):
    """The three strongest peaks of a final scan average, compressed for
    display as the session's views are, and the display cell (Hz)."""
    from kspecanal_tpu_torch.ops import dsp
    from kspecanal_tpu_torch.ops.peaks import find_peaks
    x, y = dsp.compress_xy(
        torch.as_tensor(np.asarray(plan.freqs_all, np.float32)),
        torch.as_tensor(avg, dtype=torch.float32), cfg.plt_compress,
        cfg.x_res)
    x, y = x.numpy(), y.numpy()
    peaks = find_peaks(x, y, cfg.plt_highs_num_markers,
                       cfg.plt_highs_delta4marking)
    return sorted(p.freq for p in peaks[:3]), (x[-1] - x[0]) / (len(x) - 1)


def phase_scan_sessions(cc, cp, cli, tmp):
    """The scan path through the entry point.  Returns the launches of each
    kernel entry: fmScan's K1 (FFT kernel) runs, quickFullScan's packed runs
    and the lane kernel's cell."""
    from kspecanal_tpu_torch.cli import parse_args
    from kspecanal_tpu_torch.session import make_plan_cached
    fm_cfg = parse_args(FM_ARGS)[0]
    cap = os.path.join(tmp, "fm_capture.iq")
    write_scan_capture(cap, fm_cfg, make_plan_cached(fm_cfg), 2, seed=8)
    synth = ["tpuSource", "synth"]
    runs = [
        ("fmScan serial", "fm", FM_ARGS + synth + ["prgLoopCnt", "2"]),
        ("fmScan catch-up", "fm", FM_ARGS + synth + [
            "prgLoopCnt", "16", "tpuCatchUp", "8"]),
        ("fmScan u8 file", "fm", FM_ARGS + ["tpuSource", f"file:{cap}",
                                            "prgLoopCnt", "2"]),
        ("fmScan kaiser 50% (lane kernel's cell)", "lane_cell",
         LANE_CELL_ARGS + synth + ["prgLoopCnt", "2"]),
        ("quickFullScan serial", "qfs", QFS_ARGS + synth + ["prgLoopCnt",
                                                            "2"]),
        ("quickFullScan catch-up, sweep read-ahead", "qfs",
         QFS_ARGS + synth + ["prgLoopCnt", "32", "tpuCatchUp", "16",
                             "tpuPrefetch", "true"]),
    ]
    print("== scan sessions through kspecanal_tpu_torch.cli.main")
    launches = {"fm": 0, "lane_cell": 0, "qfs": 0}
    for i, (name, kind, args) in enumerate(runs):
        cfg = parse_args(args)[0]
        plan = make_plan_cached(cfg)
        lvls = os.path.join(tmp, f"scan_lvls_{i}.bin")
        sweeps = cfg.prg_loop_cnt
        cc.launches = cc.direct_launches = cp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(args + ["tpuHeadless", "true", "saveSigLvls", lvls])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sub, packed = cc.launches, cp.launches
        check(rc == 0, f"{name} session rc")
        check(cc.direct_launches == 0, f"{name} ran no direct kernel")
        avg = load_avg(lvls)
        check(avg.shape == (plan.total_entries,) and np.isfinite(avg).all(),
              f"{name} final average")
        peaks, cell = scan_peaks(cfg, plan, avg)
        on = len(peaks) == 3 and all(
            abs(p - round(p / 1e6) * 1e6) <= cell for p in peaks)
        samples = sweeps * plan.num_bands * cfg.full_size
        print(f"  {name}: {sweeps} sweeps of {plan.num_bands} bands x "
              f"{cfg.full_size} (fft {cfg.fft_size}) in {dt:.3f} s: "
              f"{sweeps / dt:.3f} sweeps/s, {samples / dt / 1e6:.2f} "
              f"Msamp/s end to end (host source included); launches "
              f"K1 {sub} packed {packed}; peaks "
              f"{[round(p / 1e6, 4) for p in peaks]} MHz (cell "
              f"{cell / 1e3:.1f} kHz) {'PASS' if on else 'FAIL'}")
        want_sub, want_packed = (0, 1) if kind == "qfs" else (1, 0)
        check(bool(sub) == want_sub and bool(packed) == want_packed,
              f"{name} launched its kernel (and only it)")
        check(on, f"{name} peaks on integer MHz")
        launches[kind] += sub + packed
    return launches


def phase_timing(cc, cp, spec, gen, gpu):
    """Kernel vs plain times (ms), each case in one row: K1's FFT kernel,
    the direct kernel (K1 before its redesign) and the plain chain at the
    zero-span config (T=4096), fft 1280 and 3072 (T=4096), fft 16256 = 127
    * 128 (T=1024; its largest prime factor makes it the mixed kernel's
    dearest size per point), fmScan's (T=288, 16 sweeps) and the lane
    kernel's cell (T=288); the FFT kernel and the plain
    chain at fft 65536, 20480 and 98304 (T=64) and at 130944 and 262144
    (T=8); K3's cells fft 3000 and 10000 (T=4096, 50% and 90%) and 39800
    (T=64); K2 at quickFullScan's (T=1226*16, 16 sweeps, and T=1226, the
    serial session's one sweep), fft 128 kaiser 50% and fft 32 RAW at
    curScanNonOverlap 0.25 (T=4096), and the C2 cell fft 128 mult 81
    (T=1024) with the direct-DFT matmul in the direct column.
    The plain chain runs in chunks of IQ blocks where its frames would
    pass ``PLAIN_FRAME_BYTES`` (fft 10000 at 90%).
    At the powers of two, and at K2's cells, the parent form's build times
    the same planes after the kernel (``parent_ms``), then
    ``scripts.fft_stages`` runs its stage table at the main and fmScan
    cells and ``scripts.packed_stages`` K2's at quickFullScan T=19616.
    Returns ``{(case, dtype): (kernel, direct, plain, bound, bound_by)}``,
    direct None where no direct kernel runs, and under ``"fft_stages"``
    (``"packed_stages"``) the stage table's rows, its launches, the parent
    form's times by case and its launches."""
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    k1 = (cc.curscan_fused_sublane, cc.curscan_sublane_direct,
          cc.curscan_fused_sublane_plain)
    k1_only = (k1[0], None, k1[2])
    cases = [("zero-span fft 2048 kaiser 50%", cfg_of(), 4096, k1,
              (False, True)),
             ("zero-span fft 1280 kaiser 50%", cfg_of(1280), 4096, k1,
              (False,)),
             ("fft 3072 kaiser 50%", cfg_of(3072), 4096, k1, (False,)),
             ("fft 16256 kaiser 50%", cfg_of(16256), 1024, k1, (False,)),
             ("fmScan fft 16384 ones 90%",
              cfg_of(16384, 0.1, "AVG", "WIN.ONES"), 288, k1, (False,)),
             ("lane kernel's cell fft 16384 kaiser 50%",
              cfg_of(16384, 0.5, "AVG"), 288, k1, (False,)),
             ("zero-span fft 65536 kaiser 50%", cfg_of(65536), 64, k1_only,
              (False,))]
    cases += [(f"fft {n} kaiser {'50' if nono == 0.5 else '90'}%",
               cfg_of(n, nono), t, k1_only, (False,))
              for n, nono, t in ((20480, 0.5, 64), (20480, 0.1, 64),
                                 (98304, 0.5, 64), (98304, 0.1, 64),
                                 (130944, 0.5, 8), (262144, 0.5, 8),
                                 (3000, 0.5, 4096), (3000, 0.1, 4096),
                                 (10000, 0.5, 4096), (10000, 0.1, 4096),
                                 (39800, 0.5, 64))]
    k2 = (cp.curscan_fused_packed, None, cp.curscan_fused_packed_plain)
    qfs = cfg_of(64, 0.1, "AVG", "WIN.ONES")
    cases += [("quickFullScan fft 64 ones 90%", qfs, 1226 * 16, k2,
               (False, True)),
              ("quickFullScan serial sweep fft 64 ones 90%", qfs, 1226, k2,
               (False, True)),
              ("fft 128 kaiser 50%", cfg_of(128, 0.5), 4096, k2, (False,)),
              ("fft 32 RAW nono 0.25", cfg_of(32, 0.25, "RAW"), 4096, k2,
               (False,)),
              ("C2 cell fft 128 kaiser 50% mult 81",
               cfg_of(128, 0.5, mult=81), 1024,
               (k2[0], spec.curscan_direct_batched, k2[2]), (False,))]
    out = {}
    parent_ms, packed_parent_ms = {}, {}
    parent_before = cc.fft_parent_launches
    packed_parent_before = cp.parent_launches
    print(f"== timing (CUDA events, 3 warm-ups, median of 10) [{gpu}]")
    for name, cfg, t, (kernel, direct, plain), dtypes in cases:
        for u8 in dtypes:
            re, im = noise(cfg, t, u8, gen)
            ks = cuda_ms(lambda: kernel(re, im, cfg))
            ds = None if direct is None else cuda_ms(
                lambda: direct(re, im, cfg))
            rows = max(1, min(t, PLAIN_FRAME_BYTES
                              // (cfg.num_windows * cfg.fft_size * 8)))
            ps = cuda_ms(lambda: [plain(re[i:i + rows], im[i:i + rows], cfg)
                                  for i in range(0, t, rows)])
            pms = None
            if kernel is k1[0] and not cc.runs_mixed_kernel(cfg.fft_size):
                pms = cuda_ms(lambda: cc.curscan_fft_stage(re, im, cfg,
                                                           "full", True))
                parent_ms[name, "u8" if u8 else "f32"] = pms
            elif kernel is k2[0]:
                pms = cuda_ms(lambda: cp.curscan_packed_stage(
                    re, im, cfg, "full", True))
                packed_parent_ms[name, "u8" if u8 else "f32"] = pms
            bms, by = bound(cfg, t, u8)
            gs = t * cfg.full_size / 1e9
            gb = 2 * re.element_size() * gs
            kind = "u8" if u8 else "f32"
            line = (f"  {name}, T={t}, {kind}: kernel {ks:.3f} ms = "
                    f"{gs / ks * 1e3:.2f} Gsamp/s = {gb / ks * 1e3:.1f} GB/s "
                    f"of planes read once; bound {bms:.4f} ms ({by}), "
                    f"{bms / ks:.3f} of it")
            if ds is not None:
                what = ("matmul" if direct is spec.curscan_direct_batched
                        else "direct")
                line += f", {what} {ds:.3f} ms"
            chunks = (f" in {-(-t // rows)} calls of {rows} blocks"
                      if rows < t else "")
            if pms is not None:
                line += (f", parent form {pms:.3f} ms ({bms / pms:.3f} of "
                         f"the bound)")
            print(f"{line}, plain {ps:.3f} ms{chunks} = "
                  f"{gs / ps * 1e3:.2f} Gsamp/s")
            out[name, kind] = (ks, ds, ps, bms, by)
            del re, im
    from kspecanal_tpu_torch.scripts import (fft_stages, mixed_stages,
                                             packed_stages)
    print("== the mixed kernel's stage table (scripts.mixed_stages)")
    mixed_stages.main([])
    print("== the power-of-two kernel's stage table (scripts.fft_stages)")
    before = cc.fft_stage_launches
    rows = fft_stages.main(["main", "main-u8", "fmScan"])
    out["fft_stages"] = (rows, cc.fft_stage_launches - before, parent_ms,
                         cc.fft_parent_launches - parent_before)
    print("== K2's stage table (scripts.packed_stages)")
    before = cp.stage_launches
    rows = packed_stages.main(["qfs", "qfs-u8"])
    out["packed_stages"] = (rows, cp.stage_launches - before,
                            packed_parent_ms,
                            cp.parent_launches - packed_parent_before)
    return out


def phase_device_sources(gen):
    """devicesynth on the card against the CPU from the same start times,
    its tone purity and peaks, and devicenoise's planes."""
    from kspecanal_tpu_torch.io import sources as ts
    print("== device sources")
    tones = (1e6, 0.0, -1e6)
    t0 = torch.randint(0, 1 << 32, (64,), generator=gen, device="cuda",
                       dtype=torch.int64)
    card = ts.synth_batch(t0, tones, 2.4e6, 0.5, 16384, "cuda")
    cpu = ts.synth_batch(t0.cpu(), tones, 2.4e6, 0.5, 16384, "cpu")
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(card, cpu))
    bound = 1e-6 * 10 ** 0.05 * len(tones)
    print(f"  synth_batch card vs CPU, 64 x 16384: max abs {err:.3e} "
          f"(bound {bound:.3e}) {'PASS' if err <= bound else 'FAIL'}")
    check(err <= bound, "devicesynth card vs CPU")
    n = 16384
    re_, im_ = ts.DeviceSynthIQSource(seed=3, device="cuda").read(n)
    x = re_.astype(np.float64) + 1j * im_.astype(np.float64)
    spec_ = np.abs(np.fft.fftshift(np.fft.fft(x * np.hanning(n))))
    freqs = np.fft.fftshift(np.fft.fftfreq(n, 1 / 2.4e6)) + 92e6
    ratio = 20 * np.log10(spec_.max() / np.median(spec_))
    top3 = sorted(round(f / 1e6, 3) for f in freqs[np.argsort(spec_)[-3:]])
    ok = ratio >= 120.0 and top3 == [91.0, 92.0, 93.0]
    print(f"  devicesynth tone purity {ratio:.1f} dB, peaks {top3} MHz "
          f"{'PASS' if ok else 'FAIL'}")
    check(ok, "devicesynth purity >= 120 dB and peaks on 91/92/93 MHz")
    planes = ts.DeviceNoiseIQSource(seed=1).read_device_batch(1024, n)
    mean = planes[0].float().mean().item()
    ok = planes[0].dtype == torch.uint8 and abs(mean - 127.5) <= 0.5
    print(f"  devicenoise {planes[0].dtype} planes, mean {mean:.4f} "
          f"{'PASS' if ok else 'FAIL'}")
    check(ok, "devicenoise u8 planes of mean 127.5 +- 0.5")


def phase_highest(cc, gen):
    """K4 and K1's ablate keys at HIGHEST on the six-pass forensic builds:
    each of Kernel A's cut-offs at fft 2048 kaiser 50% AVG (T=256) and fft
    16384 (T=32), one launch, within TC_TOL of its plain version, 'full'
    after the layout map bitwise equal to the no-key ablate build; every
    kernel_ablate variant on Kernel A's ablate build (fft 2048, T=256, u8
    and f32) and on Kernel C's (fft 32768 on (256, 128), T=16, f32 and
    u8), one launch of its build, within TC_TOL of its plain version, u8
    bit-identical to decoded float32; then the no-key builds' worst bin
    against the float64 oracle beside HIGH's dispatcher at fft 2048 and
    32768.  Returns the worst max abs errors {"k4", "A", "C"}."""
    from kspecanal_tpu_torch.ops import cuda_tc as tc
    from kspecanal_tpu_torch.ops.spectrum import decode_u8
    from kspecanal_tpu_torch.scripts import threemult_smoke
    from kspecanal_tpu_torch.scripts.kernel_ablate import VARIANTS
    print(f"== K4 and the ablate keys at HIGHEST (six-pass forensic builds) "
          f"vs plain (per bin rtol, atol of the peak: {TC_TOL['HIGHEST']})")
    worst = {"k4": 0.0, "A": 0.0, "C": 0.0}
    lib, clib = tc.highest_library(), tc.tc_split_ablate_library(highest=True)
    for fft in (2048, 16384):
        n1 = fft // 128
        wb = tc.tc_windows_per_pass(n1, 15)
        for tm in (False, True):
            smem = lib.kspec_curscan_tc_smem(n1, wb, 2, int(tm))
            print(f"  Kernel A HIGHEST fft {fft} {'3M' if tm else '4M'}: "
                  f"{smem} B of shared memory a block, {wb} window(s) a "
                  f"pass, " + (f"{tc.tc_occupancy(lib, False, n1, wb, 2, tm)}"
                               f" block(s) an SM" if smem <= tc.TC_SMEM_LIMIT
                               else "over a block's limit: the wrapper "
                               "raises"))
    for tm in (False, True):
        print(f"  Kernel C HIGHEST (256, 128) {'3M' if tm else '4M'}: "
              f"{clib.kspec_curscan_tc_split_smem(256, 128, 2, int(tm))} B "
              f"of shared memory a block, "
              f"{clib.kspec_curscan_tc_split_mt(256, 128, 2, int(tm))} "
              f"m-tiles a block, "
              f"{tc.tc_split_occupancy(clib, False, 256, 128, 2, tm)} "
              f"block(s) an SM")
    for fft, t in ((2048, 256), (16384, 32)):
        cfg = class_cfg(cfg_of(fft), "HIGHEST")
        re_, im_ = noise(cfg, t, False, gen)
        groups = tc.tc_launch_groups(lib, re_, cfg, False)
        nokey = cc.curscan_fused_sublane(re_, im_, cfg, ablate=("concat",))
        for stage in cc.STAGES:
            before = tc.tc_stage_launches
            got = cc.curscan_stage_ablate(re_, im_, cfg, stage)
            launched = tc.tc_stage_launches - before
            want = tc.curscan_tc_stage_plain(re_, im_, cfg, stage)
            torch.cuda.synchronize()
            check(got.shape == (t, fft // 128, 128) and launched == 1
                  and bool(got.isfinite().all()),
                  "K4 HIGHEST cut-off: one launch, shape, finite")
            mx, sh = tc_share(got, want, cfg)
            line = (f"  K4 HIGHEST fft {fft} T={t} ({groups} window "
                    f"group(s)) {stage:5s}: max abs {mx:.3e}, {sh:.3f} of "
                    f"the tolerance")
            if stage == "full":
                same = torch.equal(cc.stage_layout_to_spectrum(got), nokey)
                line += (", after the layout map "
                         f"{'bitwise equal' if same else 'DIFFERS'} to the "
                         f"no-key ablate build")
                check(same, "K4 HIGHEST 'full' bitwise equal to the no-key "
                      "ablate build")
            print(f"{line} {'PASS' if sh <= 1 else 'FAIL'}")
            check(sh <= 1, f"K4 HIGHEST {stage} at fft {fft} vs plain")
            if fft == 2048:
                worst["k4"] = max(worst["k4"], mx)
        del re_, im_
    for kernel, fft, t, inputs in (("A", 2048, 256, (True, False)),
                                   ("C", 32768, 16, (False, True))):
        cfg = class_cfg(cfg_of(fft), "HIGHEST")
        split = (fft // 128, 128)
        counter = "tc_ablate_launches" if kernel == "A" else \
            "tc_split_ablate_launches"
        for u8 in inputs:
            re_, im_ = noise(cfg, t, u8, gen)
            for name, keys in VARIANTS[1:]:
                before = (getattr(tc, counter), cc.launches)
                got = cc.curscan_fused_sublane(re_, im_, cfg, ablate=keys)
                launched = (getattr(tc, counter) - before[0],
                            cc.launches - before[1])
                want = tc.curscan_tc_split_plain(re_, im_, cfg, None, split,
                                                 keys)
                torch.cuda.synchronize()
                mx, sh = tc_share(got, want, cfg)
                ok = (launched == (1, 0) and sh <= 1
                      and bool(got.isfinite().all()))
                line = (f"  Kernel {kernel} HIGHEST fft {fft} "
                        f"{'u8' if u8 else 'f32'} T={t} {name:34s} max abs "
                        f"{mx:.3e}, {sh:.3f} of the tolerance")
                if u8:
                    same = torch.equal(got, cc.curscan_fused_sublane(
                        decode_u8(re_), decode_u8(im_), cfg, ablate=keys))
                    line += (f", u8 vs f32 "
                             f"{'bit-identical' if same else 'DIFFER'}")
                    ok = ok and same
                print(f"{line} {'PASS' if ok else 'FAIL'}")
                check(ok, f"Kernel {kernel} HIGHEST ablate {name}: one "
                      f"launch of its build, within TC_TOL of plain")
                worst[kernel] = max(worst[kernel], mx)
            del re_, im_
    print(f"== the HIGHEST no-key ablate builds against the float64 oracle "
          f"beside HIGH's kernels (threemult_smoke's measure; bounds "
          f"{ORACLE_BOUND})")
    dev = torch.device("cuda")
    oracle = {}
    for fft, blocks in ((2048, 64), (32768, 16)):
        for prec in ("HIGHEST", "HIGH"):
            cfg = threemult_smoke.job_cfg(fft, 0.5, prec)

            def nokey(re_, im_, cfg_):
                return cc.curscan_fused_sublane(re_, im_, cfg_,
                                                ablate=("concat",))
            err = threemult_smoke.oracle_error(
                cfg, False, blocks, dev,
                **({"fn": nokey} if prec == "HIGHEST" else {}))
            oracle[fft, prec] = err
            what = ("the no-key ablate build" if prec == "HIGHEST"
                    else "the dispatcher")
            print(f"  fft{fft} 50% AVG {prec} f32, {blocks} blocks ({what}): "
                  f"max_rel_err {err:.3e}")
            check(err <= ORACLE_BOUND[prec],
                  f"fft {fft} {prec} within {ORACLE_BOUND[prec]:g}")
        check(oracle[fft, "HIGHEST"] <= oracle[fft, "HIGH"],
              f"fft {fft}: the six passes no worse than HIGH")
    return worst


def phase_ablate_class(cc, gen):
    """K1's ablate keys at HIGH and DEFAULT: every variant of the
    kernel-ablation script on Kernel A's ablate build (fft 2048, T=256: DEFAULT
    u8 and f32, HIGH f32) and on Kernel C's (fft 32768 on (256, 128), T=16:
    HIGH f32, DEFAULT u8), each one launch of its build and none of the
    FFT kernel's, within TC_TOL of its plain
    version; u8 bit-identical to decoded float32; no key and 'concat'
    bitwise equal to the production kernel in every mode.  Returns the
    worst max abs error of each build."""
    from kspecanal_tpu_torch.ops import cuda_tc as tc
    from kspecanal_tpu_torch.ops.spectrum import decode_u8
    from kspecanal_tpu_torch.scripts.kernel_ablate import VARIANTS
    print(f"== ablate variants at HIGH/DEFAULT (Kernels A and C's ablate "
          f"builds) vs plain (per bin rtol, atol of the peak: {TC_TOL})")
    worst = {"A": 0.0, "C": 0.0}
    for kernel, fft, t, cases in (
            ("A", 2048, 256, (("DEFAULT", True), ("DEFAULT", False),
                              ("HIGH", False))),
            ("C", 32768, 16, (("HIGH", False), ("DEFAULT", True)))):
        split = (fft // 128, 128)
        counter = "tc_ablate_launches" if kernel == "A" else \
            "tc_split_ablate_launches"

        def class_ablate(re_, im_, cfg, keys):
            if kernel == "A":
                return tc.curscan_tc(re_, im_, cfg, ablate=keys)
            return tc.curscan_tc_split(re_, im_, cfg, split=split,
                                       ablate=keys)

        def plain(re_, im_, cfg, keys):
            return tc.curscan_tc_split_plain(re_, im_, cfg, None, split, keys)

        for prec, u8 in cases:
            cfg = class_cfg(cfg_of(fft), prec)
            re_, im_ = noise(cfg, t, u8, gen)
            for name, keys in VARIANTS:
                before = (getattr(tc, counter), cc.launches)
                got = class_ablate(re_, im_, cfg, keys)
                launched = (getattr(tc, counter) - before[0],
                            cc.launches - before[1])
                want = plain(re_, im_, cfg, keys)
                torch.cuda.synchronize()
                mx, sh = tc_share(got, want, cfg)
                line = (f"  Kernel {kernel} fft {fft} {prec} "
                        f"{'u8' if u8 else 'f32'} T={t} {name:34s} max abs "
                        f"{mx:.3e}, {sh:.3f} of the tolerance")
                ok = (launched == (1, 0) and sh <= 1
                      and bool(got.isfinite().all()))
                if u8:
                    same = torch.equal(got, class_ablate(
                        decode_u8(re_), decode_u8(im_), cfg, keys))
                    line += (f", u8 vs f32 "
                             f"{'bit-identical' if same else 'DIFFER'}")
                    ok = ok and same
                print(f"{line} {'PASS' if ok else 'FAIL'}")
                check(ok, f"Kernel {kernel} ablate {name} at {prec}: one "
                      f"launch of its build, within TC_TOL of plain")
                worst[kernel] = max(worst[kernel], mx)
        for mode in MODES:
            prec = cases[0][0]
            cfg = class_cfg(cfg_of(fft, 0.5, mode), prec)
            re_, im_ = noise(cfg, t, False, gen)
            prod = (tc.curscan_tc(re_, im_, cfg) if kernel == "A" else
                    tc.curscan_tc_split(re_, im_, cfg, split=split))
            same = all(torch.equal(class_ablate(re_, im_, cfg, keys), prod)
                       for keys in ((), ("concat",)))
            print(f"  Kernel {kernel} ablate build, no key and 'concat', "
                  f"{prec} {mode}: {'bitwise equal' if same else 'DIFFER'} "
                  f"to the production kernel")
            check(same, f"Kernel {kernel} ablate build with no key == the "
                  f"production kernel ({mode})")
    return worst


class LogLines(logging.Handler):
    """Collects the package's log messages."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_device_sessions(cc, cli, tmp):
    """The forensics path's sessions through the entry point.  Returns the
    K1 launches."""
    log = LogLines()
    logging.getLogger("kspecanal_tpu_torch").addHandler(log)
    cfg = cfg_of()
    runs = [("devicesynth", "1024", 8192), ("devicenoise", "1024", 8192),
            ("synth", "128", 512)]
    print("== forensics sessions through kspecanal_tpu_torch.cli.main")
    seen = []
    orig = cc.curscan_fused_sublane

    def spy(re_, im_, cfg_, **kw):
        seen.append(re_.dtype)
        return orig(re_, im_, cfg_, **kw)

    launches = 0
    with mock.patch.object(cc, "curscan_fused_sublane", spy):
        for src, k, iters in runs:
            for profiled in ((False, True) if src != "synth" else (True,)):
                prof = os.path.join(tmp, f"prof_{src}")
                lvls = os.path.join(tmp, f"dev_lvls_{src}.bin")
                args = (MAIN_ARGS + ["tpuSource", src, "tpuCatchUp", k,
                                     "prgLoopCnt", str(iters), "tpuHeadless",
                                     "true", "saveSigLvls", lvls]
                        + (["tpuProfile", prof] if profiled else []))
                seen.clear()
                before, n_log = cc.launches, len(log.lines)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = cli.main(args)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                check(rc == 0, f"{src} session rc")
                n = cc.launches - before
                launches += n
                dtypes = sorted({str(d) for d in seen})
                want_dtype = ("torch.uint8" if src == "devicenoise"
                              else "torch.float32")
                busy = [m for m in log.lines[n_log:]
                        if re.search(r"device busy [0-9.]+% of", m)]
                line = (f"  {src} tpuCatchUp {k}, {iters} blocks"
                        f"{' + tpuProfile' if profiled else ''}: {dt:.3f} s, "
                        f"{iters * cfg.full_size / dt / 1e6:.2f} Msamp/s end "
                        f"to end, K1 launches {n} on {dtypes}")
                if profiled:
                    files = os.listdir(prof) if os.path.isdir(prof) else []
                    line += f", trace files {len(files)}, {busy}"
                    check(len(files) == 1, f"{src} wrote one trace")
                    check(len(busy) == 1, f"{src} logged its busy share")
                if src == "devicesynth":
                    peaks = avg_peaks(cfg, load_avg(lvls))
                    cell = cfg.sampling_rate / cfg.x_res
                    on = len(peaks) == 3 and all(
                        abs(p - w) <= cell for p, w in zip(peaks, PEAKS_HZ))
                    line += (f", peaks {[round(p / 1e6, 4) for p in peaks]} "
                             f"MHz {'PASS' if on else 'FAIL'}")
                print(line)
                if src == "devicesynth":
                    check(on, "devicesynth peaks on 91/92/93 MHz")
                check(n > 0 and dtypes == [want_dtype],
                      f"{src} session launched K1 on {want_dtype} planes")
    logging.getLogger("kspecanal_tpu_torch").removeHandler(log)
    return launches


def ablate_build_times(tc, prec, cases, launches):
    """Each ablate build with no stage removed ('concat') at fft 2048 (Kernel
    A) and 32768 (Kernel C, (256, 128)) on u8 planes at ``prec``: ms, its
    plain version's ms (in chunks), its bound; ``cases`` (kernel, fft, T),
    ``launches`` each build's launches over the scripts."""
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    out = {}
    for kernel, fft, t in cases:
        acfg = class_cfg(cfg_of(fft), prec)
        gen_ = torch.Generator(device="cuda").manual_seed(5)
        are, aim = noise(acfg, t, True, gen_)
        split = (fft // 128, 128)
        step = max(1, TC_PLAIN_FRAME_BYTES // (acfg.num_windows * fft * 8))

        def build_call(are=are, aim=aim, acfg=acfg, kernel=kernel,
                       split=split):
            if kernel == "A":
                return tc.curscan_tc(are, aim, acfg, ablate=("concat",))
            return tc.curscan_tc_split(are, aim, acfg, split=split,
                                       ablate=("concat",))
        ams = cuda_ms(build_call)
        aplain = cuda_ms(lambda: [tc.curscan_tc_split_plain(
            are[i:i + step], aim[i:i + step], acfg, None, split,
            ("concat",)) for i in range(0, t, step)], warm=1, reps=3)
        abms, aby, _ = tc_bound(acfg, t, True, split)
        print(f"  Kernel {kernel}'s {prec} ablate build, no stage removed, "
              f"fft {fft} u8 T={t}: {ams:.3f} ms, plain version "
              f"{aplain:.3f} ms, bound {abms:.4f} ms ({aby}), share "
              f"{abms / ams:.3f}")
        out[kernel] = {"launches": launches[kernel], "ms": ams,
                       "plain_ms": aplain, "bound_ms": abms,
                       "bound_by": aby}
        del are, aim
    return out


def phase_forensics(cc):
    """The forensics scripts on the card.  Returns the launches of K4's
    HIGHEST builds and of the direct kernel (the HIGHEST table's yardstick)
    over them, K4 HIGHEST 'full' and its plain version's ms at fft 2048
    T=4096 with the bound there, the DEFAULT form's row, and the ablate
    builds' rows at DEFAULT and HIGHEST."""
    from kspecanal_tpu_torch.scripts import kernel_ablate, roofline_r2, \
        session_ablate
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    from kspecanal_tpu_torch.ops import cuda_tc as tc
    print("== forensics scripts")
    cc.direct_launches = tc.tc_stage_launches = 0
    tc.tc_ablate_launches = tc.tc_split_ablate_launches = 0
    rows = roofline_r2.main(["--precision", "HIGHEST", "4096"])
    roofline_r2.main(["--precision", "HIGHEST", "--fft", "16384", "288"])
    launches, direct = tc.tc_stage_launches, cc.direct_launches
    kernel_ablate.main(["2048", "HIGHEST", "u8"])
    kernel_ablate.main(["2048", "HIGHEST", "f32"])
    h_launches = {"A": tc.tc_ablate_launches}
    kernel_ablate.main(["32768", "HIGHEST", "u8", "64", "128"])
    h_launches["C"] = tc.tc_split_ablate_launches
    session_ablate.main(["4096"])
    cfg = roofline_r2.stage_cfg(2048)
    step = max(1, TC_PLAIN_FRAME_BYTES // (cfg.num_windows * 2048 * 8))
    gen = torch.Generator(device="cuda").manual_seed(4)
    re_, im_ = noise(cfg, 4096, False, gen)
    plain = cuda_ms(lambda: [tc.curscan_tc_stage_plain(
        re_[i:i + step], im_[i:i + step], cfg, "full")
        for i in range(0, 4096, step)], warm=1, reps=3)
    bms, by, _ = tc_bound(cfg, 4096, False)
    print(f"  K4 HIGHEST 'full' (Kernel A's HIGHEST build) "
          f"{rows[4096]['full']:.3f} ms, plain version {plain:.3f} ms in "
          f"{-(-4096 // step)} calls, bound {bms:.4f} ms ({by}), share "
          f"{bms / rows[4096]['full']:.3f}; launches over the scripts: K4's "
          f"HIGHEST builds {launches}, the direct kernel {direct}, Kernel "
          f"A's HIGHEST ablate build {h_launches['A']}, Kernel C's "
          f"{h_launches['C']}")
    check(h_launches["A"] > 0 and h_launches["C"] > 0,
          "kernel_ablate at HIGHEST ran the HIGHEST ablate builds")
    highest = ablate_build_times(tc, "HIGHEST", (("A", 2048, 4096),
                                                 ("C", 32768, 64)),
                                 h_launches)
    # K4's class form: the JAX script's own table, DEFAULT at T=4096.
    tc.tc_stage_launches = 0
    crows = roofline_r2.main(["--precision", "DEFAULT", "4096"])
    class_launches = tc.tc_stage_launches
    ccfg = roofline_r2.stage_cfg(2048, "DEFAULT")
    cplain = cuda_ms(lambda: [tc.curscan_tc_stage_plain(
        re_[i:i + step], im_[i:i + step], ccfg, "full")
        for i in range(0, 4096, step)], warm=1, reps=3)
    cbms, cby, _ = tc_bound(ccfg, 4096, False)
    print(f"  K4 DEFAULT 'full' (Kernel A) {crows[4096]['full']:.3f} ms, "
          f"plain version {cplain:.3f} ms in {-(-4096 // step)} calls, bound "
          f"{cbms:.4f} ms ({cby}); Kernel A's cut-offs launched "
          f"{class_launches} times")
    hrows = roofline_r2.main(["--precision", "HIGH", "4096"])
    hcfg = roofline_r2.stage_cfg(2048, "HIGH")
    hplain = cuda_ms(lambda: [tc.curscan_tc_stage_plain(
        re_[i:i + step], im_[i:i + step], hcfg, "full")
        for i in range(0, 4096, step)], warm=1, reps=3)
    hbms, hby, _ = tc_bound(hcfg, 4096, False)
    print(f"  K4 HIGH 'full' (Kernel A) {hrows[4096]['full']:.3f} ms, plain "
          f"version {hplain:.3f} ms in {-(-4096 // step)} calls, bound "
          f"{hbms:.4f} ms ({hby})")
    # K1's ablate keys at the classes: the JAX script's own cell (DEFAULT
    # u8) and HIGH f32 on Kernel A, and Kernel C above fft 16384.
    tc.tc_ablate_launches = tc.tc_split_ablate_launches = 0
    fft0 = cc.launches
    kernel_ablate.main(["2048", "DEFAULT", "u8"])
    kernel_ablate.main(["2048", "HIGH", "f32"])
    a_launches = tc.tc_ablate_launches
    kernel_ablate.main(["32768", "DEFAULT", "u8", "64", "128"])
    c_launches = tc.tc_split_ablate_launches
    print(f"  kernel_ablate at HIGH/DEFAULT: Kernel A's ablate build "
          f"launched {a_launches} times, Kernel C's {c_launches}, the FFT "
          f"kernel {cc.launches - fft0}")
    check(a_launches > 0 and c_launches > 0 and cc.launches == fft0,
          "kernel_ablate at HIGH/DEFAULT ran the class kernels' ablate "
          "builds and never the FFT kernel")
    ablate = ablate_build_times(tc, "DEFAULT", (("A", 2048, 4096),
                                                ("C", 32768, 64)),
                                {"A": a_launches, "C": c_launches})
    return (launches, direct, {"launches": launches,
                               "ms": rows[4096]["full"], "plain_ms": plain,
                               "bound_ms": bms, "bound_by": by},
            {"launches": class_launches, "ms": crows[4096]["full"],
             "plain_ms": cplain, "bound_ms": cbms, "bound_by": cby},
            ablate, highest)


def phase_k4_class(cc, gen):
    """K4 at HIGH and DEFAULT: each of Kernel A's cut-offs (the forensic
    builds of ``cuda_tc.stage_library``) against its plain version within
    TC_TOL at fft 2048 kaiser 50% AVG (T=256) and fft 16384 (T=32: four
    window groups and their combine), one launch each, and 'full' after the
    layout map bitwise equal to Kernel A's production output.  Returns the
    worst max abs error at fft 2048."""
    from kspecanal_tpu_torch.ops import cuda_tc as tc
    print(f"== K4 at HIGH/DEFAULT (Kernel A's cut-offs) vs plain (per bin "
          f"rtol, atol of the peak: {TC_TOL})")
    worst = 0.0
    for prec in ("DEFAULT", "HIGH"):
        for fft, t in ((2048, 256), (16384, 32)):
            cfg = class_cfg(cfg_of(fft), prec)
            re_, im_ = noise(cfg, t, False, gen)
            prod = tc.curscan_tc(re_, im_, cfg)
            groups = tc.tc_launch_groups(tc._cuda_lib(re_.device), re_, cfg,
                                         False)
            for stage in cc.STAGES:
                before = tc.tc_stage_launches
                got = cc.curscan_stage_ablate(re_, im_, cfg, stage)
                launched = tc.tc_stage_launches - before
                want = tc.curscan_tc_stage_plain(re_, im_, cfg, stage)
                torch.cuda.synchronize()
                check(got.shape == (t, fft // 128, 128) and launched == 1
                      and bool(got.isfinite().all()),
                      "K4 class cut-off: one launch, shape, finite")
                mx, sh = tc_share(got, want, cfg)
                line = (f"  {prec} fft {fft} T={t} ({groups} window "
                        f"group(s)) {stage:5s}: max abs {mx:.3e}, {sh:.3f} "
                        f"of the tolerance")
                if stage == "full":
                    same = torch.equal(cc.stage_layout_to_spectrum(got), prod)
                    line += (", after the layout map "
                             f"{'bitwise equal' if same else 'DIFFERS'} to "
                             f"Kernel A's production output")
                print(f"{line} {'PASS' if sh <= 1 else 'FAIL'}")
                check(sh <= 1, f"K4 {prec} {stage} at fft {fft} vs plain")
                if stage == "full":
                    check(same, "K4 class 'full' bitwise equal to Kernel A")
                if fft == 2048:
                    worst = max(worst, mx)
    return worst


class NoisySynth:
    """The port's synth source plus seeded white noise (unit variance), so
    every bin's min curve moves from block to block."""

    def __init__(self, cfg, seed):
        from kspecanal_tpu_torch.io.sources import SynthIQSource
        self.inner = SynthIQSource(cfg.center_freq, cfg.sampling_rate,
                                   seed=seed)
        self.rng = np.random.default_rng(seed)

    def read(self, n):
        re, im = self.inner.read(n)
        return tuple((p + self.rng.standard_normal(n)).astype(np.float32)
                     for p in (re, im))

    def retune(self, center_freq, sample_rate, gain):
        return self.inner.retune(center_freq, sample_rate, gain)

    def close(self):
        pass


class Toggler:
    """A renderer without matplotlib that keeps each view's min curve and,
    from its second frame on, has ``apply_toggles`` turn b_data_min off,
    as a click on MinLvls does."""

    def __init__(self):
        self.mins = []

    def __call__(self, sess, view, peaks, iteration, timestamp_str):
        self.mins.append(np.array(view.min_lvls))

    def apply_toggles(self, cfg):
        import dataclasses
        if len(self.mins) >= 2:
            return dataclasses.replace(cfg, b_data_min=False)
        return cfg


def phase_toggles(cc, tmp):
    """The renderer's step-boundary toggles on the card: a Toggler in the
    serial, catch-up and replay zero-span sessions (fft 2048 kaiser 50%)
    and the fmScan serial and catch-up sessions; after the toggle the
    session's config has b_data_min off and every later view's min curve
    equals the second view's (the fold on the card stopped), while it
    moved before.  Returns the FFT kernel's launches."""
    import dataclasses
    from kspecanal_tpu_torch import session as sess_mod
    from kspecanal_tpu_torch.cli import parse_args
    print("== renderer toggles at step boundaries (b_data_min off after the "
          "second frame)")
    zs = cfg_of()
    fm = parse_args(FM_ARGS)[0]
    rec = os.path.join(tmp, "toggle.save")
    save = sess_mod.Session(
        dataclasses.replace(zs, prg_mode="ZEROSPANSAVE",
                            zero_span_save_file=rec),
        NoisySynth(zs, 30), device="cuda")
    check(sess_mod.run_zero_span_save(save, 6) == 6, "toggle recording")
    runs = [("zero-span serial", zs, dict(), 5, sess_mod.run_zero_span),
            ("zero-span catch-up 2", zs, dict(catch_up=2), 8,
             sess_mod.run_zero_span),
            ("zero-span replay", zs, dict(), 6, sess_mod.run_zero_span_play),
            ("fmScan serial", fm, dict(), 4, sess_mod.run_scan),
            ("fmScan catch-up 2", fm, dict(catch_up=2), 8,
             sess_mod.run_scan)]
    launches = 0
    for name, cfg, kw, n, run in runs:
        if run is sess_mod.run_zero_span_play:
            cfg = dataclasses.replace(cfg, prg_mode="ZEROSPANPLAY",
                                      zero_span_play_file=rec)
        r = Toggler()
        sess = sess_mod.Session(cfg, None if run is sess_mod.run_zero_span_play
                                else NoisySynth(cfg, 31), r, device="cuda",
                                **kw)
        before = cc.launches
        run(sess, n)
        torch.cuda.synchronize()
        k1 = cc.launches - before
        launches += k1
        frozen = all(np.array_equal(m, r.mins[1]) for m in r.mins[2:])
        moved = not np.array_equal(r.mins[0], r.mins[1])
        ok = (len(r.mins) >= 3 and frozen and moved
              and sess.cfg.b_data_min is False)
        print(f"  {name}: {len(r.mins)} frames, K1 launches {k1}, min curve "
              f"moved before the toggle {moved}, frozen after it {frozen} "
              f"{'PASS' if ok else 'FAIL'}")
        check(ok, f"{name}: min curve frozen after the toggle")
        check(k1 > 0 or run is sess_mod.run_zero_span_play,
              f"{name} launched K1")
    return launches


def phase_analyzer(cc, cp, spec, tmp):
    """The offline capture analyzer (``tools.main``) on the card, on a
    capture the port's ``scripts.make_fixture`` writes (1,024,000 samples
    at 92 MHz, the reference's capture length): fft 2048 (K1's FFT kernel)
    and fft 128 (K2), each with and without ``decimate 4``.  Each run
    launches its kernel (a CUDA tensor has no plain route), each of the
    four spectra agrees with the float64 plain chain on the same planes
    (BOUND), and without decimation the complex spectrum's three strongest
    bins sit on the synth's 91/92/93 MHz tones.  Returns the launches of
    K1 and K2."""
    from kspecanal_tpu_torch import tools
    from kspecanal_tpu_torch.config import SpecConfig
    from kspecanal_tpu_torch.io.sources import load_rtlsdr_capture
    from kspecanal_tpu_torch.scripts import make_fixture
    print(f"== offline analyzer (kspecanal_tpu_torch.tools) on the card "
          f"({BOUND}; plain chain in float64)")
    cap = os.path.join(tmp, "fixture.iq")
    make_fixture.make_capture(cap, 1_024_000, 92e6)
    re64, im64 = (torch.as_tensor(p, dtype=torch.float64)
                  for p in load_rtlsdr_capture(cap))
    k1 = k2 = 0
    for fft in (2048, 128):
        cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft,
                         window="WIN.HANNING").finalize()
        for dec in (None, 4):
            out = os.path.join(tmp, f"spectra_{fft}_{dec}.npz")
            before = (cc.launches, cp.launches)
            rc = tools.main([cap, "fftSize", str(fft), "out", out]
                            + (["decimate", str(dec)] if dec else []))
            torch.cuda.synchronize()
            n1, n2 = cc.launches - before[0], cp.launches - before[1]
            k1, k2 = k1 + n1, k2 + n2
            got = np.load(out)
            re, im = re64, im64
            if dec:
                n = len(re) // dec * dec
                re, im = (p[:n].reshape(-1, dec).sum(dim=1) for p in (re, im))
            t = len(re) // cfg.full_size
            re, im = (p[:t * cfg.full_size].reshape(t, -1).cuda()
                      for p in (re, im))
            zero = torch.zeros_like(re)
            planes = {"complex": (re, im), "real": (re, zero),
                      "imag": (im, zero),
                      "abs": (torch.sqrt(re ** 2 + im ** 2), zero)}
            worst, ok = 0.0, True
            for key, (a, b) in planes.items():
                want = spec.curscan_batched(a, b, cfg).mean(dim=0)
                have = torch.as_tensor(got[f"{cap}:{key}"]).cuda()
                if not want.any():    # the synth's I plane is all zero
                    ok = ok and not have.any()
                    continue
                mx, mrel, _, fine = spectra_error(have, want)
                worst, ok = max(worst, mrel), ok and fine and mrel < 1e-5
            line = (f"  fft {fft} decimate {dec}: {t} blocks, launches K1 "
                    f"{n1} K2 {n2}, worst max_rel {worst:.3e}")
            if not dec:
                freqs = spec.fft_freqs(cfg)
                top = sorted(freqs[np.argsort(got[f"{cap}:complex"])[-3:]])
                bin_hz = cfg.sampling_rate / fft
                on = all(abs(f - w) <= bin_hz for f, w in zip(top, PEAKS_HZ))
                line += f", peaks {[round(float(f) / 1e6, 4) for f in top]} MHz"
                ok = ok and on
            print(f"{line} {'PASS' if ok else 'FAIL'}")
            check(rc == 0 and int(got[f"{cap}:num_blocks"]) == t,
                  f"analyzer fft {fft} decimate {dec} ran")
            check((n1 if fft == 2048 else n2) >= 4,
                  f"analyzer fft {fft} launched its kernel")
            check(ok, f"analyzer fft {fft} decimate {dec} vs plain, peaks")
    return k1, k2


def phase_png(cli, tmp):
    """``tpuRenderer png:<dir>`` through ``cli.main``, where matplotlib is
    installed (the renderer needs it); says which case applied."""
    import importlib.util
    if importlib.util.find_spec("matplotlib") is None:
        print("== png: session: matplotlib is not installed here; the "
              "session was not run (tests/test_torch_gui.py runs it on the "
              "CPU)")
        return
    out = os.path.join(tmp, "Frames")
    rc = cli.main(MAIN_ARGS + ["tpuSource", "synth", "prgLoopCnt", "2",
                               "tpuRenderer", f"png:{out}"])
    frames = sorted(os.listdir(out))
    print(f"== png: session: matplotlib present; rc {rc}, frames {frames}")
    check(rc == 0 and len(frames) == 2, "png: session wrote two frames")


# The mesh phase's full-width cases (scripts/dryrun_multichip.rank_main):
# BASELINE config 5 (fft 16384, kaiser, 90%: full_size 131072, 71 windows,
# halo 16384) time- and fft-sharded, the zero-span main cell's stream at
# T=4096, and the fmScan and quickFullScan presets band-sharded.
CONFIG5 = {"fft": 16384, "nono": 0.1, "window": "WIN.KAISER"}
MESH_CASES = {
    "stream": [{"fft": 2048, "nono": 0.5, "window": "WIN.KAISER",
                "mode": "AVG", "blocks": 4096, "u8": False}],
    "time": [dict(CONFIG5, mode=m) for m in MODES],
    "fft": [dict(CONFIG5, mode=m) for m in ("AVG", "MAX")],
    "band": ["FMSCAN", "QUICKFULLSCAN"],
}


def mesh_world(s, backend, share, gpu, tmp):
    """One world of the mesh phase: every full-width case, and at two
    ranks the two CLI sessions; prints its lines and checks its results.
    Returns rank 0's result."""
    from kspecanal_tpu_torch.cli import parse_args
    from kspecanal_tpu_torch.parallel.spawn import run_world
    from kspecanal_tpu_torch.scripts import dryrun_multichip
    from kspecanal_tpu_torch.session import make_plan_cached
    zs = ["zeroSpan", "centerFreq", "92e6", "window", "kaiser",
          "curScanNonOverlap", "0.1", "fftSize", "16384", "tpuLogIter",
          "false", "tpuMeshTime", "2", "tpuSource", "synth", "prgLoopCnt",
          "4", "tpuHeadless", "true", "saveSigLvls",
          os.path.join(tmp, f"mesh_zs_{backend}.bin")]
    fm = FM_ARGS + ["tpuMeshBand", "2", "tpuSource", "synth", "prgLoopCnt",
                    "2", "tpuHeadless", "true", "saveSigLvls",
                    os.path.join(tmp, f"mesh_fm_{backend}.bin")]
    args = dict(MESH_CASES, band_mesh=[1, s],
                rates={"fft": 2048, "blocks": [1024 * s, 4096]},
                cli=[[zs, 2, 1], [fm, 1, 2]] if s == 2 else [])
    how = ("ranks sharing cuda:0 over gloo, every collective copied "
           "through the host" if share else "one rank a card")
    t0 = time.perf_counter()
    res = run_world(dryrun_multichip.TARGET, s, args, backend=backend,
                    device_type="cuda", share_card=share, timeout_s=400)
    wall = time.perf_counter() - t0
    print(f"  world of {s} on {backend} ({how}): {wall:.1f} s wall")
    for r in res:
        k1 = sum(v[0] for v in r["launches"].values())
        k2 = sum(v[1] for v in r["launches"].values())
        print(f"    rank {r['rank']} on {r['device']} ({r['backend']}): "
              f"{r['seconds']:.1f} s, launches K1 {k1} K2 {k2}")
        check(k1 > 0 and k2 > 0, f"world {s} {backend} rank {r['rank']} "
              f"launched K1 and K2")
    root = res[0]
    for name, share_ in root["shares"].items():
        print(f"    {name}: {share_:.3f} of the bound, max abs err "
              f"{root['max_abs_err'][name]:.3e}")
    weak, strong = root["rates"]
    print(f"    stream fft 2048 rates ({gpu}): weak "
          f"T={1024 * s} {weak / 1e6:.1f} Msamp/s, strong T=4096 "
          f"{strong / 1e6:.1f} Msamp/s" + ("; ranks share one card: not "
                                            "scaling figures" if share
                                            else ""))
    for argv, _, _ in args["cli"]:
        cfg = parse_args(argv[:-2])[0]
        avg = load_avg(argv[-1])
        if cfg.prg_mode == "SCAN":
            plan = make_plan_cached(cfg)
            peaks, cell = scan_peaks(cfg, plan, avg)
            on = len(peaks) == 3 and all(
                abs(p - round(p / 1e6) * 1e6) <= cell for p in peaks)
        else:
            peaks, cell = avg_peaks(cfg, avg), cfg.sampling_rate / cfg.x_res
            on = len(peaks) == 3 and all(abs(p - w) <= cell
                                         for p, w in zip(peaks, PEAKS_HZ))
        print(f"    cli.main {' '.join(argv[:-2])}: peaks "
              f"{[round(p / 1e6, 4) for p in peaks]} MHz "
              f"{'PASS' if on else 'FAIL'}")
        check(on, f"mesh session {argv[0]} peaks")
    return root


def phase_mesh(gpu, tmp):
    """The sharded paths on torch.distributed: a world of one rank on NCCL,
    worlds of 2 and 4 ranks sharing the card over gloo, and NCCL worlds of
    2 and 4 where there are as many cards."""
    print(f"== mesh: the sharded paths over torch.distributed ({gpu}; "
          f"{torch.cuda.device_count()} card(s))")
    worlds = [(1, "nccl", False), (2, "gloo", True), (4, "gloo", True)]
    worlds += [(s, "nccl", False) for s in (2, 4)
               if torch.cuda.device_count() >= s]
    return {(s, b): mesh_world(s, b, share, gpu, tmp)
            for s, b, share in worlds}


def class_cfg(cfg, prec):
    import dataclasses
    return dataclasses.replace(cfg, tpu_precision=prec)


def tc_share(got, want, cfg):
    """(max abs error, share of TC_TOL) of a tensor-core kernel's output
    against its plain version's."""
    from kspecanal_tpu_torch.ops import cuda_tc
    rtol, atol = TC_TOL[cuda_tc.precision_class(cfg)]
    err = (got - want).abs()
    share = (err / (rtol * want.abs() + atol * want.abs().max())).max()
    return err.max().item(), share.item()


def tc_compare(kernel, plain, cfg, re, im, counter):
    """One tensor-core kernel call against its plain version on the same
    planes: one launch, finite, within TC_TOL.  Returns (max abs error,
    share of the tolerance)."""
    from kspecanal_tpu_torch.ops import cuda_tc
    before = getattr(cuda_tc, counter)
    got = kernel(re, im, cfg)
    launched = getattr(cuda_tc, counter) - before
    want = plain(re, im, cfg)
    torch.cuda.synchronize()
    check(launched == 1 and bool(got.isfinite().all()),
          f"{counter}: one launch, finite output")
    return tc_share(got, want, cfg)


def phase_precision(cc, cp, spec, cli, gen, gpu, tmp):
    """The HIGH and DEFAULT classes: the tensor-core kernels against their
    plain versions at every instantiation, the classes against the float64
    oracle at full size (``scripts.threemult_smoke`` and the scan presets),
    their times beside the FFT kernels at HIGHEST and the plain versions
    (each timed output held to the plain version's too: the main path's
    shapes, where Kernel A runs one window group a block), and sessions
    through ``cli.main``.  Returns the kernels' errors at the main cells'
    shapes, times and launches on the sessions."""
    from kspecanal_tpu_torch.cli import parse_args
    from kspecanal_tpu_torch.ops import cuda_tc as tc
    from kspecanal_tpu_torch.scripts import threemult_smoke
    from kspecanal_tpu_torch.session import make_plan_cached
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    print(f"== precision classes: the tensor-core kernels vs plain "
          f"(per bin rtol, atol of the peak: {TC_TOL})")
    # T=32 runs Kernel A's window groups and their combine, T=1024 (the
    # sessions' catch-up) one group a block, written straight to the output;
    # one and two windows a block the passes of 1 and 2 m-tiles; fft 10240
    # and 16384 stage 1 by m-tiles (F1 in shared memory, in L2) and at 3M
    # HIGH by strips, fft 16384 3M HIGH folding in device memory.
    for base, t in ((cfg_of(2048, 0.5), 32), (cfg_of(2048, 0.5), 1024),
                    (cfg_of(16384, 0.1, "AVG", "WIN.ONES"), 2),
                    (cfg_of(1280, 0.25), 8),
                    (cfg_of(2048, 1.0, mult=1), 8),
                    (cfg_of(2048, 1.0, mult=2), 8),
                    (cfg_of(10240, 0.1), 2)):
        for prec in ("DEFAULT", "HIGH"):
            for form in ("force3m", "no3m"):
                for u8 in (False, True):
                    worst = mx = 0.0
                    for mode in MODES:
                        cfg = class_cfg(cfg_of(base.fft_size,
                                               base.cur_scan_non_overlap,
                                               mode, base.window,
                                               base.fft2full_mult4less),
                                        prec)
                        re, im = noise(cfg, t, u8, gen)
                        e, sh = tc_compare(
                            lambda a, b, c: tc.curscan_tc(a, b, c, form),
                            lambda a, b, c: tc.curscan_tc_plain(a, b, c,
                                                                form),
                            cfg, re, im, "tc_launches")
                        mx, worst = max(mx, e), max(worst, sh)
                        if u8:
                            check(torch.equal(
                                tc.curscan_tc(re, im, cfg, form),
                                tc.curscan_tc(spec.decode_u8(re),
                                              spec.decode_u8(im), cfg,
                                              form)),
                                "Kernel A u8 bit-identical to decoded f32")
                    print(f"  Kernel A fft {base.fft_size} ovl "
                          f"{1 - base.cur_scan_non_overlap:.1f} "
                          f"{base.num_windows} windows {prec} "
                          f"{'3M' if form == 'force3m' else '4M'} "
                          f"{'u8' if u8 else 'f32'}, T={t}, 4 modes: max abs "
                          f"{mx:.3e}, {worst:.3f} of the tolerance"
                          f"{', u8 bit-identical' if u8 else ''} "
                          f"{'PASS' if worst <= 1 else 'FAIL'}")
                    check(worst <= 1, "Kernel A vs plain")
    # Every Kernel B instantiation: k-chunks 1 (fft 8), 2 (32), 4 (64) and 8
    # (128; at HIGH the table in shared memory), each fold, both classes.
    for fft, nono, window, t, mult in ((64, 0.1, "WIN.ONES", 256, 8),
                                       (128, 0.5, "WIN.KAISER", 64, 8),
                                       (8, 0.5, "WIN.HANNING", 64, 32),
                                       (32, 0.1, "WIN.ONES", 64, 8)):
        for prec in ("DEFAULT", "HIGH"):
            for u8 in (False, True):
                worst = mx = 0.0
                for mode in MODES:
                    cfg = class_cfg(cfg_of(fft, nono, mode, window, mult),
                                    prec)
                    re, im = noise(cfg, t, u8, gen)
                    e, sh = tc_compare(tc.curscan_packed_tc,
                                       tc.curscan_packed_tc_plain, cfg, re,
                                       im, "packed_tc_launches")
                    mx, worst = max(mx, e), max(worst, sh)
                    if u8:
                        check(torch.equal(
                            tc.curscan_packed_tc(re, im, cfg),
                            tc.curscan_packed_tc(spec.decode_u8(re),
                                                 spec.decode_u8(im), cfg)),
                            "Kernel B u8 bit-identical to decoded f32")
                print(f"  Kernel B fft {fft} ovl {1 - nono:.1f} {prec} 4M "
                      f"{'u8' if u8 else 'f32'}, T={t}, 4 modes: max abs "
                      f"{mx:.3e}, {worst:.3f} of the tolerance "
                      f"{'PASS' if worst <= 1 else 'FAIL'}")
                check(worst <= 1, "Kernel B vs plain")

    print(f"== precision classes against the float64 oracle (worst bin of "
          f"|got - oracle| / (|oracle| + 1e-6); bounds {ORACLE_BOUND})")
    rows = threemult_smoke.main(["--blocks", "64"])
    dev = torch.device("cuda")
    for name, fft, nono, window, u8, prec, blocks in (
            ("fmScan f32", 16384, 0.1, "WIN.ONES", False, "DEFAULT", 16),
            ("fmScan u8", 16384, 0.1, "WIN.ONES", True, "DEFAULT", 16),
            ("quickFullScan f32", 64, 0.1, "WIN.ONES", False, "DEFAULT", 256),
            ("quickFullScan u8", 64, 0.1, "WIN.ONES", True, "DEFAULT", 256),
            ("quickFullScan HIGH f32", 64, 0.1, "WIN.ONES", False, "HIGH",
             256),
            ("quickFullScan HIGH u8", 64, 0.1, "WIN.ONES", True, "HIGH",
             256)):
        cfg = threemult_smoke.job_cfg(fft, nono, prec, window)
        rows[name] = {"max_rel_err": threemult_smoke.oracle_error(
            cfg, u8, blocks, dev), "precision": prec}
        print(f"  {name} {prec}, {blocks} blocks: max_rel_err "
              f"{rows[name]['max_rel_err']:.3e}")
    for job in threemult_smoke.JOBS:
        rows[job.name]["precision"] = job.precision
    for name, row in rows.items():
        lim = ORACLE_BOUND.get(row["precision"], 5e-5)
        check(row["max_rel_err"] <= lim,
              f"{name}: {row['max_rel_err']:.3e} within {lim:g}")

    print(f"== precision classes: times (CUDA events, 3 warm-ups, median of "
          f"10) [{gpu}], each output against the plain version's")
    times = {}
    errs = {"tc": 0.0, "packed_tc": 0.0}
    for name, base, t, dtypes, precs in (
            ("zero-span fft 2048 kaiser 50%", cfg_of(), 4096, (False, True),
             ("DEFAULT", "HIGH")),
            ("fmScan fft 16384 ones 90%", cfg_of(16384, 0.1, "AVG",
                                                  "WIN.ONES"), 288,
             (False, True), ("DEFAULT",)),
            ("lane kernel's cell fft 16384 kaiser 50%", cfg_of(16384), 288,
             (False,), ("DEFAULT", "HIGH")),
            ("quickFullScan fft 64 ones 90%", cfg_of(64, 0.1, "AVG",
                                                      "WIN.ONES"), 19616,
             (False, True), ("DEFAULT", "HIGH")),
            ("quickFullScan serial sweep fft 64 ones 90%",
             cfg_of(64, 0.1, "AVG", "WIN.ONES"), 1226, (False,),
             ("DEFAULT",))):
        for prec in precs:
            cfg = class_cfg(base, prec)
            kernel, plain = ((tc.curscan_packed_tc, tc.curscan_packed_tc_plain)
                             if cfg.fft_size <= 128 else
                             (tc.curscan_tc, tc.curscan_tc_plain))
            highest = cp.curscan_fused_packed if cfg.fft_size <= 128 \
                else cc.curscan_fused_sublane
            for u8 in dtypes:
                re, im = noise(cfg, t, u8, gen)
                rows_ = max(1, min(t, TC_PLAIN_FRAME_BYTES
                                   // (cfg.num_windows * cfg.fft_size * 8)))

                def chunks():
                    return [plain(re[i:i + rows_], im[i:i + rows_], cfg)
                            for i in range(0, t, rows_)]
                got = kernel(re, im, cfg)
                e, sh = tc_share(got, torch.cat(chunks()), cfg)
                check(bool(got.isfinite().all()) and sh <= 1,
                      f"{name} {prec}: kernel within TC_TOL of plain")
                key = "tc" if cfg.fft_size > 128 else "packed_tc"
                if t in (4096, 19616):      # the rows of the kernels line
                    errs[key] = max(errs[key], e)
                del got
                ks = cuda_ms(lambda: kernel(re, im, cfg))
                fs = cuda_ms(lambda: highest(re, im, base))
                ps = cuda_ms(chunks, warm=1, reps=3)
                bms, by, (fft_ms, fft_by) = tc_bound(cfg, t, u8)
                kind = "u8" if u8 else "f32"
                gs = t * cfg.full_size / 1e9
                print(f"  {name} {prec} {kind}, T={t}: vs plain max abs "
                      f"{e:.3e}, {sh:.3f} of the tolerance; kernel "
                      f"{ks:.3f} ms = "
                      f"{gs / ks * 1e3:.2f} Gsamp/s; bound {bms:.4f} ms "
                      f"({by}), {bms / ks:.3f} of it (FFT-flops bound "
                      f"{fft_ms:.4f} ms, {fft_by}); FFT kernel at HIGHEST "
                      f"{fs:.3f} ms; plain version {ps:.3f} ms"
                      + (f" in {-(-t // rows_)} calls of {rows_} blocks"
                         if rows_ < t else ""))
                times[name, prec, kind] = (ks, ps, bms, by, fs)
                del re, im

    from kspecanal_tpu_torch.scripts import packed_tc_stages
    print("== Kernel B's stage table (scripts.packed_tc_stages)")
    packed_tc_stages.main([])

    print("== precision classes: sessions through kspecanal_tpu_torch.cli."
          "main at tpuPrecision DEFAULT (and HIGH)")
    zs_cfg0 = cfg_of()
    cap = os.path.join(tmp, "class_capture.iq")
    write_capture(cap, zs_cfg0, 64 * zs_cfg0.full_size, seed=17)
    fm_cfg = parse_args(FM_ARGS)[0]
    fm_cap = os.path.join(tmp, "class_fm_capture.iq")
    write_scan_capture(fm_cap, fm_cfg, make_plan_cached(fm_cfg), 2, seed=18)
    dflt = ["tpuPrecision", "DEFAULT"]
    runs = [
        ("zero-span devicesynth catch-up", "zs", MAIN_ARGS + dflt + [
            "tpuSource", "devicesynth", "tpuCatchUp", "1024", "prgLoopCnt",
            "4096"]),
        ("zero-span devicesynth catch-up, HIGH", "zs", MAIN_ARGS + [
            "tpuPrecision", "HIGH", "tpuSource", "devicesynth", "tpuCatchUp",
            "1024", "prgLoopCnt", "4096"]),
        ("zero-span devicenoise (u8) catch-up", "noise", MAIN_ARGS + dflt + [
            "tpuSource", "devicenoise", "tpuCatchUp", "1024", "prgLoopCnt",
            "4096"]),
        ("zero-span u8 capture file", "zs", MAIN_ARGS + dflt + [
            "tpuSource", f"file:{cap}", "tpuCatchUp", "16", "prgLoopCnt",
            "64"]),
        ("fmScan catch-up", "scan", FM_ARGS + dflt + [
            "tpuSource", "synth", "prgLoopCnt", "8", "tpuCatchUp", "8"]),
        ("fmScan u8 file (4M)", "scan", FM_ARGS + dflt + [
            "tpuSource", f"file:{fm_cap}", "prgLoopCnt", "2"]),
        ("fmScan kaiser 50% (the lane kernel's cell)", "scan",
         LANE_CELL_ARGS + dflt + ["tpuSource", "synth", "prgLoopCnt", "2"]),
        ("quickFullScan serial", "scan", QFS_ARGS + dflt + [
            "tpuSource", "synth", "prgLoopCnt", "2"]),
    ]
    launches = {"tc": 0, "packed_tc": 0}
    for i, (name, kind, args) in enumerate(runs):
        cfg = parse_args(args)[0]
        lvls = os.path.join(tmp, f"class_lvls_{i}.bin")
        tc.tc_launches = tc.packed_tc_launches = 0
        cc.launches = cp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(args + ["tpuHeadless", "true", "saveSigLvls", lvls])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        a, b = tc.tc_launches, tc.packed_tc_launches
        check(rc == 0, f"{name} session rc")
        check(cc.launches == 0 and cp.launches == 0,
              f"{name} launched no FFT kernel")
        avg = load_avg(lvls)
        if kind == "scan":
            plan = make_plan_cached(cfg)
            peaks, cell = scan_peaks(cfg, plan, avg)
            on = len(peaks) == 3 and all(
                abs(p - round(p / 1e6) * 1e6) <= cell for p in peaks)
            ok_shape = avg.shape == (plan.total_entries,)
        else:
            peaks, cell = avg_peaks(cfg, avg), cfg.sampling_rate / cfg.x_res
            on = len(peaks) == 3 and all(abs(p - w) <= cell
                                         for p, w in zip(peaks, PEAKS_HZ))
            ok_shape = avg.shape == (cfg.fft_size,)
        print(f"  {name}: {cfg.prg_loop_cnt} iterations in {dt:.3f} s, "
              f"launches Kernel A {a} Kernel B {b}"
              + ("" if kind == "noise" else
                 f", peaks {[round(p / 1e6, 4) for p in peaks]} MHz "
                 f"{'PASS' if on else 'FAIL'}"))
        check(ok_shape and not np.isnan(avg).any(), f"{name} average")
        check((b if cfg.fft_size <= 128 else a) > 0,
              f"{name} launched its tensor-core kernel")
        if kind != "noise":
            check(on, f"{name} peaks on the synth tones")
        launches["tc"] += a
        launches["packed_tc"] += b
    # Release the plain versions' gigabytes before the mesh phase's ranks.
    torch.cuda.empty_cache()
    return errs, times, launches


# Kernel C's cells against its plain version: K3 off the 128 grid (one
# block: 2050 = 50 x 41 and 3000 = 60 x 50 with 4 m-tiles a block at
# DEFAULT, 10000 = 100 x 100; 39800 = 200 x 199 with odd n2; 131100 = 380 x
# 345, above 131072), the grid above fft 16384 (32768 and 131072 on the
# sublane split n/128 x 128) at 50% and 90%, and fft 65536 at 50% (256 x
# 256 on float32, 512 x 128 on u8 planes at DEFAULT).
SPLIT_CELLS = ((2050, (0.5, 0.1)), (3000, (0.5, 0.1)), (10000, (0.5, 0.1)),
               (39800, (0.5, 0.1)), (131100, (0.5, 0.1)),
               (32768, (0.5, 0.1)), (131072, (0.5, 0.1)), (65536, (0.5,)))


def phase_split(cc, spec, cli, gen, gpu, tmp):
    """Kernel C, the tensor-core two-stage DFT on any split (K3 off the 128
    grid, the grid above fft 16384, at HIGH and DEFAULT): against its plain
    version at every class x form x input x mode of ``SPLIT_CELLS``, u8
    bit-identical to decoded float32 on the same split; the classes against
    the float64 oracle at fft 3000, 10000, 32768 and 65536 through the
    dispatcher (the table of ``scripts.threemult_smoke``, extended); its
    times at the Motivation cells beside the FFT kernel at HIGHEST and the
    plain version (each output held to the plain version's); sessions
    through ``cli.main``, each launching Kernel C and no FFT kernel, on the
    split the JAX dispatcher takes.  Returns its errors, times and launches
    (by the TPU kernel it stands in for: K3's lane split, K1's sublane
    split)."""
    from kspecanal_tpu_torch.cli import parse_args
    from kspecanal_tpu_torch.ops import cuda_tc as tc
    from kspecanal_tpu_torch.scripts import threemult_smoke
    from kspecanal_tpu_torch.scripts.tc_split_stages import torch_fft_chain
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    print(f"== Kernel C (csrc/curscan_tc_split.cu) vs plain (per bin rtol, "
          f"atol of the peak: {TC_TOL})")
    for fft, nonos in SPLIT_CELLS:
        for nono in nonos:
            t = 4 if fft <= 16384 else 2
            for prec in ("DEFAULT", "HIGH"):
                for form in ("force3m", "no3m"):
                    for u8 in (False, True):
                        worst = mx = 0.0
                        for mode in MODES:
                            cfg = class_cfg(cfg_of(fft, nono, mode), prec)
                            split = cc.tc_split(cfg, u8)
                            re, im = noise(cfg, t, u8, gen)
                            e, sh = tc_compare(
                                lambda a, b, c: tc.curscan_tc_split(a, b, c,
                                                                    form),
                                lambda a, b, c: tc.curscan_tc_split_plain(
                                    a, b, c, form),
                                cfg, re, im, "tc_split_launches")
                            mx, worst = max(mx, e), max(worst, sh)
                            if u8:
                                check(torch.equal(
                                    tc.curscan_tc_split(re, im, cfg, form),
                                    tc.curscan_tc_split(
                                        spec.decode_u8(re),
                                        spec.decode_u8(im), cfg, form,
                                        split)),
                                    "Kernel C u8 bit-identical to decoded "
                                    "f32")
                        print(f"  Kernel C fft {fft} ({split[0]} x "
                              f"{split[1]}) ovl {1 - nono:.1f} "
                              f"{cfg.num_windows} windows {prec} "
                              f"{'3M' if form == 'force3m' else '4M'} "
                              f"{'u8' if u8 else 'f32'}, T={t}, 4 modes: max "
                              f"abs {mx:.3e}, {worst:.3f} of the tolerance"
                              f"{', u8 bit-identical' if u8 else ''} "
                              f"{'PASS' if worst <= 1 else 'FAIL'}")
                        check(worst <= 1, "Kernel C vs plain")

    print(f"== Kernel C's classes against the float64 oracle through the "
          f"dispatcher (threemult_smoke's measure; bounds {ORACLE_BOUND})")
    dev = torch.device("cuda")
    for fft, nono, prec, u8, blocks in (
            (3000, 0.5, "DEFAULT", False, 64),
            (3000, 0.5, "DEFAULT", True, 64), (3000, 0.1, "DEFAULT", True, 64),
            (3000, 0.5, "HIGH", False, 64), (10000, 0.5, "DEFAULT", False, 64),
            (10000, 0.5, "HIGH", False, 64),
            (10000, 0.1, "DEFAULT", False, 64),
            (32768, 0.5, "HIGH", False, 16), (32768, 0.5, "DEFAULT", True, 16),
            (32768, 0.1, "DEFAULT", False, 16),
            (65536, 0.5, "DEFAULT", False, 16),
            (65536, 0.5, "DEFAULT", True, 16),
            (65536, 0.5, "HIGH", False, 16)):
        cfg = threemult_smoke.job_cfg(fft, nono, prec)
        before = tc.tc_split_launches
        err = threemult_smoke.oracle_error(cfg, u8, blocks, dev)
        split = cc.tc_split(cfg, u8)
        print(f"  fft{fft} {1 - nono:.0%} {prec} {'u8' if u8 else 'f32'} "
              f"({threemult_smoke.route(cfg)}, {split[0]} x {split[1]}), "
              f"{blocks} blocks: max_rel_err {err:.3e}")
        check(tc.tc_split_launches > before and err <= ORACLE_BOUND[prec],
              f"fft {fft} {prec}: Kernel C within {ORACLE_BOUND[prec]:g}")

    print(f"== Kernel C: times (CUDA events, 3 warm-ups, median of 10) "
          f"[{gpu}], each output against the plain version's")
    from kspecanal_tpu_torch.ops import _build
    lib = _build.load()
    times, errs = {}, {}
    for name, base, t, cases in (
            ("fft 3000 kaiser 50%", cfg_of(3000), 4096,
             (("DEFAULT", False), ("DEFAULT", True), ("HIGH", False))),
            ("fft 3000 kaiser 90%", cfg_of(3000, 0.1), 4096,
             (("DEFAULT", False), ("HIGH", False))),
            ("fft 10000 kaiser 50%", cfg_of(10000), 4096,
             (("DEFAULT", False), ("HIGH", False))),
            ("fft 39800 kaiser 50%", cfg_of(39800), 64,
             (("DEFAULT", False), ("HIGH", False))),
            ("fft 65536 kaiser 50%", cfg_of(65536), 64,
             (("DEFAULT", False), ("DEFAULT", True), ("HIGH", False))),
            ("fft 32768 kaiser 90%", cfg_of(32768, 0.1), 64,
             (("DEFAULT", False), ("HIGH", False)))):
        for prec, u8 in cases:
            cfg = class_cfg(base, prec)
            split = cc.tc_split(cfg, u8)
            re, im = noise(cfg, t, u8, gen)
            rows_ = max(1, min(t, TC_PLAIN_FRAME_BYTES
                               // (cfg.num_windows * cfg.fft_size * 8)))

            def chunks():
                return [tc.curscan_tc_split_plain(re[i:i + rows_],
                                                  im[i:i + rows_], cfg)
                        for i in range(0, t, rows_)]
            got = tc.curscan_tc_split(re, im, cfg)
            e, sh = tc_share(got, torch.cat(chunks()), cfg)
            check(bool(got.isfinite().all()) and sh <= 1,
                  f"{name} {prec}: Kernel C within TC_TOL of plain")
            del got
            ks = cuda_ms(lambda: tc.curscan_tc_split(re, im, cfg))
            fs = cuda_ms(lambda: cc.curscan_fused_sublane(re, im, base))
            chain = cuda_ms(lambda: torch_fft_chain(re, im, base), warm=1,
                            reps=3)
            ps = cuda_ms(chunks, warm=1, reps=3)
            stages = {s: cuda_ms(lambda s=s: tc.curscan_tc_split_stage(
                re, im, cfg, s)) for s in tc.TC_SPLIT_STAGES[:-1]}
            stages["full"] = ks
            high = prec == "HIGH"
            smem = lib.kspec_curscan_tc_split_smem(*split, int(high), 0)
            per_sm = tc.tc_split_occupancy(lib, u8, *split, high, False)
            groups = tc.tc_split_launch_groups(lib, re, cfg, False, split)
            bms, by, (fft_ms, fft_by) = tc_bound(cfg, t, u8, split)
            kind = "u8" if u8 else "f32"
            prev, parts = 0.0, []
            for stage, v in stages.items():
                parts.append(f"{stage} +{v - prev:.3f}")
                prev = v
            print(f"  {name} {prec} {kind} ({split[0]} x {split[1]}, "
                  f"{cfg.num_windows} windows), T={t}: vs plain max abs "
                  f"{e:.3e}, {sh:.3f} of the tolerance; Kernel C {ks:.3f} ms "
                  f"= {t * cfg.full_size / ks / 1e6:.2f} Gsamp/s; bound "
                  f"{bms:.4f} ms ({by}), {bms / ks:.4f} of it; FFT kernel at "
                  f"HIGHEST {fs:.3f} ms ({fs / ks:.3f} of Kernel C's time; "
                  f"its own bound {fft_ms:.4f} ms, {fft_by}); float32 "
                  f"torch.fft chain {chain:.3f} ms; plain version "
                  f"{ps:.3f} ms"
                  + (f" in {-(-t // rows_)} calls of {rows_} blocks"
                     if rows_ < t else "")
                  + f"\n    stage table (tc_split_stages' cut-offs, ms): "
                  + "; ".join(parts) + f"; {smem} B of shared memory a "
                  f"block, {per_sm} blocks an SM, {groups} window group(s)")
            times[name, prec, kind] = (ks, ps, bms, by, fs)
            errs[name, prec, kind] = e
            del re, im

    print("== Kernel C: sessions through kspecanal_tpu_torch.cli.main")
    cfg65 = cfg_of(65536)
    cap = os.path.join(tmp, "split_capture.iq")
    write_capture(cap, cfg65, 4 * cfg65.full_size, seed=19)
    runs = [
        ("zeroSpan fft 3000 DEFAULT serial", ZS_ARGS + [
            "fftSize", "3000", "tpuPrecision", "DEFAULT", "tpuSource",
            "synth", "prgLoopCnt", "8"]),
        ("zeroSpan fft 10000 HIGH catch-up", ZS_ARGS + [
            "fftSize", "10000", "tpuPrecision", "HIGH", "tpuSource", "synth",
            "prgLoopCnt", "64", "tpuCatchUp", "16"]),
        ("zeroSpan fft 65536 DEFAULT u8 capture file", ZS_ARGS + [
            "fftSize", "65536", "tpuPrecision", "DEFAULT", "tpuSource",
            f"file:{cap}", "prgLoopCnt", "4"]),
        ("zeroSpan fft 65536 DEFAULT synth", ZS_ARGS + [
            "fftSize", "65536", "tpuPrecision", "DEFAULT", "tpuSource",
            "synth", "prgLoopCnt", "4"]),
    ]
    launches = {"lane": 0, "sublane": 0}
    real_launch = tc.launch_tc_split
    for i, (name, args) in enumerate(runs):
        cfg = parse_args(args)[0]
        lvls = os.path.join(tmp, f"split_lvls_{i}.bin")
        splits = []

        def recording(lib, re, im, c, tm, split):
            splits.append(split)
            return real_launch(lib, re, im, c, tm, split)
        tc.tc_split_launches = tc.tc_launches = 0
        cc.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(tc, "launch_tc_split", recording):
            rc = cli.main(args + ["tpuHeadless", "true", "saveSigLvls", lvls])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_c, n_a, n_fft = tc.tc_split_launches, tc.tc_launches, cc.launches
        check(rc == 0, f"{name} session rc")
        avg = load_avg(lvls)
        peaks = avg_peaks(cfg, avg)
        cell = cfg.sampling_rate / cfg.x_res
        on = len(peaks) == 3 and all(abs(p - w) <= cell
                                     for p, w in zip(peaks, PEAKS_HZ))
        want = {cc.tc_split(cfg, "file:" in " ".join(args))}
        print(f"  {name}: {cfg.prg_loop_cnt} iterations in {dt:.3f} s, "
              f"launches Kernel C {n_c} (splits {sorted(set(splits))}) "
              f"Kernel A {n_a} FFT kernel {n_fft}, peaks "
              f"{[round(p / 1e6, 4) for p in peaks]} MHz "
              f"{'PASS' if on else 'FAIL'}")
        check(avg.shape == (cfg.fft_size,) and not np.isnan(avg).any(),
              f"{name} average")
        check(n_c > 0 and n_c == len(splits) and n_a == 0 and n_fft == 0,
              f"{name} launched Kernel C and no other curscan kernel")
        check(set(splits) == want, f"{name} ran the JAX dispatcher's split")
        check(on, f"{name} peaks on 91/92/93 MHz")
        launches["sublane" if want == {(cfg.fft_size // 128, 128)}
                 else "lane"] += n_c
    torch.cuda.empty_cache()
    return errs, times, launches


def phase_display(gpu):
    """The display fold kernel (``csrc/display_fold.cu``) at both
    benchmark cells' shapes (K=4096 x fft 2048, K=512 x fft 16384;
    LogNoGain, MAX heatmap, every curve seeded): each checked against its
    plain version (max, min, cur, the heatmap and the counters
    bit-identical, the average within 1e-3 dB), then timed alone on the
    card: 8 calls captured in one CUDA graph, replayed between CUDA events
    (median of 10), so the wrapper's host time drops out; beside its bound
    (the spectra read once at 3.35 TB/s) and the plain chain's time
    (``cuda_ms_each``; its copies wait for the host, so no graph).  Cold:
    the calls read four spectra buffers in turn (128 MiB), so little of
    each input is in the 50 MB L2; warm: one buffer again and again.
    Returns each shape's numbers."""
    from kspecanal_tpu_torch.models import zerospan as zs
    from kspecanal_tpu_torch.ops import cuda_display as cd
    from kspecanal_tpu_torch.utils.profiling import cuda_ms, cuda_ms_each

    def graph_ms(calls):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for fn in calls:
                fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for fn in calls:
                fn()
        return cuda_ms(graph.replay) / len(calls)
    print(f"== display fold kernel vs plain ({gpu})")
    rows = {}
    for k, fft in ((4096, 2048), (512, 16384)):
        cfg = cfg_of(fft)
        gen = torch.Generator(device="cuda").manual_seed(k + fft)
        specs = [torch.rand((k, fft), generator=gen, device="cuda") + 1e-6
                 for _ in range(4)]
        state = cd.display_fold_plain(zs.init_state(cfg, "cuda"), specs[1],
                                      cfg)
        before = cd.launches
        got = cd.display_fold(state, specs[0], cfg)
        want = cd.display_fold_plain(state, specs[0], cfg)
        torch.cuda.synchronize()
        check(cd.launches == before + 2, f"display fold {k}x{fft}: two "
              "launches")
        for key in ("fft_max", "fft_min", "fft_cur", "heatmap", "hm_index",
                    "iteration", "seeded"):
            check(torch.equal(getattr(got, key), getattr(want, key)),
                  f"display fold {k}x{fft}: {key} bit-identical to plain")
        err = float((got.fft_avg - want.fft_avg).abs().max())
        check(err <= 1e-3, f"display fold {k}x{fft}: avg within 1e-3 dB "
              f"({err})")
        cold = graph_ms([lambda x=x: cd.display_fold(state, x, cfg)
                         for x in specs * 2])
        warm = graph_ms([lambda: cd.display_fold(state, specs[0], cfg)] * 8)
        turn = iter(range(1 << 30))
        plain = cuda_ms_each(lambda: cd.display_fold_plain(
            state, specs[next(turn) % 4], cfg))
        bound_ms = k * fft * 4 / HBM_BYTES_PER_S * 1e3
        print(f"  K={k} fft {fft}: kernel {cold:.4f} ms cold, {warm:.4f} "
              f"warm; bound {bound_ms:.4f} ms (bytes), share "
              f"{bound_ms / cold:.3f} cold; plain chain {plain:.4f} ms; "
              f"avg vs plain {err:.3g} dB")
        rows[k, fft] = {"ms": cold, "warm_ms": warm, "plain_ms": plain,
                        "bound_ms": bound_ms, "max_abs_err": err}
    return rows


def phase_done(name, t0):
    now = time.perf_counter()
    print(f"-- {name}: {now - t0:.1f} s")
    return now


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from kspecanal_tpu_torch import cli
    from kspecanal_tpu_torch.ops import _build
    from kspecanal_tpu_torch.ops import cuda_curscan as cc
    from kspecanal_tpu_torch.ops import cuda_packed as cp
    from kspecanal_tpu_torch.ops import spectrum as spec
    from kspecanal_tpu_torch.parallel import stream as st

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kspecanal_tpu_torch.utils.profiling import card_line
    gpu = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    print(f"== environment: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{[ln for ln in nvcc.splitlines() if 'release' in ln][0].strip()}")
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    print(gpu)

    t0 = time.perf_counter()
    from kspecanal_tpu_torch.ops import cuda_tc
    # the library, Kernel A's five K4 cut-offs, Kernel C's four, the two
    # ablate builds and the HIGHEST forensic builds, every source at once
    variants = (cuda_tc.stage_variants() + cuda_tc.tc_split_stage_variants()
                + cuda_tc.ablate_variants() + cuda_tc.highest_variants()
                + cc.fft_stage_variants() + cc.fft_stage_variants(True)[-1:]
                + cp.stage_variants() + cp.stage_variants(True)[-1:])
    _build.build(variants)
    _build.load()
    forensic = max((v for so, v in _build.build_job_seconds.items()
                    if so != _build.library_path()), default=0.0)
    print(f"== build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s) -> {_build.library_path()} "
          f"and {len(variants)} forensic libraries (cut-offs, ablate "
          f"builds, HIGHEST builds, the FFT kernel's and K2's cut-offs and "
          f"parent forms); the library's compiles took "
          f"{_build.build_job_seconds.get(_build.library_path(), 0.0):.1f} "
          f"s, the "
          f"forensic builds' {forensic:.1f} s (all started together)")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "Compiling entry" in ln or "spill" in ln:
            print(f"  {ln.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(20260817)
    t0 = time.perf_counter()
    display = phase_display(gpu)
    t0 = phase_done("display fold vs plain", t0)
    k1_errs = phase_kernels(cc, spec, gen)
    t0 = phase_done("K1 vs plain", t0)
    lane_err = phase_lane_kernels(cc, spec, gen)
    t0 = phase_done("K3's cells vs plain", t0)
    scan_errs = phase_scan_kernels(cc, cp, spec, gen)
    t0 = phase_done("scan kernels vs plain", t0)
    phase_stream(cc, st, gen)
    t0 = phase_done("stream", t0)
    with tempfile.TemporaryDirectory() as tmp:
        launches, display_launches = phase_sessions(cc, cli, tmp)
        t0 = phase_done("zero-span sessions", t0)
        lane_launches = phase_lane_sessions(cc, cli, tmp)
        t0 = phase_done("K3's sessions", t0)
        scan_launches = phase_scan_sessions(cc, cp, cli, tmp)
        t0 = phase_done("scan sessions", t0)
    times = phase_timing(cc, cp, spec, gen, gpu)
    t0 = phase_done("timing", t0)
    phase_device_sources(gen)
    t0 = phase_done("device sources", t0)
    highest_errs = phase_highest(cc, gen)
    t0 = phase_done("K4 and ablate keys at HIGHEST vs plain", t0)
    k4_class_err = phase_k4_class(cc, gen)
    t0 = phase_done("K4 at HIGH/DEFAULT vs plain", t0)
    ablate_errs = phase_ablate_class(cc, gen)
    t0 = phase_done("ablate variants vs plain", t0)
    with tempfile.TemporaryDirectory() as tmp:
        launches["2048"] += phase_device_sessions(cc, cli, tmp)
    t0 = phase_done("forensics sessions", t0)
    (k4_launches, direct_launches, k4_highest, k4_class, ablate_class,
     ablate_highest) = phase_forensics(cc)
    check(k4_launches > 0 and direct_launches > 0
          and k4_class["launches"] > 0,
          "the forensics scripts launched K4 (HIGHEST and DEFAULT) and the "
          "direct kernel")
    t0 = phase_done("forensics scripts", t0)
    with tempfile.TemporaryDirectory() as tmp:
        cc.launches = cp.launches = 0
        phase_analyzer(cc, cp, spec, tmp)
        t0 = phase_done("offline analyzer", t0)
        phase_toggles(cc, tmp)
        phase_png(cli, tmp)
        t0 = phase_done("renderer toggles and png:", t0)
    from kspecanal_tpu_torch.scripts import qfs_ablate
    print("== qfs_ablate: one quickFullScan sweep split on the card")
    qfs_ablate.main([])
    t0 = phase_done("qfs_ablate", t0)
    with tempfile.TemporaryDirectory() as tmp:
        tc_errs, tc_times, tc_launches = phase_precision(cc, cp, spec, cli,
                                                         gen, gpu, tmp)
    t0 = phase_done("precision classes", t0)
    with tempfile.TemporaryDirectory() as tmp:
        split_errs, split_times, split_launches = phase_split(
            cc, spec, cli, gen, gpu, tmp)
    t0 = phase_done("Kernel C", t0)
    with tempfile.TemporaryDirectory() as tmp:
        phase_mesh(gpu, tmp)
    phase_done("mesh", t0)
    fft_kernel = {"name": "curscan_fft", "route": "cuda",
                  "source": "kspecanal_tpu_torch/csrc/curscan_fft.cu"}
    sublane_423 = "kspecanal_tpu/ops/pallas_curscan.py:423"

    def timed(case, kind="f32", direct=False):
        ks, ds, ps, bms, by = times[case, kind]
        return {"ms": ds if direct else ks, "plain_ms": ps, "bound_ms": bms,
                "bound_by": by, "library_ms": None,
                **({} if ds is None or direct else {"direct_ms": ds})}

    (stage_rows, stage_launches, parent_ms,
     parent_launches) = times["fft_stages"]
    (packed_rows, packed_stage_launches, packed_parent_ms,
     packed_parent_launches) = times["packed_stages"]
    qfs_case = "quickFullScan fft 64 ones 90%"
    qfs_bound = bound(cfg_of(64, 0.1, "AVG", "WIN.ONES"), 1226 * 16, False)

    def k1(config, case, launched, err):
        row = {**fft_kernel, "replaces": sublane_423, "config": config,
               "launches": launched, "max_abs_err": err, **timed(case)}
        if (case, "f32") in parent_ms:
            row["parent_ms"] = parent_ms[case, "f32"]
        return row

    main_stages = stage_rows["main"]
    fft_bound = bound(cfg_of(), 4096, False)

    def tc_row(name, source, replaces, config, launched, err, row):
        ks, ps, bms, by, _ = row
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "config": config, "launches": launched,
                "max_abs_err": err, "ms": ks, "plain_ms": ps,
                "bound_ms": bms, "bound_by": by, "library_ms": None}

    display_rows = [
        {"name": "display_fold", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/display_fold.cu",
         "replaces": None,
         "config": f"the zero-span display chain (no TPU kernel: XLA's "
                   f"fusion in JAX), K={k} x fft {fft}, LogNoGain, MAX "
                   f"heatmap, seeded; ms cold (warm_ms: input in L2); "
                   f"launches over the zero-span catch-up and u8 sessions "
                   f"at fft {fft} (phase 6)",
         "launches": display_launches[str(fft)], **row,
         "bound_by": "bytes", "library_ms": None}
        for (k, fft), row in display.items()]
    print(json.dumps({"kernels": display_rows + [
        k1("zero-span fft 2048 kaiser 50%, T=4096", "zero-span fft 2048 "
           "kaiser 50%", launches["2048"], k1_errs[2048]),
        k1("zero-span fft 65536 kaiser 50% (8 blocks of 8192 a window), "
           "T=64",
           "zero-span fft 65536 kaiser 50%", launches["65536"],
           k1_errs[65536]),
        k1("zero-span fft 1280 kaiser 50% (mixed radix, one block), T=4096",
           "zero-span fft 1280 kaiser 50%", launches["1280"], k1_errs[1280]),
        k1("zero-span fft 20480 kaiser 50% (mixed radix, a cluster of 2), "
           "T=64", "fft 20480 kaiser 50%", launches["20480"],
           k1_errs[20480]),
        k1("fmScan fft 16384 ones 90%, T=288", "fmScan fft 16384 ones 90%",
           scan_launches["fm"], scan_errs["fm"]),
        {**fft_kernel, "replaces": "kspecanal_tpu/ops/pallas_curscan.py:116",
         "config": "lane kernel's cell: fft 16384 kaiser 50% f32, T=288",
         "launches": scan_launches["lane_cell"],
         "max_abs_err": scan_errs["lane_cell"],
         **timed("lane kernel's cell fft 16384 kaiser 50%"),
         "parent_ms": parent_ms["lane kernel's cell fft 16384 kaiser 50%",
                                "f32"]},
        {**fft_kernel, "name": "curscan_fft_stage", "replaces": sublane_423,
         "config": "the power-of-two FFT kernel's forensic builds "
                   "(csrc/curscan_fft.cu alone, -DKSPEC_FFT_STOP=1..4): "
                   "error the largest max abs error of the cut-offs "
                   "input, pass1 and radix16 against their plain versions "
                   "on 4 blocks of the main and fmScan cells; times the "
                   "build 'full' (the production kernel built alone) at "
                   "zero-span fft 2048 kaiser 50% f32, T=4096, with the "
                   "cut-offs in stages_ms; launches over scripts.fft_stages "
                   "in the timing phase",
         "launches": stage_launches,
         "max_abs_err": max(stage_rows[c][f"err_{s}"] for c in stage_rows
                            for s in cc.FFT_STAGES[:3]),
         "ms": main_stages["full"], "plain_ms": timed(
             "zero-span fft 2048 kaiser 50%")["plain_ms"],
         "bound_ms": fft_bound[0], "bound_by": fft_bound[1],
         "library_ms": None,
         "stages_ms": {s: main_stages[s] for s in cc.FFT_STAGES}},
        {**fft_kernel, "name": "curscan_fft_parent", "replaces": sublane_423,
         "config": "the power-of-two FFT kernel's parent form (its first "
                   "design; csrc/curscan_fft.cu with -DKSPEC_FFT_PARENT=1), "
                   "the production kernel's yardstick: times at zero-span "
                   "fft 2048 kaiser 50% f32, T=4096, on the production "
                   "kernel's planes; error its max abs error against the "
                   "float64 plain version at fft 2048 kaiser 50% AVG in "
                   "phase 3; launches over the timing phase",
         "launches": parent_launches,
         "max_abs_err": k1_errs["parent2048"],
         "ms": parent_ms["zero-span fft 2048 kaiser 50%", "f32"],
         "plain_ms": timed("zero-span fft 2048 kaiser 50%")["plain_ms"],
         "bound_ms": fft_bound[0], "bound_by": fft_bound[1],
         "library_ms": None},
        {"name": "curscan_mixed", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_mixed.cuh",
         "replaces": "kspecanal_tpu/ops/pallas_curscan.py:116",
         "config": "K3's cells off the 128 grid: fft 3000 kaiser 50% f32, "
                   "T=4096; launches over the fft 3000/10000 zero-span, "
                   "zeroSpanSave and tpuStateFile sessions",
         "launches": lane_launches, "max_abs_err": lane_err,
         **timed("fft 3000 kaiser 50%")},
        {"name": "curscan_sublane", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_sublane.cu",
         "replaces": sublane_423,
         "config": "the direct DFT, no session's kernel: K1's yardstick "
                   "(launches over the HIGHEST roofline tables), timed at "
                   "zero-span fft 1280 kaiser 50%, T=4096",
         "launches": direct_launches, "max_abs_err": k1_errs["direct"],
         **timed("zero-span fft 1280 kaiser 50%", direct=True)},
        {"name": "curscan_packed", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_packed.cu",
         "replaces": "kspecanal_tpu/ops/pallas_curscan.py:872",
         "config": "quickFullScan fft 64 ones 90%, T=1226*16",
         "launches": scan_launches["qfs"], "max_abs_err": scan_errs["packed"],
         **timed(qfs_case), "parent_ms": packed_parent_ms[qfs_case, "f32"],
         "share_over_parent": scan_errs["packed_ratio"]},
        {"name": "curscan_packed_stage", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_packed.cu",
         "replaces": "kspecanal_tpu/ops/pallas_curscan.py:872",
         "config": "K2's forensic builds (csrc/curscan_packed.cu alone, "
                   "-DKSPEC_PACKED_STOP=1..4): error the largest max abs "
                   "error of the cut-offs input, regs and lanes against "
                   "their plain versions on 8 blocks of "
                   "quickFullScan T=19616 f32 and u8; times the build "
                   "'full' (the production kernel built alone) at that "
                   "cell f32, with the cut-offs in stages_ms; launches over "
                   "scripts.packed_stages in the timing phase",
         "launches": packed_stage_launches,
         "max_abs_err": max(packed_rows[c][f"err_{st}"]
                            for c in packed_rows for st in cp.STAGES[:3]),
         "ms": packed_rows["qfs"]["full"],
         "plain_ms": timed(qfs_case)["plain_ms"],
         "bound_ms": qfs_bound[0], "bound_by": qfs_bound[1],
         "library_ms": None,
         "stages_ms": {st: packed_rows["qfs"][st] for st in cp.STAGES}},
        {"name": "curscan_packed_parent", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_packed.cu",
         "replaces": "kspecanal_tpu/ops/pallas_curscan.py:872",
         "config": "K2's parent form (its first design; "
                   "csrc/curscan_packed.cu with -DKSPEC_PACKED_PARENT=1), "
                   "the production kernel's yardstick: times at "
                   "quickFullScan T=1226*16 f32 on the production kernel's "
                   "planes; error its max abs error against the float64 "
                   "plain version at quickFullScan AVG T=1226*16 in phase "
                   "4; launches over the timing phase",
         "launches": packed_parent_launches,
         "max_abs_err": scan_errs["packed_parent"],
         "ms": packed_parent_ms[qfs_case, "f32"],
         "plain_ms": timed(qfs_case)["plain_ms"],
         "bound_ms": qfs_bound[0], "bound_by": qfs_bound[1],
         "library_ms": None},
        {"name": "curscan_tc_stage_highest", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_tc.cuh",
         "replaces": "scripts/roofline_r2.py:43",
         "config": "K4 at HIGHEST: Kernel A's six-pass forensic builds "
                   "(-DKSPEC_TC_HIGHEST=1, cut off with -DKSPEC_TC_STOP), "
                   "fft 2048 kaiser 50% AVG f32: error the worst of six "
                   "stages at T=256, times the 'full' stage at T=4096; "
                   "launches over roofline_r2 --precision HIGHEST",
         "max_abs_err": highest_errs["k4"], **k4_highest,
         "library_ms": None},
        {"name": "curscan_tc_ablate_highest", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_tc.cuh",
         "replaces": "kspecanal_tpu/ops/pallas_curscan.py:427",
         "config": "K1's ablate keys at HIGHEST up to fft 16384: Kernel A's "
                   "six-pass ablate build (-DKSPEC_TC_HIGHEST=1 "
                   "-DKSPEC_TC_ABLATE=1); error the worst of the nine "
                   "variants with a key at fft 2048 kaiser 50% (u8 and f32, "
                   "T=256; unnormalised as below); times with no stage "
                   "removed on u8, T=4096; launches over kernel_ablate 2048 "
                   "HIGHEST u8 and f32",
         "max_abs_err": highest_errs["A"], **ablate_highest["A"],
         "library_ms": None},
        {"name": "curscan_tc_split_ablate_highest", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_tc_split.cuh",
         "replaces": "kspecanal_tpu/ops/pallas_curscan.py:427",
         "config": "K1's ablate keys at HIGHEST above fft 16384: Kernel C's "
                   "six-pass ablate build (-DKSPEC_TC_HIGHEST=1 "
                   "-DKSPEC_TCS_ABLATE=1) on (fft/128, 128); error the worst "
                   "of the nine variants with a key at fft 32768 kaiser 50% "
                   "(f32 and u8, T=16); times with no stage removed on u8, "
                   "T=64; launches over kernel_ablate 32768 HIGHEST u8 "
                   "(T=64/128)",
         "max_abs_err": highest_errs["C"], **ablate_highest["C"],
         "library_ms": None},
        {"name": "curscan_tc_stage", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_tc.cuh",
         "replaces": "scripts/roofline_r2.py:43",
         "config": "K4 at HIGH/DEFAULT: Kernel A cut off after each stage "
                   "(-DKSPEC_TC_STOP builds), fft 2048 kaiser 50% AVG f32: "
                   "error the worst of six stages and both classes at "
                   "T=256, times the DEFAULT 'full' stage at T=4096; "
                   "launches over roofline_r2 --precision DEFAULT",
         "max_abs_err": k4_class_err, **k4_class, "library_ms": None},
        {"name": "curscan_tc_ablate", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_tc.cuh",
         "replaces": "kspecanal_tpu/ops/pallas_curscan.py:427",
         "config": "K1's ablate keys at HIGH/DEFAULT up to fft 16384: Kernel "
                   "A's ablate build (-DKSPEC_TC_ABLATE=1); error the worst "
                   "of the ten kernel_ablate variants at fft 2048 kaiser 50% "
                   "(DEFAULT u8 and f32, HIGH f32, T=256; variants without "
                   "sqrt or the weights fold unnormalised magnitudes, so "
                   "the largest errors are theirs); times with no "
                   "stage removed at DEFAULT u8, T=4096; launches over "
                   "kernel_ablate 2048 DEFAULT u8 and HIGH f32",
         "max_abs_err": ablate_errs["A"], **ablate_class["A"],
         "library_ms": None},
        {"name": "curscan_tc_split_ablate", "route": "cuda",
         "source": "kspecanal_tpu_torch/csrc/curscan_tc_split.cuh",
         "replaces": "kspecanal_tpu/ops/pallas_curscan.py:427",
         "config": "K1's ablate keys at HIGH/DEFAULT above fft 16384: Kernel "
                   "C's ablate build (-DKSPEC_TCS_ABLATE=1) on (fft/128, "
                   "128); error the worst of the ten variants at fft 32768 "
                   "kaiser 50% (HIGH f32, DEFAULT u8, T=16; unnormalised as "
                   "above); times with no "
                   "stage removed at DEFAULT u8, T=64; launches over "
                   "kernel_ablate 32768 DEFAULT u8 (T=64/128)",
         "max_abs_err": ablate_errs["C"], **ablate_class["C"],
         "library_ms": None},
        tc_row("curscan_tc", "kspecanal_tpu_torch/csrc/curscan_tc.cu",
               sublane_423, "HIGH/DEFAULT classes (4M) of K1 and K3's cell on "
               "the 128 grid: times at zero-span fft 2048 kaiser 50% DEFAULT "
               "f32, T=4096; error against the plain version the worst over "
               "the classes and inputs at that shape (one window group a "
               "block); launches over the precision sessions",
               tc_launches["tc"], tc_errs["tc"],
               tc_times["zero-span fft 2048 kaiser 50%", "DEFAULT", "f32"]),
        tc_row("curscan_packed_tc",
               "kspecanal_tpu_torch/csrc/curscan_packed_tc.cu",
               "kspecanal_tpu/ops/pallas_curscan.py:872",
               "HIGH/DEFAULT classes of K2: times at quickFullScan fft 64 "
               "ones 90% DEFAULT f32, T=1226*16; error against the plain "
               "version the worst over the classes and inputs at that shape; "
               "launches over the precision sessions",
               tc_launches["packed_tc"],
               tc_errs["packed_tc"],
               tc_times["quickFullScan fft 64 ones 90%", "DEFAULT", "f32"]),
        tc_row("curscan_tc_split",
               "kspecanal_tpu_torch/csrc/curscan_tc_split.cu",
               "kspecanal_tpu/ops/pallas_curscan.py:116",
               "Kernel C, the HIGH/DEFAULT classes (4M) of K3 off the 128 "
               "grid and on the lane split above fft 16384: times and error "
               "against the plain version at fft 3000 kaiser 50% DEFAULT "
               "f32 (60 x 50), T=4096; launches over the fft 3000, 10000 and "
               "65536 synth sessions",
               split_launches["lane"],
               split_errs["fft 3000 kaiser 50%", "DEFAULT", "f32"],
               split_times["fft 3000 kaiser 50%", "DEFAULT", "f32"]),
        tc_row("curscan_tc_split",
               "kspecanal_tpu_torch/csrc/curscan_tc_split.cu", sublane_423,
               "Kernel C, the HIGH/DEFAULT classes (4M) of K1 above fft "
               "16384 (sublane split n/128 x 128): times and error against "
               "the plain version at fft 65536 kaiser 50% HIGH f32 (512 x "
               "128), T=64; launches over the fft 65536 u8 capture-file "
               "session",
               split_launches["sublane"],
               split_errs["fft 65536 kaiser 50%", "HIGH", "f32"],
               split_times["fft 65536 kaiser 50%", "HIGH", "f32"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
