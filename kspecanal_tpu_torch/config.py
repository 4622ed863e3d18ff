"""Typed configuration for the TPU-native kspecanal framework.

The port's own copy of ``kspecanal_tpu.config`` (numpy only), kept equal
to it by tests/test_torch_standalone.py.

The reference (kspecanal.py) keeps all state in a mutable global dict ``gD``
built from module-level ``g*`` defaults (kspecanal.py:41-75) that
``handle_args`` copies and overrides from CLI token pairs
(kspecanal.py:778-949).  Here the same ~25 user options live in one frozen,
hashable dataclass so a config can be a ``jax.jit`` static argument and the
per-step compute stays purely functional.

Derivation rules reproduced from the reference:
  * ``full_size`` rule            kspecanal.py:926-929
  * ``x_res`` fixup               kspecanal.py:937-949
  * scan end-freq rounding        kspecanal.py:701-709 (_fixupfreqs_scanrange)
  * zero-span start/end freqs     kspecanal.py:275-278 (_calc_startendfreq)
  * window LUTs                   kspecanal.py:932-936
  * overlapped-window framing     kspecanal.py:368,385-390
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Mode / enum constants (string enums, mirroring kspecanal.py:18-38)
# ---------------------------------------------------------------------------
MODE_SCAN = "SCAN"
MODE_ZEROSPAN = "ZEROSPAN"
MODE_ZEROSPANSAVE = "ZEROSPANSAVE"
MODE_ZEROSPANPLAY = "ZEROSPANPLAY"
MODE_ALIAS_FMSCAN = "FMSCAN"
MODE_ALIAS_QUICKFULLSCAN = "QUICKFULLSCAN"

CUMU_MAX = "MAX"
CUMU_MIN = "MIN"
CUMU_AVG = "AVG"
CUMU_RAW = "RAW"

COMPRESS_MAX = "MAX"
COMPRESS_MIN = "MIN"
COMPRESS_AVG = "AVG"
COMPRESS_RAW = "RAW"
COMPRESS_CONV = "CONV"

WINDOW_ONES = "WIN.ONES"
WINDOW_HAMMING = "WIN.HAMMING"
WINDOW_HANNING = "WIN.HANNING"
WINDOW_KAISER = "WIN.KAISER"

WINDOWS = (WINDOW_ONES, WINDOW_HAMMING, WINDOW_HANNING, WINDOW_KAISER)

# Kaiser beta used by the reference for both the FFT window and the CONV
# smoothing kernel (kspecanal.py:87,934).
KAISER_BETA = 64.0
CONV_KERNEL_LEN = 128

# Heatmap ring-buffer depth (kspecanal.py:448 `maxHM = 128`).
HEATMAP_ROWS = 128


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Immutable run configuration.

    Field defaults mirror the reference's ``g*`` globals
    (kspecanal.py:41-75, :240-242, :311, :350, :509, :568, :734-735).
    """

    # -- mode -------------------------------------------------------------
    prg_mode: str = MODE_ALIAS_FMSCAN          # gPrgModeDefault :42
    # -- tuning -----------------------------------------------------------
    center_freq: float = 92e6                  # gCenterFreq :46
    start_freq: Optional[float] = None         # set by SCAN / aliases
    end_freq: Optional[float] = None
    sampling_rate: float = 2.4e6               # gSamplingRate :47
    gain: float = 19.1                         # gGain :51
    # -- DSP core ---------------------------------------------------------
    fft_size: int = 2 ** 14                    # gFftSize :48
    fft2full_mult4less: int = 8                # gFft2FullMult4Less :49
    fft2full_mult4more: int = 2                # gFft2FullMult4More :50
    window: str = WINDOW_ONES                  # gWindow :52
    cur_scan_non_overlap: float = 0.1          # gCurScanNonOverlap :45
    cur_scan_cumu_mode: str = CUMU_AVG         # gCurScanCumuMode :58
    min_amp4clip: float = (1 / 256) * 0.00001  # gMinAmp4Clip :53
    scan_range_non_overlap: float = 0.5        # gScanRangeNonOverlap :54
    b_scan_range_base_data_is_raw: bool = False  # gbScanRangeBaseDataIsRaw :568
    b_use_psd: bool = False                    # gbUsePSD :350
    # MXU matmul precision for the DFT paths (new, no reference analog):
    # HIGHEST (default) holds ~1e-6 relative error vs the float64 oracle;
    # HIGH (bf16x3 passes) trades ~1e-5 error for matmul throughput;
    # DEFAULT (single bf16 pass) is the fast mode for 8-bit-ADC sources,
    # whose quantization noise already dwarfs bf16 rounding.
    tpu_precision: str = "HIGHEST"             # tpuPrecision CLI option
    # Band-edge bin skip (the reference's own TODO, README.rst:608-611:
    # "Skip few fft bins at begin and end, of each curscan, so that
    # mirroring/minimal leakage ... around the nyquist freq" is bypassed).
    # The outer K bins of each zero-span DISPLAY curve/heatmap row are
    # floored to that curve's inner minimum, so compression and peak
    # marking never pick them; curve state/cumulation stay full-width.
    tpu_edge_skip_bins: int = 0                # tpuEdgeSkipBins CLI option
    # -- display processing (source-edit-only in the reference :62-67) ----
    zero_span_disp_proc: str = "LogNoGain"     # gZeroSpanFftDispProcMode :63
    scan_disp_proc: str = "LogNoGain"          # gScanRangeFftDispProcMode :64
    scan_clip_proc: str = "Clip2MinAmp"        # gScanRangeClipProcMode :66
    # -- render / UI ------------------------------------------------------
    x_res: int = 512                           # gXRes :56
    plt_compress: str = COMPRESS_AVG           # gPltCompress :57
    plt_compress_hm: str = COMPRESS_MAX        # gPltCompressHM :67
    b_plt_heatmap: bool = True                 # gbPltHeatMap :43
    b_plt_levels: bool = True                  # gbPltLevels :44
    b_grid: bool = True                        # gbGrid :59
    b_data_min: bool = True                    # gbDataMin :71
    b_data_max: bool = True                    # gbDataMax :72
    b_data_avg: bool = True                    # gbDataAvg :73
    b_data_cur: bool = True                    # gbDataCur :74
    plt_highs_num_markers: int = 5             # gPltHighsNumMarkers :241
    plt_highs_delta4marking: float = 0.025     # gPltHighsDelta4Marking :240
    plt_highs_pause: bool = False              # gPltHighsPause :242
    # -- loop / persistence ----------------------------------------------
    prg_loop_cnt: int = 8192                   # gPrgLoopCnt :55
    zero_span_save_file: str = "/tmp/zerospan.save"  # gZeroSpanSaveFile :509
    zero_span_play_file: str = "/tmp/zerospan.save"
    save_sig_lvls: str = ""                    # gSaveSigLvls :734
    adj_sig_lvls: str = ""                     # gAdjSigLvls :735

    # ------------------------------------------------------------------
    # Derived quantities (all pure functions of the frozen fields, so the
    # config stays hashable and can be a jit static argument).
    # ------------------------------------------------------------------
    @property
    def full_size(self) -> int:
        """Samples captured per scan iteration (kspecanal.py:926-929)."""
        if self.fft_size < (self.sampling_rate // 8):
            return self.fft_size * self.fft2full_mult4less
        return self.fft_size * self.fft2full_mult4more

    @property
    def hop(self) -> float:
        """Sliding-window step in samples; may be fractional
        (``fftSize * curScanNonOverlap``, kspecanal.py:386)."""
        return self.fft_size * self.cur_scan_non_overlap

    @property
    def num_windows(self) -> int:
        """Number of overlapped windows actually processed per scan.

        The reference computes ``numLoops = int(fullSize/(fftSize*nonOverlap))``
        (kspecanal.py:368) but breaks out early when a window would run past
        the end of the capture (kspecanal.py:389-390); we pre-compute the
        surviving count so the on-device loop has a static shape.
        """
        return len(self.window_starts)

    @property
    def window_starts(self) -> Tuple[int, ...]:
        """Start index of every valid overlapped window.

        Start i is ``int(i*fftSize*nonOverlap)`` (kspecanal.py:386) — note
        the per-index truncation, NOT a cumulative integer hop, so for
        fractional hops the starts are non-uniformly spaced.  Windows whose
        end would exceed ``full_size`` are dropped (kspecanal.py:389-390).
        """
        num_loops = int(self.full_size / (self.fft_size * self.cur_scan_non_overlap))
        starts = []
        for i in range(num_loops):
            s = int(i * self.fft_size * self.cur_scan_non_overlap)
            if s + self.fft_size > self.full_size:
                break
            starts.append(s)
        return tuple(starts)

    @property
    def start_end_freq(self) -> Tuple[float, float]:
        """Zero-span band edges (kspecanal.py:275-278)."""
        return (self.center_freq - self.sampling_rate / 2,
                self.center_freq + self.sampling_rate / 2)

    # -- scan-mode geometry ------------------------------------------------
    @property
    def scan_num_groups(self) -> int:
        """Non-overlapping fS-wide groups covering [start,end]
        (kspecanal.py:598-599); requires finalized scan freqs."""
        assert self.start_freq is not None and self.end_freq is not None
        return int((self.end_freq - self.start_freq) / self.sampling_rate)

    @property
    def scan_total_entries(self) -> int:
        """Global stitched-grid length (kspecanal.py:600)."""
        return self.scan_num_groups * self.fft_size

    @property
    def scan_num_bands(self) -> int:
        """Number of stepped retune bands per sweep (loop at
        kspecanal.py:621-693: while startFreq < endFreq, advancing by
        ``fS*scanRangeNonOverlap``)."""
        assert self.start_freq is not None and self.end_freq is not None
        span = self.sampling_rate
        n = 0
        cur = self.start_freq + span / 2
        start = cur - span / 2
        while start < self.end_freq:
            n += 1
            cur += span * self.scan_range_non_overlap
            start = cur - span / 2
        return n

    # ------------------------------------------------------------------
    def validate_scan(self) -> None:
        """Scan-mode overlap integrality checks (kspecanal.py:588-593)."""
        if (self.sampling_rate * self.scan_range_non_overlap) % 1 != 0:
            raise ValueError(
                f"freqSpan [{self.sampling_rate}] x scanRangeNonOverlap "
                f"[{self.scan_range_non_overlap}] is not int")
        if (self.fft_size * self.scan_range_non_overlap) % 1 != 0:
            raise ValueError(
                f"fftSize [{self.fft_size}] x scanRangeNonOverlap "
                f"[{self.scan_range_non_overlap}] is not int")

    def finalize(self) -> "SpecConfig":
        """Resolve mode aliases and derived frequencies.

        Mirrors the tail of ``handle_args`` (kspecanal.py:912-949): FMSCAN /
        QUICKFULLSCAN alias expansion, scan end-freq rounding, zero-span
        start/end calculation, and the xRes fixup.
        """
        c = self
        if c.prg_mode == MODE_ALIAS_FMSCAN:
            c = dataclasses.replace(c, prg_mode=MODE_SCAN,
                                    start_freq=88e6, end_freq=108e6)
        elif c.prg_mode == MODE_ALIAS_QUICKFULLSCAN:
            c = dataclasses.replace(c, prg_mode=MODE_SCAN,
                                    start_freq=30e6, end_freq=1.5e9,
                                    fft_size=64, plt_compress=COMPRESS_RAW)
        if c.prg_mode == MODE_SCAN:
            # endFreq → next multiple of samplingRate; centerFreq → midpoint
            # (kspecanal.py:701-709).
            assert c.start_freq is not None and c.end_freq is not None
            bands = (c.end_freq - c.start_freq) / c.sampling_rate
            if bands % 1 != 0:
                c = dataclasses.replace(
                    c, end_freq=c.start_freq + math.ceil(bands) * c.sampling_rate)
            c = dataclasses.replace(
                c, center_freq=c.start_freq + (c.end_freq - c.start_freq) / 2)
        else:
            s, e = c.start_end_freq
            c = dataclasses.replace(c, start_freq=s, end_freq=e)
        # xRes fixup (kspecanal.py:937-949): clamp to fftSize, else force to a
        # divisor of fftSize that is >= ~300 (the smallest such divisor).
        if c.x_res > c.fft_size:
            c = dataclasses.replace(c, x_res=c.fft_size)
        elif c.fft_size % c.x_res != 0:
            min_x_res = 300
            new_x_res = c.x_res
            for i in range(int(c.fft_size / min_x_res), 0, -1):
                if c.fft_size % i == 0:
                    new_x_res = c.fft_size // i
                    break
            c = dataclasses.replace(c, x_res=new_x_res)
        if not 0 <= c.tpu_edge_skip_bins < c.fft_size // 2:
            raise ValueError(
                f"tpuEdgeSkipBins [{c.tpu_edge_skip_bins}] must be in "
                f"[0, fftSize/2) = [0, {c.fft_size // 2}) — skipping every "
                "bin leaves nothing to display")
        return c


# ---------------------------------------------------------------------------
# Window LUTs
# ---------------------------------------------------------------------------
@lru_cache(maxsize=32)
def window_lut(kind: str, size: int) -> np.ndarray:
    """Window table of `size` points (float64, cached).

    Same four families the reference builds eagerly at kspecanal.py:932-936
    using numpy's symmetric definitions (np.hamming/np.hanning/np.kaiser).
    """
    if kind == WINDOW_ONES:
        return np.ones(size)
    if kind == WINDOW_HAMMING:
        return np.hamming(size)
    if kind == WINDOW_HANNING:
        return np.hanning(size)
    if kind == WINDOW_KAISER:
        return np.kaiser(size, KAISER_BETA)
    raise ValueError(f"unknown window {kind!r}")


def win_adj(kind: str, size: int) -> float:
    """Coherent-gain compensation ``len(win)/sum(win)`` (kspecanal.py:373)."""
    w = window_lut(kind, size)
    return float(len(w) / np.sum(w))


@lru_cache(maxsize=4)
def conv_kernel() -> np.ndarray:
    """Smoothing kernel for the CONV display transform: ``np.kaiser(128, 64)``
    (kspecanal.py:87)."""
    return np.kaiser(CONV_KERNEL_LEN, KAISER_BETA)


def cumu_weights(mode: str, n: int) -> Optional[np.ndarray]:
    """Closed-form weights equivalent to sequentially cumulating ``n``
    spectra with ``data_cumu`` (kspecanal.py:124-147).

    AVG is the sequential exponential decay ``f_i = (f_{i-1} + x_i)/2`` with
    ``f_0 = x_0`` (the first spectrum is copied, kspecanal.py:133-134,393),
    which unrolls to
        ``w_0 = 2^-(n-1)``, ``w_i = 2^-(n-i)`` for i >= 1.
    Expressing it as a static weight vector turns the reference's serial
    Python loop into one weighted reduction over the window axis (a matvec,
    which XLA maps onto the MXU).  RAW keeps only the last spectrum.
    MAX/MIN have no weights (plain reductions) -> returns None.
    """
    if mode == CUMU_AVG:
        if n == 1:
            return np.ones(1)
        i = np.arange(n)
        w = 2.0 ** -(n - i.astype(np.float64))
        w[0] = 2.0 ** -(n - 1)
        return w
    if mode == CUMU_RAW:
        w = np.zeros(n)
        w[-1] = 1.0
        return w
    if mode in (CUMU_MAX, CUMU_MIN):
        return None
    raise ValueError(f"unknown cumulate mode {mode!r}")
