"""Scan mode — the port of ``kspecanal_tpu.models.scan``: a stepped
multi-band sweep with overlap-averaged stitching (the reference's
``scan_range`` / ``_scan_range``, kspecanal.py:568-732).

All band curscans of a sweep run as one batched call (``band_spectra`` ->
``curscan_auto_batched``, so on the card fmScan runs the sublane kernel and
quickFullScan the packed kernel); the order-dependent stitch folds the bands
into the global curves from a static plan computed from the config.  Failed
retunes fill their band with ones (about -gain dB) and the sweep goes on
(kspecanal.py:635-639).

The plan code (``BandPlan``, ``ScanPlan``, ``make_scan_plan``,
``_gather_stitch_plan``) is NumPy and is copied from the JAX module, whose
import loads JAX.  ``_uniform_run`` and ``rel_band`` are not: they only keep
JAX's compiled programs few and small (the ``lax.scan`` fold, one program
for every band), and eager PyTorch compiles nothing.  The functions here
return new tensors and never update their inputs in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kspecanal_tpu_torch.config import (CUMU_AVG, CUMU_MAX, CUMU_MIN,
                                        CUMU_RAW, HEATMAP_ROWS, SpecConfig)
from kspecanal_tpu_torch.ops import dsp
from kspecanal_tpu_torch.ops.spectrum import (curscan_auto_batched,
                                              decode_u8, psd_welch)


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Static stitch indices for one band (kspecanal.py:621-668)."""
    center_freq: float
    i_start: int     # global grid write start for Max/Min/Avg
    i_end: int       # iStart + fftSize (clamped source length via s_end)
    i_done: int      # int((i+1)*fftSize*scanRangeNonOverlap)
    i_old_end: int   # previous band's iEnd (0 for first band)
    s_start: int     # source slice start (always 0 in the reference)
    s_end: int       # source slice end (shrinks if band pokes past grid)
    s_raw_start: int  # source start of the fresh (non-overlap) region


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """Whole-sweep static plan derived purely from the config."""
    bands: Tuple[BandPlan, ...]
    total_entries: int
    num_groups: int
    freqs_all: Tuple[float, ...]  # global stitched frequency axis

    @property
    def num_bands(self) -> int:
        return len(self.bands)


def make_scan_plan(cfg: SpecConfig) -> ScanPlan:
    """Precompute the reference's band-loop index math
    (kspecanal.py:594-650 and the freq axis at :609)."""
    cfg.validate_scan()
    assert cfg.start_freq is not None and cfg.end_freq is not None
    span = cfg.sampling_rate
    f = cfg.fft_size
    num_groups = cfg.scan_num_groups
    total = num_groups * f
    freqs_all = np.fft.fftshift(
        np.fft.fftfreq(total, 1.0 / (num_groups * span))
        + cfg.start_freq + (num_groups * span) / 2)

    bands = []
    cur_freq = cfg.start_freq + span / 2
    start_freq = cur_freq - span / 2
    i = 0
    i_old_end = 0
    while start_freq < cfg.end_freq:
        i_start = int(i * f * cfg.scan_range_non_overlap)
        i_end = i_start + f
        i_done = int((i + 1) * f * cfg.scan_range_non_overlap)
        s_start = 0
        if i_end > total:
            s_end = i_end - i_start - (i_end - total)
        else:
            s_end = i_end - i_start
        # sRawStart = sStart + (fftSize - (iEnd - iOldEnd))  :643
        s_raw_start = s_start + (f - (i_end - i_old_end))
        clamped_old_end = min(i_old_end, total)
        bands.append(BandPlan(
            center_freq=cur_freq, i_start=i_start, i_end=i_end,
            i_done=min(i_done, total), i_old_end=clamped_old_end,
            s_start=s_start, s_end=s_end, s_raw_start=s_raw_start))
        i_old_end = i_end
        cur_freq += span * cfg.scan_range_non_overlap
        start_freq = cur_freq - span / 2
        i += 1
    # The band frequency axes overwrite overlapping segments of the global
    # axis (kspecanal.py:631-634); reproduce that exactly.
    fa = np.array(freqs_all)
    for b in bands:
        bf = np.fft.fftshift(
            np.fft.fftfreq(f, 1.0 / cfg.sampling_rate) + b.center_freq)
        fa[b.i_start:b.i_start + (b.s_end - b.s_start)] = bf[b.s_start:b.s_end]
    return ScanPlan(bands=tuple(bands), total_entries=total,
                    num_groups=num_groups, freqs_all=tuple(fa.tolist()))


class ScanState(NamedTuple):
    """Global stitched curves over the whole scan range (dB domain) +
    per-sweep waterfall ring (kspecanal.py:602-614)."""
    fft_max: torch.Tensor      # (total_entries,) float32
    fft_min: torch.Tensor
    fft_avg: torch.Tensor
    fft_cur: torch.Tensor
    heatmap: torch.Tensor      # (HEATMAP_ROWS, hm_width)
    hm_index: torch.Tensor     # int32 scalar: next row to write
    sweep: torch.Tensor        # int32 scalar: completed sweeps (runCount)


class ScanView(NamedTuple):
    x_freqs: torch.Tensor
    max_lvls: torch.Tensor
    min_lvls: torch.Tensor
    avg_lvls: torch.Tensor
    cur_lvls: torch.Tensor
    heatmap: torch.Tensor


def init_state(cfg: SpecConfig, plan: ScanPlan, device) -> ScanState:
    """Buffers as the first ``_scan_range`` call seeds them
    (kspecanal.py:602-614): Cur/Max/Avg = disp(minAmp4Clip), Min = disp(1),
    heatmap rows = the RAW (linear) minAmp4Clip, as the reference does."""
    total = plan.total_entries
    floor = float(10 * np.log10(cfg.min_amp4clip) - cfg.gain)
    hm_w = dsp.compress_1d(torch.zeros(total), cfg.plt_compress_hm,
                           cfg.x_res).shape[-1]

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    i0 = torch.zeros((), dtype=torch.int32, device=device)
    return ScanState(
        fft_max=full((total,), floor), fft_min=full((total,), -cfg.gain),
        fft_avg=full((total,), floor), fft_cur=full((total,), floor),
        heatmap=full((HEATMAP_ROWS, hm_w), float(cfg.min_amp4clip)),
        hm_index=i0, sweep=i0)


def band_spectra(iq_re: torch.Tensor, iq_im: torch.Tensor,
                 retune_ok: torch.Tensor, cfg: SpecConfig) -> torch.Tensor:
    """Per-band display spectra of one sweep: ``iq_*`` (num_bands,
    full_size) float32 or raw u8, ``retune_ok`` (num_bands,) bool ->
    (num_bands, fft_size) dB after the scan display chain: curscan ->
    sentinel -> Clip2MinAmp -> LogNoGain(infTo=0) (kspecanal.py:635-641).
    ``b_use_psd`` swaps in the Welch PSD per band (kspecanal.py:636 ->
    :374-384); it decodes u8 first."""
    if cfg.b_use_psd:
        lin = psd_welch(decode_u8(iq_re), decode_u8(iq_im), cfg)
    else:
        lin = curscan_auto_batched(iq_re, iq_im, cfg)
    return band_display(lin, retune_ok, cfg)


def band_display(lin: torch.Tensor, retune_ok: torch.Tensor,
                 cfg: SpecConfig) -> torch.Tensor:
    """The scan display chain of :func:`band_spectra` on linear band
    spectra ``(num_bands, fft_size)``."""
    # Failed retune -> all-ones band (~ -gain dB marker), :637-639
    lin = torch.where(retune_ok[:, None], lin, torch.ones_like(lin))
    if cfg.scan_clip_proc == "Clip2MinAmp":
        lin = dsp.clip2minamp(lin, cfg.min_amp4clip)
    elif cfg.scan_clip_proc == "HistLowClip":
        lin = dsp.hist_low_clip(lin)
    return dsp.fftvals_dispproc(lin, cfg.scan_disp_proc, gain=cfg.gain,
                                inf_to=0.0)


def band_stitch(curves, pr: torch.Tensor, b: BandPlan, cfg: SpecConfig,
                first_sweep: torch.Tensor):
    """Stitch one band's spectrum ``pr`` into the (cur, max, min, avg)
    curves (kspecanal.py:642-668).  The per-band redraw (``tpuRenderEvery
    band``) calls it band by band."""
    cur, fmax, fmin, favg = curves
    # The last band's source shrinks when it pokes past the grid
    # (:626-629), so the RAW region follows the source and may be empty.
    raw_len = max(0, b.s_end - b.s_raw_start)
    i_start, i_old_end = b.i_start, b.i_old_end
    ovl_len = i_old_end - i_start
    if raw_len > 0:   # Cur: RAW copy of the fresh region (:642-644)
        cur = dsp.cumulate_range(CUMU_RAW, cur, i_old_end, i_old_end + raw_len,
                                 pr, b.s_raw_start, b.s_raw_start + raw_len)
    if i_old_end != 0 and ovl_len > 0:   # overlap-average (:645-649)
        cur = dsp.cumulate_range(CUMU_AVG, cur, i_start, i_start + ovl_len,
                                 pr, b.s_start, b.s_start + ovl_len)
    # Max/Min/Avg source: the raw band or the stitched Cur (:651-662)
    if cfg.b_scan_range_base_data_is_raw:
        src, s0, n = pr, b.s_start, b.s_end - b.s_start
    else:
        src, s0, n = cur, i_start, b.i_done - b.i_start
    if cfg.b_data_max:
        fmax = dsp.cumulate_range(CUMU_MAX, fmax, i_start, i_start + n,
                                  src, s0, s0 + n)
    if cfg.b_data_min:
        fmin = dsp.cumulate_range(CUMU_MIN, fmin, i_start, i_start + n,
                                  src, s0, s0 + n)
    # Avg is always kept (`if d['bDataAvg'] or True`, :667); the first
    # sweep copies (runCount == 0, :615-618).
    favg = torch.where(
        first_sweep,
        dsp.cumulate_range(CUMU_RAW, favg, i_start, i_start + n, src, s0,
                           s0 + n),
        dsp.cumulate_range(CUMU_AVG, favg, i_start, i_start + n, src, s0,
                           s0 + n))
    return (cur, fmax, fmin, favg)


def finish_sweep(state: ScanState, curves, cfg: SpecConfig,
                 adj: Optional[torch.Tensor] = None) -> ScanState:
    """Sweep epilogue: heatmap row from the compressed, baseline-adjusted
    Avg, then the ring-index and sweep bump (kspecanal.py:696-697)."""
    cur, fmax, fmin, favg = curves
    a_avg = favg if adj is None else favg - adj
    row = dsp.compress_1d(a_avg, cfg.plt_compress_hm, cfg.x_res)
    heatmap = state.heatmap.index_put((state.hm_index.long(),), row)
    return ScanState(fmax, fmin, favg, cur, heatmap,
                     (state.hm_index + 1) % HEATMAP_ROWS, state.sweep + 1)


def stitch_sweep(state: ScanState, spectra_db: torch.Tensor,
                 cfg: SpecConfig, plan: ScanPlan,
                 adj: Optional[torch.Tensor] = None) -> ScanState:
    """Fold one sweep's band spectra into the global stitched curves, band
    by band in order (kspecanal.py:642-668):

      Cur:  RAW copy of [iOldEnd:iEnd] then AVG over overlap [iStart:iOldEnd]
      Max/Min/Avg: cumulated over [iStart:iDone] from stitched Cur (default)
                   or from the raw band spectrum (bScanRangeBaseDataIsRaw);
                   the first sweep copies into Avg (:615-618).

    ``adj`` is the optional baseline: the heatmap row records the adjusted
    Avg (:670, :697)."""
    first_sweep = state.sweep == 0
    curves = (state.fft_cur, state.fft_max, state.fft_min, state.fft_avg)
    for b, pr in zip(plan.bands, spectra_db):
        curves = band_stitch(curves, pr, b, cfg, first_sweep)
    return finish_sweep(state, curves, cfg, adj)


@functools.lru_cache(maxsize=16)
def _freqs(plan: ScanPlan, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(plan.freqs_all, np.float32)).to(device)


def scan_view(state: ScanState, cfg: SpecConfig, plan: ScanPlan,
              adj: Optional[torch.Tensor] = None) -> ScanView:
    """Display products (kspecanal.py:669-688)."""
    freqs = _freqs(plan, state.fft_avg.device)
    curves = (state.fft_max, state.fft_min, state.fft_avg, state.fft_cur)
    if adj is not None:
        curves = tuple(c - adj for c in curves)
    x, max_l = dsp.compress_xy(freqs, curves[0], cfg.plt_compress, cfg.x_res)
    min_l, avg_l, cur_l = (dsp.compress_1d(c, cfg.plt_compress, cfg.x_res)
                           for c in curves[1:])
    return ScanView(x, max_l, min_l, avg_l, cur_l, state.heatmap)


def sweep_step(state: ScanState, iq_re: torch.Tensor, iq_im: torch.Tensor,
               retune_ok: torch.Tensor, cfg: SpecConfig, plan: ScanPlan,
               adj: Optional[torch.Tensor] = None) -> ScanState:
    """One full sweep: batched band spectra, then the gathered stitch where
    the plan admits it (at one sweep it equals the sequential fold bit for
    bit, in a few launches instead of some seven per band) and the
    sequential :func:`stitch_sweep` otherwise."""
    return stitch(state, band_spectra(iq_re, iq_im, retune_ok, cfg), cfg,
                  plan, adj)


def stitch(state: ScanState, spectra_db: torch.Tensor, cfg: SpecConfig,
           plan: ScanPlan, adj: Optional[torch.Tensor] = None) -> ScanState:
    """One sweep's ``(num_bands, fft_size)`` band spectra folded into the
    state: the gathered stitch where the plan admits it, else the
    sequential :func:`stitch_sweep` (equal bit for bit)."""
    tbl = _gather_tables(cfg, plan, spectra_db.device)
    if tbl is not None:
        return _stitch_sweeps_gathered(state, spectra_db[None], cfg, tbl,
                                       adj)
    return stitch_sweep(state, spectra_db, cfg, plan, adj)


@functools.lru_cache(maxsize=32)
def _gather_stitch_plan(cfg: SpecConfig, plan: ScanPlan):
    """Static gather tables that turn a whole sweep's order-dependent
    stitch into two gathers + elementwise math, or None when the plan's
    geometry does not admit it.

    Derivation (vs kspecanal.py:642-668): band i's overlap-average region
    ``[iStart(i), iOldEnd(i))`` reads Cur values that band i-1 just wrote
    RAW (its fresh region is ``[iOldEnd(i-1), iEnd(i-1))`` and
    ``iEnd(i-1) == iOldEnd(i)``), provided ``iStart(i) >= iOldEnd(i-1)`` —
    true exactly when ``scanRangeNonOverlap >= 0.5``.  Then the sweep's
    final Cur at every grid position is a fixed 1- or 2-term affine
    combination of this sweep's band spectra, independent of the previous
    sweep.  Likewise each band's Max/Min/Avg read segment
    ``[iStart(i), iDone(i))`` is final when read, because band i+1's writes
    start at ``iStart(i+1) == iDone(i)`` and its RAW region at
    ``iEnd(i) >= iDone(i)`` — so the per-band cumulate collapses to one
    elementwise update with the final Cur over ``[0, iDone(last))``.

    The tables are built by simulating the band fold symbolically; a
    geometry the affine form cannot represent (deep overlap < 0.5, whose
    averages read 2-term entries) returns None and the caller keeps the
    sequential fold.  ``bScanRangeBaseDataIsRaw`` also disqualifies (its
    Max/Min/Avg read raw overlapping band segments in band order)."""
    if cfg.b_scan_range_base_data_is_raw:
        return None
    total = plan.total_entries
    f = cfg.fft_size
    band1 = np.full(total, 0, np.int64)
    idx1 = np.zeros(total, np.int64)
    w1 = np.zeros(total, np.float32)
    band2 = np.zeros(total, np.int64)
    idx2 = np.zeros(total, np.int64)
    w2 = np.zeros(total, np.float32)
    written = np.zeros(total, bool)
    for bi, b in enumerate(plan.bands):
        raw_len = b.s_end - b.s_raw_start
        ovl_len = b.i_old_end - b.i_start
        if b.i_done > b.i_start + f:       # read past own write (ovl > 1)
            return None
        # RAW copy of the fresh region (kspecanal.py:642-644)
        p = np.arange(b.i_old_end, b.i_old_end + raw_len)
        band1[p] = bi
        idx1[p] = b.s_raw_start + (p - b.i_old_end)
        w1[p] = 1.0
        w2[p] = 0.0
        written[p] = True
        # overlap-average with the previous band (:645-649)
        if b.i_old_end != 0 and ovl_len > 0:
            q = np.arange(b.i_start, b.i_start + ovl_len)
            if not (written[q].all() and (w2[q] == 0.0).all()):
                return None        # 2-term entry would need a 3rd source
            w1[q] *= 0.5
            band2[q] = bi
            idx2[q] = b.s_start + (q - b.i_start)
            w2[q] = 0.5
    upd_end = plan.bands[-1].i_done
    g1 = (band1 * f + idx1).astype(np.int32)
    g2 = (band2 * f + idx2).astype(np.int32)
    return (g1, w1, g2, w2, written,
            (np.arange(total) < upd_end).astype(bool))


@functools.lru_cache(maxsize=16)
def _gather_tables(cfg: SpecConfig, plan: ScanPlan, device: torch.device):
    """:func:`_gather_stitch_plan` as tensors on ``device`` (gather indices
    int64), or None."""
    tbl = _gather_stitch_plan(cfg, plan)
    if tbl is None:
        return None
    g1, w1, g2, w2, written, upd = tbl
    return tuple(torch.as_tensor(a).to(device) for a in (
        g1.astype(np.int64), w1, g2.astype(np.int64), w2, written, upd))


def sweep_steps(state: ScanState, iq_re: torch.Tensor, iq_im: torch.Tensor,
                retune_ok: torch.Tensor, cfg: SpecConfig, plan: ScanPlan,
                adj: Optional[torch.Tensor] = None) -> ScanState:
    """S sweeps at once: ``iq_*`` (S, num_bands, full_size), ``retune_ok``
    (S, num_bands).  All S*num_bands band curscans run as one batched call;
    where the plan admits it (``_gather_stitch_plan``) the stitch is the
    gathered closed form, else the sequential fold sweep by sweep.  Either
    way it equals S sequential :func:`sweep_step` calls."""
    s, b = iq_re.shape[:2]
    spectra = band_spectra(iq_re.reshape(s * b, -1), iq_im.reshape(s * b, -1),
                           retune_ok.reshape(s * b), cfg)
    spectra = spectra.reshape(s, b, cfg.fft_size)
    # s <= ring depth keeps the batched ring write free of duplicate indices.
    tbl = (_gather_tables(cfg, plan, spectra.device) if s <= HEATMAP_ROWS
           else None)
    if tbl is not None:
        return _stitch_sweeps_gathered(state, spectra, cfg, tbl, adj)
    for i in range(s):
        state = stitch_sweep(state, spectra[i], cfg, plan, adj)
    return state


def sweep_steps_u8(state: ScanState, raw: torch.Tensor,
                   retune_ok: torch.Tensor, cfg: SpecConfig, plan: ScanPlan,
                   adj: Optional[torch.Tensor] = None) -> ScanState:
    """S sweeps from raw capture bytes ``(S, num_bands, 2*full_size)`` (u8
    interleaved I/Q, octave/load_rtlsdr.m), deinterleaved on the device into
    contiguous u8 planes that the curscan kernels decode in their loads."""
    return sweep_steps(state, raw[..., 0::2].contiguous(),
                       raw[..., 1::2].contiguous(), retune_ok, cfg, plan, adj)


def _stitch_sweeps_gathered(state: ScanState, spectra: torch.Tensor,
                            cfg: SpecConfig, tbl,
                            adj: Optional[torch.Tensor]) -> ScanState:
    """S-sweep stitch from the static gather tables: the per-band slice
    updates become two gathers over the flattened (S, B*fft) spectra, and
    the per-sweep folds take closed forms:

      * Max/Min over sweeps are axis reductions;
      * the sequential ``(a+b)/2`` Avg decay has closed-form weights (built
        in float64, then float32), so the Avg after every sweep — each
        needs its heatmap row, kspecanal.py:696-697 — is one
        lower-triangular (S, S) @ (S, total) product;
      * the S heatmap rows go to the ring in one indexed write.

    Keeps the first-sweep RAW Avg seed (kspecanal.py:615-618).  At S=1
    every term is a product by 1, 0 or 0.5, so it equals the sequential
    fold bit for bit."""
    return _sweeps_epilogue(state, _gathered_curves(state, spectra, cfg, tbl),
                            cfg, adj)


def _gathered_curves(state: ScanState, spectra: torch.Tensor,
                     cfg: SpecConfig, tbl):
    """The stitch of :func:`_stitch_sweeps_gathered` without its epilogue:
    ``(cur_all, fmax, fmin, favg_all)``, Cur and Avg after every sweep."""
    g1, w1, g2, w2, written, upd = tbl
    s = spectra.shape[0]
    dev = spectra.device
    flat = spectra.reshape(s, -1)
    cur_all = w1 * flat.index_select(1, g1) + w2 * flat.index_select(1, g2)
    cur_all = torch.where(written[None, :], cur_all, state.fft_cur[None, :])
    first = state.sweep == 0

    fmax, fmin = state.fft_max, state.fft_min
    if cfg.b_data_max:
        fmax = torch.where(upd, torch.maximum(fmax, cur_all.amax(dim=0)),
                           fmax)
    if cfg.b_data_min:
        fmin = torch.where(upd, torch.minimum(fmin, cur_all.amin(dim=0)),
                           fmin)

    # favg after sweep k (0-based):
    #   continuing: 2^-(k+1) * favg_prev + sum_i 2^-(k-i+1) * cur_i
    #   fresh:      2^-k * cur_0        + sum_{i>=1} 2^-(k-i+1) * cur_i
    k = np.arange(s)
    w_cont = np.where(k[None, :] <= k[:, None],
                      2.0 ** -(k[:, None] - k[None, :] + 1.0), 0.0)
    w_fresh = w_cont.copy()
    w_fresh[:, 0] = 2.0 ** -k

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    wm = torch.where(first, f32(w_fresh), f32(w_cont))
    decay = torch.where(first, f32(np.zeros(s)), f32(2.0 ** -(k + 1.0)))
    favg_all = wm @ cur_all + decay[:, None] * state.fft_avg[None, :]
    favg_all = torch.where(upd[None, :], favg_all, state.fft_avg[None, :])
    return cur_all, fmax, fmin, favg_all


def _sweeps_epilogue(state: ScanState, curves, cfg: SpecConfig,
                     adj: Optional[torch.Tensor]) -> ScanState:
    """The heatmap rows of S sweeps from their Avg curves, written to the
    ring in one indexed write, and the new state (the assembly)."""
    cur_all, fmax, fmin, favg_all = curves
    s, dev = favg_all.shape[0], favg_all.device
    a_avg = favg_all if adj is None else favg_all - adj[None, :]
    rows = dsp.compress_1d(a_avg, cfg.plt_compress_hm, cfg.x_res)
    ring_idx = (state.hm_index.long() + torch.arange(s, device=dev)) \
        % HEATMAP_ROWS
    heatmap = state.heatmap.index_put((ring_idx,), rows)
    return ScanState(fmax, fmin, favg_all[-1], cur_all[-1], heatmap,
                     (state.hm_index + s) % HEATMAP_ROWS, state.sweep + s)


def curves_view(curves, heatmap: torch.Tensor, adj: Optional[torch.Tensor],
                cfg: SpecConfig, plan: ScanPlan) -> ScanView:
    """Interim display view from a mid-sweep curve tuple (the per-band
    redraw of kspecanal.py:670-688; the heatmap updates per sweep only)."""
    cur, fmax, fmin, favg = curves
    i0 = torch.zeros((), dtype=torch.int32, device=cur.device)
    return scan_view(ScanState(fmax, fmin, favg, cur, heatmap, i0, i0), cfg,
                     plan, adj)
