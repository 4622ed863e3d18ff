"""Zero-span mode — the port of ``kspecanal_tpu.models.zerospan``: repeatedly
scan one band, accumulate max/min/avg/cur curves and a waterfall heatmap
ring (the reference's ``zero_span`` loop, kspecanal.py:426-506).

One iteration is a plain function ``(state, iq) -> (state', view)`` on
tensors; state is a NamedTuple of tensors on one device.  The functions
return new tensors and never update their inputs in place.  Every curscan,
serial or batched, goes through ``curscan_auto_batched``, so on the card
every zero-span route runs the CUDA kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from kspecanal_tpu_torch.config import CUMU_AVG, HEATMAP_ROWS, SpecConfig, \
    cumu_weights
from kspecanal_tpu_torch.ops import dsp
from kspecanal_tpu_torch.ops.spectrum import (curscan_auto_batched,
                                              decode_u8, psd_welch)
from kspecanal_tpu_torch.utils.profiling import span, wait


class ZeroSpanState(NamedTuple):
    """Accumulated curves (dB, post display transform) + waterfall ring.

    ``seeded`` is a per-curve bitmask (bit0 Max, bit1 Min, bit2 Avg) for the
    reference's ``Fft.* = None`` first-copy semantics (kspecanal.py:439-442,
    :133-134): a curve cumulates only once its bit is set."""
    fft_max: torch.Tensor      # (fft_size,) float32
    fft_min: torch.Tensor
    fft_avg: torch.Tensor
    fft_cur: torch.Tensor
    heatmap: torch.Tensor      # (HEATMAP_ROWS, hm_width) ring buffer
    hm_index: torch.Tensor     # int32 scalar: next row to write
    iteration: torch.Tensor    # int32 scalar
    seeded: torch.Tensor       # int32 scalar bitmask


class ZeroSpanView(NamedTuple):
    """Per-iteration display products (what the render layer consumes)."""
    x_freqs: torch.Tensor      # (x_res,) compressed frequency axis
    max_lvls: torch.Tensor     # (x_res,) compressed curves (dB)
    min_lvls: torch.Tensor
    avg_lvls: torch.Tensor
    cur_lvls: torch.Tensor
    heatmap: torch.Tensor      # (HEATMAP_ROWS, hm_width)
    spectrum: torch.Tensor     # (fft_size,) linear cumulated magnitudes


def init_state(cfg: SpecConfig, device) -> ZeroSpanState:
    n = cfg.fft_size
    w = dsp.heatmap_width(n, cfg.x_res, cfg.plt_compress_hm)
    z = torch.zeros(n, dtype=torch.float32, device=device)
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    return ZeroSpanState(
        fft_max=z, fft_min=z, fft_avg=z, fft_cur=z,
        heatmap=torch.zeros((HEATMAP_ROWS, w), dtype=torch.float32,
                            device=device),
        hm_index=i0, iteration=i0, seeded=i0)


@functools.lru_cache(maxsize=16)
def _freqs(cfg: SpecConfig, device: torch.device) -> torch.Tensor:
    """fftshifted bin frequencies as float32 on ``device``."""
    f = (np.fft.fftshift(np.fft.fftfreq(cfg.fft_size, 1.0 / cfg.sampling_rate)
                         + cfg.center_freq)).astype(np.float32)
    return torch.as_tensor(f).to(device)


def _seeded_bits(cfg: SpecConfig) -> int:
    return ((1 if cfg.b_data_max else 0) | (2 if cfg.b_data_min else 0)
            | (4 if cfg.b_data_avg else 0))


def _view(cfg: SpecConfig, curves, adj, heatmap, spectrum) -> ZeroSpanView:
    """Baseline-adjust, edge-skip and compress the four curves."""
    if adj is not None:
        curves = [c - adj for c in curves]
    curves = [dsp.skip_edge_bins(c, cfg.tpu_edge_skip_bins) for c in curves]
    freqs = _freqs(cfg, curves[0].device)
    x_freqs, max_l = dsp.compress_xy(freqs, curves[0], cfg.plt_compress,
                                     cfg.x_res)
    min_l, avg_l, cur_l = (dsp.compress_1d(c, cfg.plt_compress, cfg.x_res)
                           for c in curves[1:])
    return ZeroSpanView(x_freqs, max_l, min_l, avg_l, cur_l, heatmap,
                        spectrum)


def display_update(state: ZeroSpanState, spectrum_linear: torch.Tensor,
                   cfg: SpecConfig, adj: Optional[torch.Tensor] = None):
    """Everything after curscan in one zero-span iteration
    (kspecanal.py:469-504): display transform, curve cumulation, baseline
    subtraction, heatmap ring write, level compression."""
    fft_pr = dsp.fftvals_dispproc(spectrum_linear.to(torch.float32),
                                  cfg.zero_span_disp_proc, gain=cfg.gain)

    def cumu(cur, mode, enabled, bit):
        if not enabled:
            return cur
        first = (state.seeded & bit) == 0    # Fft.* still None (:133-134)
        return torch.where(first, fft_pr, dsp.cumulate(mode, cur, fft_pr))

    fft_max = cumu(state.fft_max, "MAX", cfg.b_data_max, 1)
    fft_min = cumu(state.fft_min, "MIN", cfg.b_data_min, 2)
    fft_avg = cumu(state.fft_avg, "AVG", cfg.b_data_avg, 4)
    fft_cur = fft_pr
    seeded = state.seeded | _seeded_bits(cfg)

    a_cur = fft_cur if adj is None else fft_cur - adj
    a_cur = dsp.skip_edge_bins(a_cur, cfg.tpu_edge_skip_bins)
    row = dsp.compress_1d(a_cur, cfg.plt_compress_hm, cfg.x_res)
    heatmap = state.heatmap.index_put((state.hm_index.long(),), row)
    hm_index = (state.hm_index + 1) % HEATMAP_ROWS

    new_state = ZeroSpanState(fft_max, fft_min, fft_avg, fft_cur, heatmap,
                              hm_index, state.iteration + 1, seeded)
    view = _view(cfg, (fft_max, fft_min, fft_avg, fft_cur), adj, heatmap,
                 spectrum_linear)
    return new_state, view


def zero_span_step(state: ZeroSpanState, iq_re: torch.Tensor,
                   iq_im: torch.Tensor, cfg: SpecConfig,
                   adj: Optional[torch.Tensor] = None):
    """One zero-span iteration from a ``(full_size,)`` IQ block: curscan +
    display update (the loop body at kspecanal.py:460-505).

    The block goes through ``curscan_auto_batched`` as a batch of one, so
    the serial route reaches the CUDA kernel too.  ``b_use_psd`` swaps in
    the Welch PSD cross-check (kspecanal.py:374-384)."""
    if cfg.b_use_psd:
        spectrum = psd_welch(decode_u8(iq_re), decode_u8(iq_im), cfg)
    else:
        with span("curscan"):
            spectrum = curscan_auto_batched(iq_re[None], iq_im[None], cfg)[0]
    with span("display"):
        return display_update(state, spectrum, cfg, adj)


def zero_span_steps(state: ZeroSpanState, iq_re: torch.Tensor,
                    iq_im: torch.Tensor, cfg: SpecConfig,
                    adj: Optional[torch.Tensor] = None,
                    with_view: bool = True):
    """K zero-span iterations at once (batched catch-up): ``iq_*`` are
    ``(K, full_size)`` float32 or raw-u8 planes.  Exactly equivalent to
    folding :func:`zero_span_step` K times.  Returns (state',
    view-of-last-iteration), or (state', None) without ``with_view``.

    u8 planes reach the curscan kernel undecoded (the counterpart of the
    JAX ``zero_span_steps_u8_jit``); the PSD cross-check decodes first."""
    if cfg.b_use_psd:
        spec_lin = psd_welch(decode_u8(iq_re), decode_u8(iq_im), cfg)
    else:
        with span("curscan"):
            spec_lin = curscan_auto_batched(iq_re, iq_im, cfg)
    with span("display"):
        return display_updates(state, spec_lin, cfg, adj, with_view)


def zero_span_steps_u8(state: ZeroSpanState, raw: torch.Tensor,
                       cfg: SpecConfig, adj: Optional[torch.Tensor] = None,
                       with_view: bool = True):
    """K iterations from raw capture bytes ``(K, 2*full_size)`` (u8
    interleaved I/Q, octave/load_rtlsdr.m): deinterleaved on the device
    into contiguous u8 planes for :func:`zero_span_steps`."""
    return zero_span_steps(state, raw[..., 0::2].contiguous(),
                           raw[..., 1::2].contiguous(), cfg, adj, with_view)


def display_updates(state: ZeroSpanState, spec_lin: torch.Tensor,
                    cfg: SpecConfig, adj: Optional[torch.Tensor] = None,
                    with_view: bool = True):
    """K display-half iterations over ``spec_lin`` (K, fft_size) linear
    spectra: display transform, seeded curve folds and the heatmap ring,
    identical to K sequential :func:`display_update` calls."""
    k = spec_lin.shape[0]
    dbs = dsp.fftvals_dispproc(spec_lin.to(torch.float32),
                               cfg.zero_span_disp_proc, gain=cfg.gain)

    def weights(w):
        host = torch.as_tensor(w, dtype=dbs.dtype)
        with wait("display_weights"):   # a pageable copy: the host waits
            return host.to(dbs.device)

    def fold(cur, mode, enabled, bit):
        if not enabled:
            return cur
        first = (state.seeded & bit) == 0
        if mode == "MAX":
            batch = dbs.amax(dim=0)
            return torch.where(first, batch, torch.maximum(cur, batch))
        if mode == "MIN":
            batch = dbs.amin(dim=0)
            return torch.where(first, batch, torch.minimum(cur, batch))
        # AVG: seeded: prev*2^-K + sum w_i x_i with w_i = 2^-(K-i);
        # first copy: the closed-form cumu_weights.
        i = np.arange(k)
        seeded_avg = dsp.decay_avg(
            weights(2.0 ** -(k - i.astype(np.float64))), dbs, cur,
            weights(np.float64(2.0) ** -k))
        fresh_avg = dsp.decay_avg(weights(cumu_weights(CUMU_AVG, k)), dbs)
        return torch.where(first, fresh_avg, seeded_avg)

    fft_max = fold(state.fft_max, "MAX", cfg.b_data_max, 1)
    fft_min = fold(state.fft_min, "MIN", cfg.b_data_min, 2)
    fft_avg = fold(state.fft_avg, "AVG", cfg.b_data_avg, 4)
    fft_cur = dbs[-1]
    seeded = state.seeded | _seeded_bits(cfg)

    disp = dbs if adj is None else dbs - adj[None, :]
    disp = dsp.skip_edge_bins(disp, cfg.tpu_edge_skip_bins)
    # After k sequential writes only the LAST min(k, HEATMAP_ROWS) rows
    # remain in the ring; writing exactly those keeps every index distinct
    # (index_put with repeated indices has no ordering guarantee).
    kw = min(k, HEATMAP_ROWS)
    rows = dsp.compress_1d(disp[k - kw:], cfg.plt_compress_hm, cfg.x_res)
    ring_idx = (state.hm_index.long() + (k - kw)
                + torch.arange(kw, device=dbs.device)) % HEATMAP_ROWS
    heatmap = state.heatmap.index_put((ring_idx,), rows)
    hm_index = (state.hm_index + k) % HEATMAP_ROWS

    new_state = ZeroSpanState(fft_max, fft_min, fft_avg, fft_cur, heatmap,
                              hm_index, state.iteration + k, seeded)
    if not with_view:
        return new_state, None
    return new_state, _view(cfg, (fft_max, fft_min, fft_avg, fft_cur), adj,
                            heatmap, spec_lin[-1])
