"""The display fold on the card: the wrapper of the hand-written CUDA kernel
``csrc/display_fold.cu``, which computes the display half of K zero-span
iterations (``models/zerospan.display_updates``) in one pass over the
``(K, fft_size)`` linear spectra, and its plain PyTorch version.

The kernel replaces no TPU kernel: in the JAX package this chain is jnp
code that XLA fuses.  Its plain version :func:`display_fold_plain` is the
port's PyTorch chain (the display transform, the seeded max/min folds, the
decaying average as one weighted sum, the heatmap ring), run for CPU
tensors and, on the card, for what the kernel does not cover
(:func:`supports`: a ``HistLowClip`` display chain, a CONV heatmap).

One call of :func:`display_fold` on CUDA tensors is two launches
(``launches`` counts them) on the current stream: no host copy, no sync,
no ``.item()``.  It returns the new state with every tensor fresh: the
curves, the heatmap ring and the three counters are views of one
allocation; a disabled curve is the old one.  Its ``fft_avg`` is summed in
float64 and rounded once, so it may differ from the plain version's float32
weighted sum in the last bits; every other output is the plain version's
bit for bit on the card, but an AVG heatmap, whose float32 sums run in
another order than ``torch.mean``'s.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from kspecanal_tpu_torch.config import (COMPRESS_AVG, COMPRESS_MAX,
                                        COMPRESS_MIN, COMPRESS_RAW, CUMU_AVG,
                                        HEATMAP_ROWS, SpecConfig,
                                        cumu_weights)
from kspecanal_tpu_torch.ops import dsp
from kspecanal_tpu_torch.utils.profiling import wait

TILE = 128           # columns of a launch-1 block (32 lanes x 4)
BLOCKS_PER_SM = 3    # launch 1's grid: at most this many blocks an SM
# Heatmap compression modes the kernel takes, by its code.
HM_MODES = {COMPRESS_RAW: 0, COMPRESS_MAX: 1, COMPRESS_MIN: 2,
            COMPRESS_AVG: 3}
DISP_STEPS = ("Raw", "LogNoGain")

launches = 0


class Plan(NamedTuple):
    """Launch 1's split of ``(K, F)``: ``tiles`` of 128 columns by
    ``chunks`` of ``rows`` rows (the last may be short)."""
    tiles: int
    chunks: int
    rows: int


def plan(k: int, f: int, sms: int) -> Plan:
    """At most ``BLOCKS_PER_SM * sms`` blocks, the kernel's occupancy, so
    one wave (more where the column tiles alone are more): as many row
    chunks as the tiles leave room for, none empty."""
    tiles = -(-f // TILE)
    chunks = max(1, min(k, BLOCKS_PER_SM * sms // tiles))
    rows = -(-k // chunks)
    return Plan(tiles, -(-k // rows), rows)


def seeded_bits(cfg: SpecConfig) -> int:
    """The curves a fold seeds: bit0 Max, bit1 Min, bit2 Avg."""
    return ((1 if cfg.b_data_max else 0) | (2 if cfg.b_data_min else 0)
            | (4 if cfg.b_data_avg else 0))


def supports(cfg: SpecConfig) -> bool:
    """The kernel covers display chains of ``Raw`` and ``LogNoGain`` and
    the RAW, MAX, MIN and AVG heatmaps, at any edge skip, with or without a
    baseline, any subset of curves and any K >= 1."""
    return (all(m in DISP_STEPS for m in cfg.zero_span_disp_proc.split("."))
            and cfg.plt_compress_hm in HM_MODES)


def covers(cfg: SpecConfig, device) -> bool:
    """Whether :func:`display_fold` takes the kernel: a CUDA device and a
    configuration it :func:`supports`."""
    return torch.device(device).type == "cuda" and supports(cfg)


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def display_fold_plain(state, spec_lin: torch.Tensor, cfg: SpecConfig,
                       adj: Optional[torch.Tensor] = None):
    """K display-half iterations over ``spec_lin`` (K, fft_size) linear
    spectra in PyTorch: display transform, seeded curve folds and the
    heatmap ring, identical to K sequential ``display_update`` calls.
    Returns the new state (of ``state``'s type)."""
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
    seeded = state.seeded | seeded_bits(cfg)

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
    return type(state)(fft_max, fft_min, fft_avg, fft_cur, heatmap,
                       hm_index, state.iteration + k, seeded)


def _float32(x: torch.Tensor, shape, what: str) -> torch.Tensor:
    """``x`` as the kernel reads it: float32, contiguous, of ``shape``."""
    if x.shape != shape:
        raise ValueError(f"display fold: {what} has shape {tuple(x.shape)}, "
                         f"not {tuple(shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.to(torch.float32).contiguous()
    return x


def _int32(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype != torch.int32 or x.numel() != 1:
        raise ValueError(f"display fold: {what} must be one int32")
    return x


@functools.lru_cache(maxsize=64)
def _arguments(cfg: SpecConfig, k: int, f: int, sms: int):
    """What a launch takes from the configuration and the shape: the
    heatmap's width, the plan, and the C entry's integer arguments."""
    width = dsp.heatmap_width(f, cfg.x_res, cfg.plt_compress_hm)
    return width, plan(k, f, sms), (
        cfg.zero_span_disp_proc.split(".").count("LogNoGain"), cfg.gain,
        cfg.tpu_edge_skip_bins, HM_MODES[cfg.plt_compress_hm], cfg.x_res,
        width, seeded_bits(cfg))


def display_fold(state, spec_lin: torch.Tensor, cfg: SpecConfig,
                 adj: Optional[torch.Tensor] = None):
    """:func:`display_fold_plain`'s result by the kernel on CUDA tensors:
    two launches, nothing waits.  Raises on any other device and for a
    configuration it does not :func:`supports`; the caller
    (``models/zerospan.display_updates``) picks the route by
    :func:`covers`."""
    global launches
    dev = spec_lin.device
    if dev.type != "cuda":
        raise ValueError(f"no display kernel for device {dev}")
    from kspecanal_tpu_torch.ops import _build
    lib = _build.load()
    with torch.cuda.device(dev):
        out = launch(lib, state, spec_lin, cfg, adj, _sms(dev),
                     torch.cuda.current_stream(dev).cuda_stream)
    launches += 2
    return out


def launch(lib, state, spec_lin: torch.Tensor, cfg: SpecConfig,
           adj: Optional[torch.Tensor], sms: int, stream):
    """The kernel's two launches from ``lib`` on ``stream`` (a
    ``cudaStream_t`` as an int), planned for ``sms`` SMs; returns the new
    state.  Checks what the kernel takes and raises on the rest."""
    if not supports(cfg):
        raise ValueError(f"display fold: the kernel does not cover display "
                         f"chain {cfg.zero_span_disp_proc!r} with heatmap "
                         f"compression {cfg.plt_compress_hm!r}")
    if spec_lin.dim() != 2 or spec_lin.shape[0] < 1:
        raise ValueError(f"display fold: spectra of shape "
                         f"{tuple(spec_lin.shape)}, not (K >= 1, F)")
    k, f = spec_lin.shape
    width, pl, args = _arguments(cfg, k, f, sms)
    spec = _float32(spec_lin, (k, f), "spectra")
    prev = (_float32(state.fft_max, (f,), "fft_max"),
            _float32(state.fft_min, (f,), "fft_min"),
            _float32(state.fft_avg, (f,), "fft_avg"))
    heat = _float32(state.heatmap, (HEATMAP_ROWS, width), "heatmap")
    counters = (_int32(state.seeded, "seeded"),
                _int32(state.hm_index, "hm_index"),
                _int32(state.iteration, "iteration"))
    base = None if adj is None else _float32(adj, (f,), "adj")
    dev = spec.get_device()
    if any(x.get_device() != dev for x in (heat, *prev, *counters)) or (
            base is not None and base.get_device() != dev):
        raise ValueError("display fold: the state, the spectra and the "
                         "baseline must be on one device")
    # Outputs: max, min, avg, cur (F each), the ring, the three counters.
    n_ring = HEATMAP_ROWS * width
    out = torch.empty(4 * f + n_ring + 3, dtype=torch.float32,
                      device=spec.device)
    # Scratch: the chunks' float64 sums, then their max and min.
    scratch = torch.empty(pl.chunks * f * 16, dtype=torch.uint8,
                          device=spec.device)
    o, s = out.data_ptr(), scratch.data_ptr()
    n_sum = pl.chunks * f * 8
    err = lib.kspec_display_fold(
        spec.data_ptr(), k, f, args[0], args[1],
        None if base is None else base.data_ptr(), *args[2:],
        prev[0].data_ptr(), prev[1].data_ptr(), prev[2].data_ptr(),
        counters[0].data_ptr(), counters[1].data_ptr(),
        counters[2].data_ptr(), heat.data_ptr(), o, o + 4 * f, o + 8 * f,
        o + 12 * f, o + 16 * f, o + 4 * (4 * f + n_ring), s + n_sum,
        s + n_sum + pl.chunks * f * 4, s, pl.chunks, pl.rows,
        int(f % 4 == 0 and spec.data_ptr() % 16 == 0), stream)
    if err:
        raise RuntimeError(f"display fold kernel launch failed: CUDA error "
                           f"{err}")
    mx, mn, av, cur, ring, ints = out.split_with_sizes(
        (f, f, f, f, n_ring, 3))
    hm_index, iteration, seeded = ints.view(torch.int32).unbind()
    return type(state)(
        mx if cfg.b_data_max else state.fft_max,
        mn if cfg.b_data_min else state.fft_min,
        av if cfg.b_data_avg else state.fft_avg,
        cur, ring.view(HEATMAP_ROWS, width), hm_index, iteration, seeded)
