"""Streaming waterfall — the port of ``kspecanal_tpu.parallel.stream``.

A long IQ stream becomes many zero-span iterations processed together:
every heatmap row depends only on its own block, Max/Min curves are
reductions over rows, and the Avg curve's sequential ``(a+b)/2`` decay has
closed-form per-iteration weights (``config.cumu_weights``), so the batched
result equals the serial one.  Curves cumulate in dB (post LogNoGain,
kspecanal.py:469-476); the per-curscan window cumulation is linear.

:func:`waterfall_stream_sharded` splits the blocks over the mesh's
``time`` ranks (``parallel/mesh.py``): every rank runs the same batched
chain on its blocks (the curscan kernel on each card), the curves meet in
one ``all_reduce`` each and the rows stay on their rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from kspecanal_tpu_torch.config import CUMU_AVG, SpecConfig, cumu_weights
from kspecanal_tpu_torch.ops import dsp
from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched
from kspecanal_tpu_torch.parallel import mesh as mesh_mod


class StreamResult(NamedTuple):
    rows: Optional[torch.Tensor]   # (T, hm_width) dB waterfall rows
    fft_max: torch.Tensor          # (fft_size,) curves over the stream (dB)
    fft_min: torch.Tensor
    fft_avg: torch.Tensor
    fft_cur: torch.Tensor          # last iteration's spectrum (dB)


def decode_u8_on_device(raw: torch.Tensor):
    """Raw rtl_sdr bytes ``(..., 2*n)`` u8 interleaved I/Q with the
    value-127 offset (octave/load_rtlsdr.m:8-13) -> float32 planes."""
    x = raw.to(torch.float32) - 127.0
    return x[..., 0::2], x[..., 1::2]


def _weights(w: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """float64 weight vector -> ``like``'s dtype and device (early AVG
    weights of a long stream underflow to 0 in float32, as in JAX)."""
    return torch.as_tensor(w, dtype=like.dtype).to(like.device)


def _batch_products(iq_re, iq_im, cfg: SpecConfig):
    """All blocks' zero-span DSP: batched curscan (the CUDA kernel for
    supported configs on the card) -> display chain per row -> heatmap
    rows.  Returns ``(dB spectra, rows)``."""
    spec_lin = curscan_auto_batched(iq_re, iq_im, cfg)   # (T, fft_size)
    dbs = dsp.fftvals_dispproc(spec_lin, cfg.zero_span_disp_proc,
                               gain=cfg.gain)
    return dbs, dsp.compress_1d(dbs, cfg.plt_compress_hm, cfg.x_res)


def waterfall_stream(iq_re: torch.Tensor, iq_im: torch.Tensor,
                     cfg: SpecConfig) -> StreamResult:
    """``(T, full_size)`` IQ planes -> waterfall rows + exact curves."""
    dbs, rows = _batch_products(iq_re, iq_im, cfg)
    w = _weights(cumu_weights(CUMU_AVG, iq_re.shape[0]), dbs)
    return StreamResult(rows=rows, fft_max=dbs.amax(dim=0),
                        fft_min=dbs.amin(dim=0),
                        fft_avg=dsp.decay_avg(w, dbs), fft_cur=dbs[-1])


def waterfall_stream_u8(raw: torch.Tensor, cfg: SpecConfig) -> StreamResult:
    """``(T, 2*full_size)`` raw capture bytes -> StreamResult.  The bytes
    deinterleave into contiguous u8 planes (1 B/plane/sample) that reach
    the curscan kernel undecoded; the result is bit-identical to decoding
    first."""
    return waterfall_stream(raw[..., 0::2].contiguous(),
                            raw[..., 1::2].contiguous(), cfg)


def waterfall_stream_sharded(iq_re: Optional[torch.Tensor],
                             iq_im: Optional[torch.Tensor], cfg: SpecConfig,
                             mesh) -> StreamResult:
    """``(T, full_size)`` float32 or u8 planes of rank 0 (None on the
    other ranks) split over the mesh's ``time`` ranks (``T % S == 0``).
    Every rank returns its own ``T/S`` rows (``mesh.gather_rows`` brings
    them to rank 0) and the whole stream's exact curves: AVG as a partial
    of the global decay weights and ``all_reduce(SUM)``, MAX/MIN by
    ``all_reduce(MAX/MIN)``, Cur the last rank's last row."""
    s = mesh_mod.axis_size(mesh, "time")
    planes = None if iq_re is None else (iq_re, iq_im)
    re, im = mesh_mod.scatter_rows(planes, mesh, "time")
    k = mesh_mod.axis_index(mesh, "time")
    dbs, rows = _batch_products(re, im, cfg)
    t_local = re.shape[0]
    w = cumu_weights(CUMU_AVG, t_local * s).reshape(s, t_local)[k]
    return StreamResult(
        rows=rows,
        fft_max=mesh_mod.all_reduce_mode(dbs.amax(dim=0), "MAX", mesh),
        fft_min=mesh_mod.all_reduce_mode(dbs.amin(dim=0), "MIN", mesh),
        fft_avg=mesh_mod.all_reduce_mode(dsp.decay_avg(_weights(w, dbs),
                                                       dbs), "AVG", mesh),
        fft_cur=mesh_mod.broadcast_from_last(dbs[-1], mesh))


def _cont_weights(t: int) -> np.ndarray:
    """Decay weights for a NON-first chunk: the incoming average is a live
    value, so every new block decays it by 2 (``f = f_prev*2^-T + sum w_i
    x_i`` with ``w_i = 2^-(t-i)``) — no first-copy doubling."""
    i = np.arange(t)
    return 2.0 ** -(t - i.astype(np.float64))


def waterfall_stream_step(carry, iq_re: torch.Tensor, iq_im: torch.Tensor,
                          cfg: SpecConfig, first: bool):
    """Fold one ``(T_chunk, full_size)`` chunk into the running (max, min,
    avg) curves; returns the new carry and ``(rows, last dB spectrum)``.
    Exact continuation of the serial decay across chunks."""
    fmax, fmin, favg = carry
    dbs, rows = _batch_products(iq_re, iq_im, cfg)
    t = iq_re.shape[0]
    if first:
        favg2 = dsp.decay_avg(_weights(cumu_weights(CUMU_AVG, t), dbs), dbs)
        fmax2, fmin2 = dbs.amax(dim=0), dbs.amin(dim=0)
    else:
        favg2 = dsp.decay_avg(_weights(_cont_weights(t), dbs), dbs, favg,
                              _weights(np.float64(2.0) ** -t, dbs))
        fmax2 = torch.maximum(fmax, dbs.amax(dim=0))
        fmin2 = torch.minimum(fmin, dbs.amin(dim=0))
    return (fmax2, fmin2, favg2), (rows, dbs[-1])


def stream_session(iq_re: Union[np.ndarray, torch.Tensor],
                   iq_im: Union[np.ndarray, torch.Tensor], cfg: SpecConfig,
                   device: Union[str, torch.device],
                   chunk_blocks: int = 256):
    """Process an arbitrarily long recording (1-D planes, numpy arrays or
    tensors) through the waterfall chain in bounded device memory, one
    ``chunk_blocks`` chunk at a time.

    Generator yielding ``(chunk_index, rows)`` per chunk; its return value
    (``StopIteration.value``, or use :func:`run_stream_session`) is the
    final StreamResult with ``rows=None``."""
    full = cfg.full_size
    t_total = iq_re.shape[0] // full
    z = torch.zeros(cfg.fft_size, dtype=torch.float32, device=device)
    carry, cur = (z, z, z), z
    for ci, start in enumerate(range(0, t_total, chunk_blocks)):
        t = min(chunk_blocks, t_total - start)
        re, im = (torch.as_tensor(p[start * full:(start + t) * full])
                  .reshape(t, full).to(device) for p in (iq_re, iq_im))
        carry, (rows, cur) = waterfall_stream_step(carry, re, im, cfg,
                                                   first=(ci == 0))
        yield ci, rows
    return StreamResult(rows=None, fft_max=carry[0], fft_min=carry[1],
                        fft_avg=carry[2], fft_cur=cur)


def run_stream_session(iq_re, iq_im, cfg: SpecConfig,
                       device: Union[str, torch.device],
                       chunk_blocks: int = 256) -> StreamResult:
    """Run the whole recording; return the final curves and all rows
    concatenated (on ``device``)."""
    rows_all = []
    gen = stream_session(iq_re, iq_im, cfg, device, chunk_blocks)
    while True:
        try:
            rows_all.append(next(gen)[1])
        except StopIteration as stop:
            final = stop.value
            break
    return final._replace(rows=torch.cat(rows_all, dim=0))
