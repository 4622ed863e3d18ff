"""Value-transform and accumulation ops — the port of
``kspecanal_tpu.ops.dsp`` (the reference's ``data_proc`` / ``data_cumu`` /
``fftvals_dispproc`` layer and its plot compression).

Every transform works on the LAST axis, so one call serves a single curve
``(N,)`` and a batch of rows ``(T, N)`` alike: where the JAX package vmaps a
1-D function over rows, this module reduces per row with ``keepdim``.  In
particular :func:`hist_low_clip` takes its min/max per row, so the batch axis
never leaks into its edge.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from kspecanal_tpu_torch.config import (
    COMPRESS_AVG,
    COMPRESS_CONV,
    COMPRESS_MAX,
    COMPRESS_MIN,
    COMPRESS_RAW,
    CUMU_AVG,
    CUMU_MAX,
    CUMU_MIN,
    CUMU_RAW,
    conv_kernel,
)
from kspecanal_tpu_torch.utils.profiling import wait

# ---------------------------------------------------------------------------
# data_proc transforms (kspecanal.py:88-121)
# ---------------------------------------------------------------------------


def hist_low_clip(vals: torch.Tensor) -> torch.Tensor:
    """Clip everything below the 2nd 10-bin-histogram edge up to that edge,
    ``min + (max - min)/10`` of each row (kspecanal.py:97-99)."""
    lo = vals.amin(dim=-1, keepdim=True)
    edge = lo + (vals.amax(dim=-1, keepdim=True) - lo) / 10.0
    return torch.maximum(vals, edge)


def clip2minamp(vals: torch.Tensor, min_amp: float) -> torch.Tensor:
    """Noise-floor clip to ``minAmp4Clip`` (kspecanal.py:100-101)."""
    return vals.clamp_min(min_amp)


def _inf_to(out: torch.Tensor, inf_to: Optional[float]) -> torch.Tensor:
    if inf_to is None:
        return out
    return torch.where(torch.isinf(out), torch.full_like(out, inf_to), out)


def log_db(vals: torch.Tensor, inf_to: Optional[float] = None) -> torch.Tensor:
    """``10*log10`` with optional +/-inf replacement (kspecanal.py:102-105)."""
    return _inf_to(10.0 * torch.log10(vals), inf_to)


def log_no_gain(vals: torch.Tensor, gain: float,
                inf_to: Optional[float] = None) -> torch.Tensor:
    """dB minus the applied tuner gain (kspecanal.py:106-112); infinities
    are replaced AFTER the subtraction, as in the reference."""
    return _inf_to(10.0 * torch.log10(vals) - gain, inf_to)


def conv_smooth(vals: torch.Tensor) -> torch.Tensor:
    """Smooth each row with the kaiser(128, 64) kernel, numpy's 'same'
    length, then overwrite the first/last 12 points with the row mean
    (kspecanal.py:113-120)."""
    kern = torch.as_tensor(conv_kernel(), dtype=vals.dtype)
    with wait("conv_kernel"):   # a pageable copy: the host waits
        kern = kern.to(vals.device)
    n, m = vals.shape[-1], kern.shape[0]
    rows = vals.reshape(-1, 1, n)
    # conv1d correlates; flipping the kernel makes it numpy's convolve.
    full = F.conv1d(rows, kern.flip(0).view(1, 1, m), padding=m - 1)
    start = (min(n, m) - 1) // 2
    out = full[..., start:start + max(n, m)].reshape(*vals.shape[:-1], -1)
    avg = out.mean(dim=-1, keepdim=True)
    out = out.clone()
    out[..., :12] = avg
    out[..., -12:] = avg
    return out


def data_proc(vals: torch.Tensor, proc: str, *, gain: float = 0.0,
              min_amp: float = 0.0,
              inf_to: Optional[float] = None) -> torch.Tensor:
    """Dispatch a single named transform (kspecanal.py:88-121)."""
    if proc == "HistLowClip":
        return hist_low_clip(vals)
    if proc == "Clip2MinAmp":
        return clip2minamp(vals, min_amp)
    if proc == "Log":
        return log_db(vals, inf_to)
    if proc == "LogNoGain":
        return log_no_gain(vals, gain, inf_to)
    if proc == "Conv":
        return conv_smooth(vals)
    raise ValueError(f"unknown data_proc {proc!r}")


def fftvals_dispproc(vals: torch.Tensor, disp_proc_mode: str, *, gain: float,
                     inf_to: Optional[float] = None) -> torch.Tensor:
    """Dot-separated chain of display transforms (kspecanal.py:150-165):
    'Raw', 'LogNoGain' and 'HistLowClip' only."""
    for mode in disp_proc_mode.split("."):
        if mode == "Raw":
            continue
        if mode == "LogNoGain":
            vals = log_no_gain(vals, gain, inf_to)
        elif mode == "HistLowClip":
            vals = hist_low_clip(vals)
        else:
            raise ValueError(f"unknown DispProcMode {mode!r}")
    return vals


# ---------------------------------------------------------------------------
# data_cumu (kspecanal.py:124-147)
# ---------------------------------------------------------------------------


def cumulate(mode: str, cur: Optional[torch.Tensor],
             new: torch.Tensor) -> torch.Tensor:
    """One full-range cumulate step: RAW copies, AVG is the sequential
    ``(cur+new)/2`` decay (not a running mean), MAX/MIN elementwise.
    ``cur=None`` returns ``new`` (kspecanal.py:133-134)."""
    if cur is None or mode == CUMU_RAW:
        return new
    if mode == CUMU_AVG:
        return (cur + new) / 2.0
    if mode == CUMU_MAX:
        return torch.maximum(cur, new)
    if mode == CUMU_MIN:
        return torch.minimum(cur, new)
    raise ValueError(f"unknown cumuMode {mode!r}")


def cumulate_range(mode: str, cur: torch.Tensor, c_start: int, c_end: int,
                   new: torch.Tensor, n_start: int,
                   n_end: int) -> torch.Tensor:
    """Range-wise cumulate of ``new[n_start:n_end]`` into
    ``cur[c_start:c_end]`` (the general signature of ``data_cumu``,
    kspecanal.py:124-147); returns a new tensor, ``cur`` is untouched."""
    seg = new[n_start:n_end]
    if mode != CUMU_RAW:
        old = cur[c_start:c_end]
        if mode == CUMU_AVG:
            seg = (old + seg) / 2.0
        elif mode == CUMU_MAX:
            seg = torch.maximum(old, seg)
        elif mode == CUMU_MIN:
            seg = torch.minimum(old, seg)
        else:
            raise ValueError(f"unknown cumuMode {mode!r}")
    out = cur.clone()
    out[c_start:c_end] = seg
    return out


def decay_avg(w: torch.Tensor, dbs: torch.Tensor,
              prev: Optional[torch.Tensor] = None,
              prev_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decaying average of K dB rows ``dbs (K, F)`` as one weighted sum,
    ``prev*prev_w + sum_t w[t]*dbs[t]`` (``prev`` None: the first copy).  A
    -inf bin (the dB of an exactly-zero spectrum bin), in ``prev`` or in any
    row, keeps the average at -inf as the serial fold ``(old + new)/2``
    does, also where its float32 weight has underflowed to 0 and the product
    alone would give NaN."""
    out = torch.einsum("t,tf->f", w, dbs)
    neg = torch.isneginf(dbs).any(dim=0)
    if prev is not None:
        out = prev * prev_w + out
        neg = neg | torch.isneginf(prev)
    return out.masked_fill(neg, float("-inf"))


def reduce_windows(mode: str, mags: torch.Tensor,
                   weights: Optional[np.ndarray]) -> torch.Tensor:
    """Collapse the window axis (``-2``) of ``(..., W, fft_size)`` per-window
    spectra, equivalent to the reference's serial per-window ``data_cumu``
    loop (kspecanal.py:385-395): AVG/RAW weight with the closed-form
    :func:`kspecanal_tpu.config.cumu_weights`, MAX/MIN reduce."""
    if mode in (CUMU_AVG, CUMU_RAW):
        assert weights is not None
        w = torch.as_tensor(weights, dtype=mags.dtype, device=mags.device)
        return torch.einsum("w,...wf->...f", w, mags)
    if mode == CUMU_MAX:
        return mags.amax(dim=-2)
    if mode == CUMU_MIN:
        return mags.amin(dim=-2)
    raise ValueError(f"unknown cumuMode {mode!r}")


# ---------------------------------------------------------------------------
# Plot compression (kspecanal.py:168-237)
# ---------------------------------------------------------------------------


def compress_1d(data: torch.Tensor, mode: str, x_res: int) -> torch.Tensor:
    """Compress the last axis (N points) to ``x_res`` display points: RAW
    passes through, CONV smooths, MAX/MIN/AVG reduce ``(x_res, N//x_res)``
    groups; N < x_res passes through (kspecanal.py:184-200)."""
    if mode == COMPRESS_RAW:
        return data
    if mode == COMPRESS_CONV:
        return conv_smooth(data)
    if mode in (COMPRESS_MAX, COMPRESS_MIN, COMPRESS_AVG):
        cols = data.shape[-1] // x_res
        if cols == 0:
            return data
        t = data[..., : x_res * cols].reshape(*data.shape[:-1], x_res, cols)
        if mode == COMPRESS_MAX:
            return t.amax(dim=-1)
        if mode == COMPRESS_MIN:
            return t.amin(dim=-1)
        return t.mean(dim=-1)
    raise ValueError(f"unknown plot-compress mode {mode!r}")


def compress_xy(x: torch.Tensor, y: torch.Tensor, mode: str, x_res: int):
    """Compress a curve for display: x averaged, y per user mode
    (kspecanal.py:205-221).  RAW/CONV leave x untouched."""
    if mode in (COMPRESS_RAW, COMPRESS_CONV):
        return x, compress_1d(y, mode, x_res)
    return compress_1d(x, COMPRESS_AVG, x_res), compress_1d(y, mode, x_res)


def compress_2d(data: torch.Tensor, mode: str, x_res: int) -> torch.Tensor:
    """Per-row compress of a ``(rows, N)`` heatmap block
    (kspecanal.py:224-237)."""
    return compress_1d(data, mode, x_res)


def heatmap_width(fft_size: int, x_res: int, mode: str) -> int:
    """Display width of a heatmap row (kspecanal.py:449-455)."""
    if mode in (COMPRESS_MAX, COMPRESS_MIN, COMPRESS_AVG):
        return min(fft_size, x_res)
    return fft_size


def skip_edge_bins(curve_db: torch.Tensor, k: int) -> torch.Tensor:
    """Floor the outer ``k`` bins of each curve (last axis) to its INNER
    minimum so compression and peak marking never pick them (the
    reference's TODO, README.rst:608-611).  No-op for ``k <= 0``."""
    if k <= 0:
        return curve_db
    n = curve_db.shape[-1]
    inner_min = curve_db[..., k:n - k].amin(dim=-1, keepdim=True)
    idx = torch.arange(n, device=curve_db.device)
    edge = (idx < k) | (idx >= n - k)
    return torch.where(edge, inner_min, curve_db)
