"""Tensor-parallel FFT — the port of ``kspecanal_tpu.parallel.fftshard``:
the DFT's n2 columns split over the mesh's ``time`` ranks (distributed FFT
for very large fftSize).

The two-factor split of ``ops/mxu_fft.py``, laid out so the only
communication is one reduction over the output grid:

    A[n1, n2] = x[n1*N2 + n2]          (columns n2 split across ranks)
    B = F1 @ A_local                    stage 1, contracts n1, column-local
    C = B * T_local                     twiddle, column-local
    D = sum_ranks C_local @ F2_local    n2 is the contraction axis, which
                                        is the split axis: each rank
                                        computes a partial D

Every window's partial D goes into one ``all_reduce(SUM)``; the magnitude,
the window cumulate and the fftshift then run replicated.  The IQ planes
are replicated (rank 0 broadcasts them); use ``timeshard.py`` where the
sample axis should split.  The products are ``torch.matmul`` at the
config's ``tpuPrecision`` (``mxu_fft.class_matmul``: float32 with TF32 off
at HIGHEST, bf16x3 at HIGH, bf16 operands at DEFAULT), as the JAX package
leaves them to XLA at that precision.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from kspecanal_tpu_torch.config import (SpecConfig, cumu_weights, win_adj,
                                        window_lut)
from kspecanal_tpu_torch.ops.cuda_curscan import _factorize
from kspecanal_tpu_torch.ops.dsp import reduce_windows
from kspecanal_tpu_torch.ops.mxu_fft import _dft_tables, class_matmul
from kspecanal_tpu_torch.parallel import mesh as mesh_mod


def supports_fft_sharding(cfg: SpecConfig, num_shards: int) -> bool:
    n1, n2 = _factorize(cfg.fft_size)
    return n2 % num_shards == 0 and n2 > 1


@functools.lru_cache(maxsize=16)
def _tables(cfg: SpecConfig, s: int, k: int, device: torch.device):
    """Rank k's tables: frame-column gather indices (W, n1, n2/S), F1, its
    rows of F2^T (n2/S, n2), and its columns of the twiddles and the
    window (n1, n2/S)."""
    n = cfg.fft_size
    n1, n2 = _factorize(n)
    n2l = n2 // s
    f1r, f1i, f2r, f2i, twr, twi = _dft_tables(n)
    win2 = window_lut(cfg.window, n).reshape(n1, n2).astype(np.float32)
    cols = slice(k * n2l, (k + 1) * n2l)
    col_idx = (np.asarray(cfg.window_starts, np.int64)[:, None, None]
               + np.arange(n1)[:, None] * n2
               + np.arange(k * n2l, (k + 1) * n2l)[None, :])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    return (t(col_idx), t(f1r), t(f1i), t(f2r.T[cols]), t(f2i.T[cols]),
            t(twr[:, cols]), t(twi[:, cols]), t(win2[:, cols]))


def curscan_fft_sharded(iq_re: Optional[torch.Tensor],
                        iq_im: Optional[torch.Tensor], cfg: SpecConfig,
                        mesh) -> torch.Tensor:
    """Tensor-parallel curscan: rank 0's ``(full_size,)`` float planes
    (None on the other ranks) -> the ``(fft_size,)`` spectrum on every
    rank, with the DFT's n2 columns split over the ``time`` ranks."""
    n = cfg.fft_size
    n1, n2 = _factorize(n)
    s = mesh_mod.axis_size(mesh, "time")
    if not supports_fft_sharding(cfg, s):
        raise ValueError(f"fft_size {n} (n2={n2}) not shardable {s} ways")
    planes = None if iq_re is None else (iq_re, iq_im)
    re, im = mesh_mod.replicate(planes, mesh)
    col_idx, f1r, f1i, f2r, f2i, twr, twi, win = _tables(
        cfg, s, mesh_mod.axis_index(mesh, "time"), re.device)
    ar, ai = re[col_idx] * win, im[col_idx] * win        # (W, n1, n2/S)

    def dot(a, b):
        return class_matmul(a, b, cfg.tpu_precision)

    br = dot(f1r, ar) - dot(f1i, ai)                     # stage 1
    bi = dot(f1r, ai) + dot(f1i, ar)
    cr = br * twr - bi * twi                             # twiddle
    ci = br * twi + bi * twr
    # stage 2 partial over this rank's columns: (n1, n2/S) @ (n2/S, n2);
    # the magnitude needs the whole complex value, so re/im are summed
    # across ranks first, every window in one collective
    d = mesh_mod.all_reduce_mode(
        torch.stack([dot(cr, f2r) - dot(ci, f2i),
                     dot(ci, f2r) + dot(cr, f2i)]), "AVG", mesh)
    mag = (win_adj(cfg.window, n) * 2.0 / n) * torch.sqrt(d[0] * d[0]
                                                          + d[1] * d[1])
    # X[k1 + N1*k2] = mag[k1, k2]
    mags = mag.transpose(-1, -2).reshape(cfg.num_windows, n)
    spec = reduce_windows(cfg.cur_scan_cumu_mode, mags,
                          cumu_weights(cfg.cur_scan_cumu_mode,
                                       cfg.num_windows))
    # the JAX module's shift (fftshift for even n)
    return torch.cat([spec[n // 2:], spec[:n // 2]])
