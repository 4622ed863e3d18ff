"""Sequence-parallel curscan — the port of
``kspecanal_tpu.parallel.timeshard``: one IQ capture split into contiguous
time-blocks over the mesh's ``time`` ranks, with a ring halo exchange of
the window-overlap samples (BASELINE.json config 5: fftSize 16384, 90%
overlap, time-blocks sharded with halo exchange).

The reference's overlapped sliding loop (kspecanal.py:385-395) is
overlap-save framing: window i reads samples ``[int(i*hop), int(i*hop) +
fftSize)``, so adjacent blocks share up to ``fftSize - hop`` samples.  Each
rank

  1. sends its first ``halo`` samples to its left neighbour on the ring
     (and receives its right-edge overlap from the right),
  2. frames, windows and FFTs its own windows (``torch.fft``, as JAX runs
     ``jnp.fft`` here with no Pallas kernel),
  3. reduces the per-window spectra across ranks: AVG/RAW a weighted
     partial and ``all_reduce(SUM)`` (the sequential ``(a+b)/2`` decay has
     closed-form per-window weights, ``config.cumu_weights``, and every
     rank knows its windows' global indices, so the decay stays exact),
     MAX/MIN masked ``all_reduce(MAX/MIN)``.

The window bookkeeping is host NumPy (:func:`make_time_shard_plan`, a copy
of the JAX package's, held equal to it by tests/test_torch_standalone.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from kspecanal_tpu_torch.config import (CUMU_AVG, CUMU_MAX, CUMU_MIN,
                                        CUMU_RAW, SpecConfig, cumu_weights,
                                        win_adj, window_lut)
from kspecanal_tpu_torch.parallel import mesh as mesh_mod


@dataclasses.dataclass(frozen=True)
class TimeShardPlan:
    """Static sharding tables for one (config, num_shards) pair."""
    num_shards: int
    block: int            # samples per shard (full_size / S)
    halo: int             # right-halo samples exchanged (fft_size, rounded)
    quota: int            # windows processed per shard (max, padded)
    # Tables, all shaped (S, quota):
    local_starts: Tuple[Tuple[int, ...], ...]   # window start within shard
    valid: Tuple[Tuple[bool, ...], ...]
    weights: Tuple[Tuple[float, ...], ...]      # global cumu weights (or 0)


def make_time_shard_plan(cfg: SpecConfig, num_shards: int) -> TimeShardPlan:
    full = cfg.full_size
    if full % num_shards:
        raise ValueError(f"full_size {full} not divisible by {num_shards}")
    block = full // num_shards
    starts = np.asarray(cfg.window_starts)
    if block < cfg.fft_size:
        raise ValueError(
            f"block {block} < fft_size {cfg.fft_size}: too many shards "
            f"(halo would span multiple neighbors)")
    halo = cfg.fft_size  # windows extend at most fft_size-1 past a block
    owner = starts // block
    quota = int(np.max(np.bincount(owner, minlength=num_shards)))
    w_global = cumu_weights(cfg.cur_scan_cumu_mode, len(starts))
    local_starts = np.zeros((num_shards, quota), np.int64)
    valid = np.zeros((num_shards, quota), bool)
    weights = np.zeros((num_shards, quota), np.float64)
    fill = np.zeros(num_shards, np.int64)
    for gi, s in enumerate(starts):
        k = int(owner[gi])
        j = int(fill[k]); fill[k] += 1
        local_starts[k, j] = s - k * block
        valid[k, j] = True
        if w_global is not None:
            weights[k, j] = w_global[gi]
    return TimeShardPlan(
        num_shards=num_shards, block=block, halo=halo, quota=quota,
        local_starts=tuple(map(tuple, local_starts.tolist())),
        valid=tuple(map(tuple, valid.tolist())),
        weights=tuple(map(tuple, weights.tolist())))


def _shard_body(iq_re: torch.Tensor, iq_im: torch.Tensor, cfg: SpecConfig,
                plan: TimeShardPlan, mesh) -> torch.Tensor:
    """One rank's part on its ``(block,)`` float slices: halo exchange,
    framing, window, FFT, magnitude, the cross-rank reduction, fftshift.
    Returns the whole spectrum on every rank of the ``time`` group."""
    k = mesh_mod.axis_index(mesh, "time")
    n, dev = cfg.fft_size, iq_re.device
    halo = mesh_mod.ring_shift_left(
        torch.stack([iq_re[:plan.halo], iq_im[:plan.halo]]), mesh, "time")
    ext_re = torch.cat([iq_re, halo[0]])
    ext_im = torch.cat([iq_im, halo[1]])
    starts = torch.as_tensor(plan.local_starts[k], device=dev)
    idx = starts[:, None] + torch.arange(n, device=dev)[None, :]
    win = torch.as_tensor(window_lut(cfg.window, n), dtype=ext_re.dtype,
                          device=dev)
    spec = torch.fft.fft(torch.complex(ext_re[idx] * win, ext_im[idx] * win),
                         dim=-1)
    mags = (win_adj(cfg.window, n) * 2.0 / n) * spec.abs()  # (quota, n)
    mode = cfg.cur_scan_cumu_mode
    valid = torch.as_tensor(plan.valid[k], device=dev)[:, None]
    if mode in (CUMU_AVG, CUMU_RAW):
        w = torch.as_tensor(plan.weights[k], dtype=torch.float32,
                            device=dev).to(mags.dtype)
        local = torch.einsum("w,wf->f", w, mags)
    elif mode == CUMU_MAX:
        local = torch.where(valid, mags, 0.0).amax(dim=0)
    elif mode == CUMU_MIN:
        local = torch.where(valid, mags, float("inf")).amin(dim=0)
    else:
        raise ValueError(mode)
    return torch.fft.fftshift(mesh_mod.all_reduce_mode(local, mode, mesh,
                                                       "time"))


def curscan_time_sharded(iq_re: Optional[torch.Tensor],
                         iq_im: Optional[torch.Tensor], cfg: SpecConfig,
                         mesh) -> torch.Tensor:
    """Sharded ``curscan``: the ``(full_size,)`` float planes of rank 0
    (None elsewhere) -> the ``(fft_size,)`` spectrum on every rank, with
    the sample axis split over the mesh's ``time`` ranks and the halo
    exchanged on the ring."""
    plan = make_time_shard_plan(cfg, mesh_mod.axis_size(mesh, "time"))
    planes = None if iq_re is None else (iq_re, iq_im)
    re, im = mesh_mod.scatter_rows(planes, mesh, "time")
    return _shard_body(re, im, cfg, plan, mesh)
