"""Expert-parallel scan — the port of ``kspecanal_tpu.parallel.bandshard``:
a sweep's retune bands split over the mesh's ``band`` ranks and stitched
after an all-gather (BASELINE.json config 4).

Each band's curscan is independent (the reference runs them serially,
kspecanal.py:621-693), so the per-band work, all of the FFTs, splits over
the ranks: each runs ``models/scan.band_spectra`` on its bands (the FFT
kernel for fmScan, the packed kernel for quickFullScan, on its card).  The
order-dependent overlap-average stitch (kspecanal.py:642-650) needs every
band's spectrum, so the display spectra are all-gathered (num_bands *
fft_size floats, small next to the IQ) and the stitch runs replicated.

The band count is padded up to a multiple of the rank count with sentinel
bands, zero IQ with ``retune_ok`` False (the failed-retune marker), that
are sliced off after the gather; each band keeps its own rows, so the
window starts of every band stay as they are.
"""
from __future__ import annotations

from typing import Optional

import torch

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.models.scan import (ScanPlan, ScanState,
                                             band_spectra, stitch)
from kspecanal_tpu_torch.parallel import mesh as mesh_mod


def _pad_bands(x: torch.Tensor, padded: int) -> torch.Tensor:
    pad = padded - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def band_spectra_sharded(iq_re: Optional[torch.Tensor],
                         iq_im: Optional[torch.Tensor],
                         retune_ok: Optional[torch.Tensor], cfg: SpecConfig,
                         plan: ScanPlan, mesh) -> torch.Tensor:
    """Rank 0's sweep, ``(B, full_size)`` planes and ``(B,)`` retune flags
    (None on the other ranks) -> the ``(B, fft_size)`` dB band spectra of
    ``band_spectra`` on every rank, each rank computing its share of the
    bands."""
    s = mesh_mod.axis_size(mesh, "band")
    padded = -(-plan.num_bands // s) * s
    sweep = None
    if iq_re is not None:
        sweep = [_pad_bands(x, padded) for x in
                 (iq_re, iq_im, retune_ok.to(torch.uint8))]
    re, im, ok = mesh_mod.scatter_rows(sweep, mesh, "band")
    local = band_spectra(re, im, ok.bool(), cfg)
    return mesh_mod.all_gather_rows(local, mesh, "band")[:plan.num_bands]


def sweep_step_band_sharded(state: ScanState, iq_re: Optional[torch.Tensor],
                            iq_im: Optional[torch.Tensor],
                            retune_ok: Optional[torch.Tensor],
                            cfg: SpecConfig, plan: ScanPlan, mesh,
                            adj: Optional[torch.Tensor] = None) -> ScanState:
    """Sharded ``models.scan.sweep_step``: the same (state, sweep) -> state
    contract, the sweep given on rank 0, with the bands split over the
    mesh's ``band`` ranks; every rank stitches its copy of the state.
    ``adj`` feeds the heatmap row's baseline as in the unsharded stitch."""
    spectra = band_spectra_sharded(iq_re, iq_im, retune_ok, cfg, plan, mesh)
    return stitch(state, spectra, cfg, plan, adj)
