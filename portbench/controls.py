"""The controls and the planted faults of the comparison that decides
``correct``: runs that must come out not correct.

A control runs the cell below the precision its configuration states
(``tpuPrecision HIGHEST``, a float64 data path with float32 spectra):

- ``HIGH`` and ``DEFAULT``: the program's own lower-precision paths, the
  tensor-core kernels on bfloat16 parts (three passes and one);
- ``float32``: the plain reference, put in the program's place as the
  spectrum stage and computed in float32 throughout.

A fault breaks the timed path underneath a sound run:

- ``state_unchanged``: a session step returns its state as it got it;
- ``half_batch``: the spectrum stage computes half of each batch and puts
  the mean of that half in place of the rest;
- ``altered``: one bin of each batch's first spectrum is changed by 1%
  where the spectrum stage makes it.

``readings.py`` reads each on the card at the cell's own size; the CPU
tests read each at a tiny size.  The benchmark's own runs plant nothing.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Dict, Iterator, Optional

import torch

from portbench import reference

PRECISIONS = ("HIGH", "DEFAULT")
_ZS = "kspecanal_tpu_torch.models.zerospan"


def _float32_reference(spec: Dict):
    g = reference.geometry(spec)

    def plant(orig):
        def curscan(iq_re, iq_im, cfg):
            return reference.spectra(iq_re, iq_im, g, torch.float32)
        return curscan
    return plant


def _state_unchanged(spec: Dict):
    def plant(orig):
        def step(state, *args, **kwargs):
            return state, None
        return step
    return plant


def _half_batch(spec: Dict):
    def plant(orig):
        def curscan(iq_re, iq_im, cfg):
            half = max(1, iq_re.shape[0] // 2)
            out = orig(iq_re[:half], iq_im[:half], cfg)
            rest = out.mean(dim=0, keepdim=True).expand(
                iq_re.shape[0] - half, -1)
            return torch.cat([out, rest])
        return curscan
    return plant


def _altered(spec: Dict):
    def plant(orig):
        def curscan(iq_re, iq_im, cfg):
            out = orig(iq_re, iq_im, cfg).clone()
            out[0, cfg.fft_size // 3] *= 1.01
            return out
        return curscan
    return plant


# name: (the program's attribute that is replaced, the planting)
PATCHES = {
    "float32": ("curscan_auto_batched", _float32_reference),
    "state_unchanged": ("zero_span_steps", _state_unchanged),
    "half_batch": ("curscan_auto_batched", _half_batch),
    "altered": ("curscan_auto_batched", _altered),
}
NAMES = PRECISIONS + tuple(PATCHES)


@contextlib.contextmanager
def planted(name: str, spec: Dict) -> Iterator[Optional[str]]:
    """Plant the control or fault ``name`` for a configuration's ``spec``
    while the block runs; yields the ``tpuPrecision`` to run at (None: as
    configured)."""
    if name in PRECISIONS:
        yield name
        return
    if name not in PATCHES:
        raise KeyError(f"no control or fault {name!r} (has {NAMES})")
    attr, make = PATCHES[name]
    zs = importlib.import_module(_ZS)
    orig = getattr(zs, attr)
    setattr(zs, attr, make(spec)(orig))
    try:
        yield None
    finally:
        setattr(zs, attr, orig)
