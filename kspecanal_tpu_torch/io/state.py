"""Checkpoint / resume of mode state (curves + waterfall ring): the port of
``kspecanal_tpu.io.state``, file for file.

A ``.npz`` holds the state's fields, ``__kind__`` ('zerospan' | 'scan') and
``__fingerprint__`` (the config's identity: fft size, frequency plan, gain,
display widths, window, overlap and cumulate mode).  Loading ignores a file
whose fingerprint differs from the config, the rule the baseline loader
applies (kspecanal.py:759-763).  Arrays convert through
``models/convert.py`` (float32 curves and heatmap, int32 counters), so a
file written by either package loads in the other.
"""
from __future__ import annotations

import zlib
from typing import Union

import numpy as np

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.models import convert
from kspecanal_tpu_torch.models.scan import ScanState
from kspecanal_tpu_torch.models.zerospan import ZeroSpanState
from kspecanal_tpu_torch.utils.logging import log_warn

_STATE_TYPES = {"zerospan": ZeroSpanState, "scan": ScanState}
_FROM_NUMPY = {"zerospan": convert.state_from_numpy,
               "scan": convert.scan_state_from_numpy}


def _fingerprint(cfg: SpecConfig) -> np.ndarray:
    # x_res and the heatmap compress mode set the heatmap ring's width;
    # window, overlap and cumulate mode set the curves' math.  crc32 is
    # stable across processes (hash() is salted).
    return np.asarray([cfg.fft_size, cfg.start_freq or 0.0,
                       cfg.end_freq or 0.0, cfg.sampling_rate, cfg.gain,
                       cfg.x_res,
                       float(zlib.crc32(cfg.plt_compress_hm.encode())),
                       float(zlib.crc32(cfg.window.encode())),
                       cfg.cur_scan_non_overlap,
                       float(zlib.crc32(cfg.cur_scan_cumu_mode.encode()))],
                      np.float64)


def state_path(path: str) -> str:
    """The file a checkpoint path names: ``np.savez`` appends '.npz' to a
    name without it, so save and resume both use the suffixed name."""
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: Union[ZeroSpanState, ScanState],
               cfg: SpecConfig) -> None:
    if isinstance(state, ZeroSpanState):
        kind, arrays = "zerospan", convert.state_to_numpy(state)
    else:
        kind, arrays = "scan", convert.scan_state_to_numpy(state)
    np.savez(state_path(path), __kind__=kind,
             __fingerprint__=_fingerprint(cfg), **arrays)


def load_state(path: str, cfg: SpecConfig, kind: str = "", device="cpu"):
    """The restored state on ``device``, or None (with a warning) when the
    checkpoint was written for another config, holds the other mode's state
    (``kind`` given) or lacks a field."""
    with np.load(state_path(path), allow_pickle=False) as z:
        saved_kind = str(z["__kind__"])
        fp = z["__fingerprint__"]
        want = _fingerprint(cfg)
        if fp.shape != want.shape or not np.array_equal(fp, want):
            log_warn(f"load_state: {state_path(path)} was written for a "
                     f"different config; ignoring")
            return None
        if kind and saved_kind != kind:
            log_warn(f"load_state: {state_path(path)} holds a {saved_kind} "
                     f"state, current mode needs {kind}; ignoring")
            return None
        missing = [f for f in _STATE_TYPES[saved_kind]._fields
                   if f not in z.files]
        if missing:
            log_warn(f"load_state: {state_path(path)} lacks fields "
                     f"{missing} (older state layout); ignoring")
            return None
        return _FROM_NUMPY[saved_kind]({f: z[f] for f in z.files}, device)
