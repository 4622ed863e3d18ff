"""Mode state across packages: numpy arrays <-> :class:`ZeroSpanState` and
:class:`ScanState`.

The JAX state converts with
``{k: np.asarray(v) for k, v in jax_state._asdict().items()}``; the same
dictionary starts the port from a JAX session's state, and the ``*_to_numpy``
functions give it back, so both packages can continue from one mid-session
state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kspecanal_tpu_torch.models.scan import ScanState
from kspecanal_tpu_torch.models.zerospan import ZeroSpanState

_INT_FIELDS = ("hm_index", "iteration", "seeded", "sweep")


def _from_numpy(cls, d: Dict[str, np.ndarray], device):
    def conv(k):
        dtype = np.int32 if k in _INT_FIELDS else np.float32
        return torch.tensor(np.asarray(d[k], dtype), device=device)
    return cls(*(conv(k) for k in cls._fields))


def _to_numpy(state) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def state_from_numpy(d: Dict[str, np.ndarray], device) -> ZeroSpanState:
    """Dictionary of numpy arrays (the ``ZeroSpanState`` field names) ->
    state on ``device``: curves and heatmap float32, counters int32."""
    return _from_numpy(ZeroSpanState, d, device)


def state_to_numpy(state: ZeroSpanState) -> Dict[str, np.ndarray]:
    """Zero-span state -> dictionary of host numpy arrays."""
    return _to_numpy(state)


def scan_state_from_numpy(d: Dict[str, np.ndarray], device) -> ScanState:
    """Dictionary of numpy arrays (the ``ScanState`` field names) -> state
    on ``device``: curves and heatmap float32, counters int32."""
    return _from_numpy(ScanState, d, device)


def scan_state_to_numpy(state: ScanState) -> Dict[str, np.ndarray]:
    """Scan state -> dictionary of host numpy arrays."""
    return _to_numpy(state)
