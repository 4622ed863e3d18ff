"""Zero-span state across packages: numpy arrays <-> :class:`ZeroSpanState`.

The JAX state converts with
``{k: np.asarray(v) for k, v in jax_state._asdict().items()}``; the same
dictionary starts the port from a JAX session's state, and
:func:`state_to_numpy` gives it back, so both packages can continue from
one mid-session state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kspecanal_tpu_torch.models.zerospan import ZeroSpanState

_INT_FIELDS = ("hm_index", "iteration", "seeded")


def state_from_numpy(d: Dict[str, np.ndarray], device) -> ZeroSpanState:
    """Dictionary of numpy arrays (the ``ZeroSpanState`` field names) ->
    state on ``device``: curves and heatmap float32, counters int32."""
    def conv(k):
        dtype = np.int32 if k in _INT_FIELDS else np.float32
        return torch.tensor(np.asarray(d[k], dtype), device=device)
    return ZeroSpanState(*(conv(k) for k in ZeroSpanState._fields))


def state_to_numpy(state: ZeroSpanState) -> Dict[str, np.ndarray]:
    """State -> dictionary of host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
