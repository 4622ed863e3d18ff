"""Top-K peak marking with minimum frequency separation — the math of the
reference's ``plot_highs`` (kspecanal.py:243-272), decoupled from
matplotlib.

Runs on the host over the already-compressed display curve (<= x_res
points): sorting tiny vectors is not device work, and the reference's
greedy separation rule is inherently sequential.

A copy of ``kspecanal_tpu/ops/peaks.py``: that module is free of JAX, but
importing it runs ``kspecanal_tpu/ops/__init__.py``, which imports JAX.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class Peak(NamedTuple):
    freq: float
    level: float


def find_peaks(freqs: np.ndarray, levels: np.ndarray,
               num_markers: int = 5,
               delta4marking: float = 0.025) -> List[Peak]:
    """Greedy top-K by level, skipping candidates within
    ``delta4marking * (freqs[-1]-freqs[0])`` of an already-marked peak
    (kspecanal.py:249-269)."""
    freqs = np.asarray(freqs)
    levels = np.asarray(levels)
    freq_range = freqs[-1] - freqs[0]
    min_sep = delta4marking * freq_range
    order = np.argsort(levels)
    marked: List[Peak] = []
    for idx in order[::-1]:
        f, l = float(freqs[idx]), float(levels[idx])
        if all(abs(p.freq - f) >= min_sep for p in marked):
            marked.append(Peak(f, l))
            if len(marked) >= num_markers:
                break
    return marked
