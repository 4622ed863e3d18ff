"""The benchmark's frozen roofline arithmetic and table of peaks.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full power limit of 700 W).  A curscan's bound counts the FFT's own
work from the shapes, whatever kernel implements it: ``5 N log2 N + 4 N``
flops a window at the float32 rate, and the two planes read once plus the
float32 spectra written once at the HBM rate.
"""
from __future__ import annotations

import math
from typing import Tuple

FP32_FLOPS = 67e12            # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # 80 GB of HBM3


def curscan_bound_ms(fft_size: int, num_windows: int, full_size: int,
                     blocks: int, plane_bytes: int) -> Tuple[float, str]:
    """The least milliseconds the card could take for the spectra of
    ``blocks`` capture blocks whose planes hold ``plane_bytes`` a sample,
    and what bounds them ('operations' or 'bytes')."""
    n = fft_size
    flops = blocks * num_windows * (5 * n * math.log2(n) + 4 * n)
    nbytes = 2 * blocks * full_size * plane_bytes + 4 * blocks * n
    ops_ms = flops / FP32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms
                                   else "bytes")
