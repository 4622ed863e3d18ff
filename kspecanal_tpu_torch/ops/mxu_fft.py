"""DFT tables of the two-factor (Bailey four-step) split — the part of
``kspecanal_tpu.ops.mxu_fft`` that the bin-sharded FFT
(``parallel/fftshard.py``) needs, copied (tests/test_torch_standalone.py
holds it equal to the original):

    n = n1*N2 + n2,  k = k1 + N1*k2
    B[k1, n2] = sum_n1 F1[k1, n1] * x[n1*N2 + n2]
    C[k1, n2] = B[k1, n2] * T[k1, n2],  T = W_N^(k1*n2)
    X[k1 + N1*k2] = sum_n2 C[k1, n2] * F2[k2, n2]

The split is ``ops/cuda_curscan._factorize``'s (the route's copy of the
factor rule).  The products are plain matrix products, which the port
leaves to ``torch.matmul`` in float32 as the JAX package leaves them to
XLA.
"""
from __future__ import annotations

import functools

import numpy as np

from kspecanal_tpu_torch.ops.cuda_curscan import _factorize


@functools.lru_cache(maxsize=64)
def _dft_tables_for(n: int, n1: int, n2: int):
    """Precompute (F1re, F1im, F2re, F2im, Tre, Tim) float32 tables for an
    explicit n = n1*n2 split."""
    assert n1 * n2 == n, (n, n1, n2)
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    f1 = np.exp(-2j * np.pi * np.outer(k1, k1) / n1)          # (n1, n1)
    f2 = np.exp(-2j * np.pi * np.outer(k2, k2) / n2)          # (n2, n2)
    tw = np.exp(-2j * np.pi * np.outer(k1, k2) / n)           # (n1, n2)
    return tuple(np.asarray(a, np.float32) for a in (
        f1.real, f1.imag, f2.real, f2.imag, tw.real, tw.imag))


def _dft_tables(n: int):
    """Tables for the default `_factorize` split of n."""
    n1, n2 = _factorize(n)
    return _dft_tables_for(n, n1, n2)
