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
leaves to ``torch.matmul`` as the JAX package leaves them to XLA, at the
config's ``tpuPrecision`` (:func:`class_matmul`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

PRECISIONS = ("DEFAULT", "HIGH", "HIGHEST")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest, ties to even) and widened back
    to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor):
    """The bf16x3 split of float32 ``x``: ``(hi, lo)`` with ``hi`` = x
    rounded to bf16 and ``lo`` = (x - hi) rounded to bf16, both as float32."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def split3_bf16(x: torch.Tensor):
    """The three-part bf16 split of float32 ``x`` that HIGHEST's six passes
    take (``pallas_curscan._make_dot``, Mosaic's HIGHEST): ``(hi, mid,
    lo)`` with ``hi`` = x rounded to bf16, ``mid`` = (x - hi) rounded to
    bf16 and ``lo`` = (x - hi - mid) rounded to bf16, each difference in
    float32 (exact), all three as float32."""
    hi = round_bf16(x)
    r = x - hi
    mid = round_bf16(r)
    return hi, mid, round_bf16(r - mid)


def class_matmul(a: torch.Tensor, b: torch.Tensor,
                 precision: str) -> torch.Tensor:
    """``a @ b`` of float32 operands at a ``tpuPrecision`` class, summed in
    float32: HIGHEST is the float32 product (PyTorch's default leaves TF32
    off, and the port never turns it on); DEFAULT rounds both
    operands to bf16 first (one bf16 pass, float32 sums); HIGH is the
    bf16x3 split of ``pallas_curscan._make_dot.dot3``,
    ``a_hi b_hi + (a_hi b_lo + a_lo b_hi)``.  Products of bf16 values are
    exact in float32, so each class differs from the tensor cores' only in
    the order of its float32 sums."""
    prec = precision.upper()
    if prec == "DEFAULT":
        a, b = round_bf16(a), round_bf16(b)
    elif prec == "HIGH":
        a_hi, a_lo = split_bf16(a)
        b_hi, b_lo = split_bf16(b)
        return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)
    elif prec != "HIGHEST":
        raise ValueError(f"unknown tpuPrecision {precision!r} (one of "
                         f"{PRECISIONS})")
    return a @ b


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
    from kspecanal_tpu_torch.ops.cuda_curscan import _factorize
    n1, n2 = _factorize(n)
    return _dft_tables_for(n, n1, n2)
