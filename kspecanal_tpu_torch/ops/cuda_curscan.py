"""Fused curscan on the card: the wrappers of the hand-written CUDA kernels
that port ``kspecanal_tpu.ops.pallas_curscan.curscan_fused_sublane`` (the
sublane Pallas kernel, ``_kernel_sublane``) and
``pallas_curscan.curscan_fused`` (the lane kernel, ``_kernel``): both
compute the same function, in other layouts.

Per IQ block ``(full_size,)`` a kernel frames at every window start,
decodes u8 planes in its loads, windows, takes the N-point DFT, takes
``|.|``, folds the windows (AVG/RAW weighted sum, MAX/MIN extrema,
``winAdj*2/N`` folded in) and writes the natural-order, fftshifted
``(fft_size,)`` spectrum, in float32.  The dispatcher
(``spectrum.curscan_auto_batched``) sends them HIGHEST; HIGH and DEFAULT go
to the tensor-core kernels of ``ops/cuda_tc.py`` (:func:`kernel_route`).

The FFT kernel ``csrc/curscan_fft.cu`` serves a CUDA tensor at every config
the JAX dispatcher sends to a Pallas curscan kernel (:func:`kernel_route`):
the sublane predicate (every multiple of 128 from 256 up) and the lane
predicate (fft >= 2048, not prime, window starts multiples of
``_factorize(fft)[1]``), counted in ``launches``.  The powers of two up to
131072 run its radix-16 Stockham kernel in float64 (above 8192 points
n/8192 blocks a window, each reading its chunks of the frame from device
memory), every other size its mixed-radix kernel (odd prime passes first,
as symmetric float64 butterflies, large primes as float64 tensor-core
products; a cluster above fft 16384 where a power of two <= 8 splits the
window, else a radix-c step through a scratch buffer in device memory).
:func:`fft_plan` gives the thread blocks a window takes and the route.

The direct two-stage DFT kernel ``csrc/curscan_sublane.cu`` serves no
session: :func:`curscan_sublane_direct` (counted in ``direct_launches``,
fft <= ``DIRECT_MAX_FFT_SIZE``) is the yardstick the FFT kernel is timed
against.

A CUDA tensor launches a kernel or raises; a CPU tensor runs
:func:`curscan_fused_sublane_plain`, the ``torch.fft`` chain, and never
builds anything.

Performance forensics (profiling only; no session calls them):
``curscan_fused_sublane(..., ablate=keys)`` removes stages as the JAX
kernel's ``ablate`` keys do (``scripts/kernel_ablate.py``), and
:func:`curscan_stage_ablate` stops after one stage of ``STAGES``, the port of
``scripts/roofline_r2.py``'s ``_kernel_ablate`` (K4).  Both take apart the
two-stage DFT that the JAX kernels compute, at the config's class: the
tensor-core kernels' forensic builds (``ops/cuda_tc.py``: K4 on Kernel A's
cut-offs, the keys on the ablate builds of Kernels A and C), at HIGHEST in
their six-pass builds.  Their plain versions share the removals of stages
of :func:`two_stage_chain`.  :func:`curscan_mixed_stage` cuts the FFT
kernel's mixed-radix form off after one stage of ``MIXED_STAGES`` (its
stage table, ``scripts/mixed_stages.py``; plain version
:func:`curscan_mixed_stage_plain`), counted in ``forensic_launches``, and
:func:`curscan_fft_stage` the power-of-two kernel after one stage of
``FFT_STAGES`` on its forensic builds (``scripts/fft_stages.py``; plain
version :func:`curscan_fft_stage_plain`), counted in ``fft_stage_launches``
(the parent form's build in ``fft_parent_launches``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kspecanal_tpu_torch.config import (CUMU_AVG, CUMU_MAX, CUMU_MIN,
                                        CUMU_RAW, SpecConfig, cumu_weights,
                                        win_adj, window_lut)
from kspecanal_tpu_torch.ops import spectrum

_N2 = 128
# The direct kernel's shared memory per thread block: the windowed frame (N
# float2) plus up to 32 stage-1 rows and the two root tables, (32 * 128 +
# N/128 + 128) complex values of 8 bytes (float32 sums, fft <= 8192) or 16
# bytes (float64 sums above).  fft 16384 needs 200,704 of the 232,448 bytes
# a Hopper block may use; 32768 would need 333,824.
DIRECT_MAX_FFT_SIZE = 16384
# The FFT kernel: one thread block holds up to 16384 points (204,800 bytes
# of shared memory: the padded buffer and the fold), 16 points a thread
# (the last thread ragged where 16 does not divide them); up to
# CLUSTER_MAX_FFT_SIZE the blocks of a window form a cluster of at most 8
# (the portable cluster size) where such a power of two divides it, else
# they read a scratch buffer of at most SCRATCH_BYTES (one IQ block's at
# least).
FFT_BLOCK_SIZE = 16384
_RADIX = 16
_MAX_CLUSTER = 8
CLUSTER_MAX_FFT_SIZE = _MAX_CLUSTER * FFT_BLOCK_SIZE
# The power-of-two kernel's float64 form (:func:`fft_plan`): one block up
# to FFT64_BLOCK_SIZE points (a float64 buffer of 128 KB), n/8192 such
# blocks a window above.
FFT64_BLOCK_SIZE = 8192
SCRATCH_BYTES = 1 << 30
# The lane kernel's smallest fft in the JAX dispatcher (_fused_choice).
LANE_MIN_FFT_SIZE = 2048
# The JAX package's per-size factor overrides (mxu_fft.FACTOR_OVERRIDES).
FACTOR_OVERRIDES: dict = {2048: (128, 16)}
# Window groups: enough thread blocks for 8 per SM (see window_groups).
_BLOCKS_PER_SM = 8
_FOLD = {CUMU_AVG: 0, CUMU_RAW: 0, CUMU_MAX: 1, CUMU_MIN: 2}

# K4's cut-off stages (Kernel A's KSPEC_TC_STOP values, in order) and the
# ablate keys (the ablate builds' AB_* bits).  'concat' restacks no blocks
# in the JAX kernel; the Hopper kernels never restack, so it removes
# nothing.
STAGES = ("read", "frame", "s1", "s1tw", "s2", "full")
ABLATE_KEYS = {"win": 1, "stage1": 2, "twiddle": 4, "stage2": 8, "sqrt": 16,
               "cumulate": 32, "concat": 0}
# Keys that pick the 3M or 4M complex form of the HIGH/DEFAULT classes
# (ops/cuda_tc.py); they cut nothing.
_PRECISION_KEYS = ("force3m", "no3m")
# The mixed kernel's cut-off stages (profiling only): after the block input
# (loads, window, the cluster's or scratch's radix-c step), after the odd
# passes, after the power-of-two passes, or in full.  The kernel's `stop`
# argument: 0 runs in full, i + 1 stops after MIXED_STAGES[i].
MIXED_STAGES = ("input", "odd", "pow2", "full")
# The power-of-two kernel's cut-off stages (its forensic builds
# -DKSPEC_FFT_STOP=1..4, in order): after the block input, after pass 1,
# after the radix-16 passes, or in full.
FFT_STAGES = ("input", "pass1", "radix16", "full")

# The HIGH and DEFAULT classes' tensor-core kernels (ops/cuda_tc.py): Kernel
# A takes the sublane predicate up to n1 = fft/128 = 128, Kernel C the rest
# of what the JAX dispatcher sends to a Pallas kernel, on its split.
TC_CLASSES = ("HIGH", "DEFAULT")
TC_MAX_FFT_SIZE = 128 * _N2
# The JAX dispatcher's fft from which the lane kernel may take a config that
# the sublane kernel takes too (_fused_choice).
LANE_OVER_SUBLANE_FFT_SIZE = 16384

launches = 0            # the FFT kernel (csrc/curscan_fft.cu)
direct_launches = 0     # the direct-DFT kernel (the FFT kernel's yardstick)
forensic_launches = 0   # the mixed kernel's cut-offs
fft_stage_launches = 0  # the power-of-two kernel's cut-off builds
fft_parent_launches = 0  # its parent form's build


def _jax_predicate(cfg: SpecConfig) -> bool:
    """``pallas_curscan.supports_fused_sublane``: fft_size a multiple of 128
    with n1 >= 2 and full_size a multiple of 128 (window starts may be any
    static offsets)."""
    n = cfg.fft_size
    return n % _N2 == 0 and n // _N2 >= 2 and cfg.full_size % _N2 == 0


@functools.lru_cache(maxsize=64)
def _factorize(n: int) -> Tuple[int, int]:
    """``mxu_fft._factorize``: n = n1*n2 with n1 >= n2, n2 the largest
    divisor <= sqrt(n) (unless overridden in ``FACTOR_OVERRIDES``); a prime
    gives (n, 1)."""
    if n in FACTOR_OVERRIDES:
        return FACTOR_OVERRIDES[n]
    for n2 in range(int(np.sqrt(n)), 0, -1):
        if n % n2 == 0:
            return (n // n2, n2)
    return (n, 1)


def supports_fused(cfg: SpecConfig) -> bool:
    """``pallas_curscan.supports_fused``, the lane kernel's predicate: n2 >
    1 (fft not prime) and every window start a multiple of n2."""
    n2 = _factorize(cfg.fft_size)[1]
    return n2 > 1 and all(s % n2 == 0 for s in cfg.window_starts)


def kernel_route(cfg: SpecConfig) -> Optional[str]:
    """Which kernel serves ``cfg`` on the card, wherever the JAX
    dispatcher's ``_fused_choice`` picks a Pallas curscan kernel (the
    sublane predicate, or the lane predicate at fft >= 2048).  At
    tpuPrecision HIGH and DEFAULT a tensor-core kernel of ``ops/cuda_tc.py``:
    ``"tc"`` (Kernel A) for the sublane predicate up to fft
    ``TC_MAX_FFT_SIZE``, ``"tc_split"`` (Kernel C, on :func:`tc_split`'s
    split) for every other such config (K3 off the 128 grid, the grid above
    fft 16384); at HIGHEST ``"fft"``, the float64 FFT kernel; else None."""
    lane = cfg.fft_size >= LANE_MIN_FFT_SIZE and supports_fused(cfg)
    if not (lane or _jax_predicate(cfg)):
        return None
    if cfg.tpu_precision.upper() not in TC_CLASSES:
        return "fft"
    if _jax_predicate(cfg) and cfg.fft_size <= TC_MAX_FFT_SIZE:
        return "tc"
    return "tc_split"


def tc_split(cfg: SpecConfig, u8: bool = False) -> Tuple[int, int]:
    """``(n1, n2)``: the split of the Pallas kernel that the JAX dispatcher's
    ``_fused_choice`` picks for ``cfg`` on ``u8`` (raw u8) or float32 planes
    (``spectrum.py:205-217``): ``(fft // 128, 128)`` where it takes the
    sublane kernel, ``_factorize(fft)`` where it takes the lane kernel.
    Where both predicates hold, the sublane kernel below fft 16384, and
    from there at HIGH and on u8 planes at DEFAULT; the lane kernel
    otherwise.  Raises where neither holds."""
    n = cfg.fft_size
    sub = _jax_predicate(cfg)
    lane = n >= LANE_MIN_FFT_SIZE and supports_fused(cfg)
    if not (sub or lane):
        raise ValueError(f"no Pallas curscan kernel takes fft_size {n} with "
                         f"these window starts")
    if sub and lane and n >= LANE_OVER_SUBLANE_FFT_SIZE:
        prec = cfg.tpu_precision.upper()
        sub = prec == "HIGH" or (prec == "DEFAULT" and u8)
    return (n // _N2, _N2) if sub else _factorize(n)


def supports_fused_sublane(cfg: SpecConfig) -> bool:
    """The FFT kernel takes every config of the JAX sublane and lane
    predicates, at every class (the dispatcher sends it HIGHEST).  Configs
    outside take the ``torch.fft`` chain."""
    return kernel_route(cfg) is not None


def supports_direct(cfg: SpecConfig) -> bool:
    """What the direct two-stage DFT kernel takes: the JAX predicate up to
    ``DIRECT_MAX_FFT_SIZE``."""
    return _jax_predicate(cfg) and cfg.fft_size <= DIRECT_MAX_FFT_SIZE


@functools.lru_cache(maxsize=64)
def fft_plan(n: int, parent: bool = False) -> Tuple[int, bool]:
    """``(c, through_scratch)``: the thread blocks c of the FFT kernel for
    one n-point window, each an (n/c)-point FFT, n/c <= 16384, and whether
    they read a scratch buffer.  The powers of two up to
    ``CLUSTER_MAX_FFT_SIZE`` (the power-of-two kernel's float64 form): one
    block up to ``FFT64_BLOCK_SIZE`` points, else c = n/8192 blocks that
    each read their chunks of the frame (``parent``: the parent form's
    build, -DKSPEC_FFT_PARENT=1: one block up to ``FFT_BLOCK_SIZE``, else a
    cluster of c = n/16384).  Every other n (the mixed kernel): 1 up to fft
    16384; up to ``CLUSTER_MAX_FFT_SIZE`` the smallest power of two with
    n/c <= 16384 (a cluster, c <= 8) where it divides n; else the smallest
    divisor of n with n/c <= 16384 (a multiple of 16 where 16 divides n),
    through the scratch (a radix-c step in device memory)."""
    if not runs_mixed_kernel(n):
        block = FFT_BLOCK_SIZE if parent else FFT64_BLOCK_SIZE
        return max(1, n // block), False
    if n <= FFT_BLOCK_SIZE:
        return 1, False
    if n <= CLUSTER_MAX_FFT_SIZE:
        c = 2
        while c * FFT_BLOCK_SIZE < n:
            c *= 2
        if n % c == 0:
            return c, False
    c = -(-n // FFT_BLOCK_SIZE)
    while n % c or (n % _RADIX == 0 and (n // c) % _RADIX):
        c += 1
    return c, True


def pass1_radix(m: int) -> int:
    """The radix of the power-of-two kernel's first pass in an m-point
    block: ``m / 16**q`` in {2, 4, 8, 16}, q = (log2 m - 1) // 4 radix-16
    passes after it."""
    log2m = m.bit_length() - 1
    return m >> (4 * ((log2m - 1) // 4))


def cluster_size(n: int) -> int:
    """The thread blocks c of the FFT kernel for one n-point window
    (:func:`fft_plan`)."""
    return fft_plan(n)[0]


def scratch_chunk(t: int, n: int, n_windows: int) -> int:
    """IQ blocks a launch of the FFT kernel's scratch route takes: as many as fit ``SCRATCH_BYTES`` of
    ``(n_windows, n)`` complex float32 sub-sequences each, at least 1."""
    return max(1, min(t, SCRATCH_BYTES // (n_windows * n * 8)))


def window_groups(t: int, n: int, n_windows: int, sms: int) -> int:
    """The FFT kernel's window groups G per IQ block: the fewest that give
    ``8 * sms`` thread blocks (``t * G * cluster_size(n)``), at most one per
    window, at least 1, so ``G = min(W, ceil(8 * sms / (t * c)))``.  Group
    g folds the windows ``[g*W//G, (g+1)*W//G)`` in order; the groups'
    partial folds are combined in the order g = 0..G-1."""
    return groups_for(t, cluster_size(n), n_windows, sms)


def groups_for(t: int, c: int, n_windows: int, sms: int) -> int:
    """:func:`window_groups` for c thread blocks a window."""
    want = -(-_BLOCKS_PER_SM * sms // (t * c))
    return max(1, min(n_windows, want))


def curscan_fused_sublane_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                                cfg: SpecConfig) -> torch.Tensor:
    """The plain PyTorch version of the kernel: decode u8, then the
    ``torch.fft`` curscan chain.  ``(T, full_size)`` -> ``(T, fft_size)``."""
    return spectrum.curscan_batched(spectrum.decode_u8(iq_re),
                                    spectrum.decode_u8(iq_im), cfg)


@functools.lru_cache(maxsize=32)
def _tables(n: int, window: str, starts: tuple, mode: str,
            device: torch.device):
    """Device tables of one config: int32 starts, float32 per-window
    weights (the closed-form decay weights times winAdj*2/N, built in
    float64 and rounded once, as the JAX kernel does; MAX/MIN carry the
    scale alone), the window and the N roots of unity."""
    scale = win_adj(window, n) * 2.0 / n
    w = cumu_weights(mode, len(starts))
    weights = np.full(len(starts), scale) if w is None else w * scale
    roots = np.exp(-2j * np.pi * np.arange(n) / n)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(device)

    return (dev(starts, np.int32), dev(weights, np.float32),
            dev(window_lut(window, n), np.float32),
            dev(np.stack([roots.real, roots.imag], axis=-1), np.float32))


@functools.lru_cache(maxsize=32)
def _tables64(n: int, window: str, device: torch.device):
    """The float64 form's own tables: the window (float64) and the N roots
    of unity as ``(N, 2)`` float64 (re, im)."""
    roots = np.exp(-2j * np.pi * np.arange(n) / n)
    return (torch.as_tensor(window_lut(window, n), dtype=torch.float64
                            ).to(device),
            torch.as_tensor(np.stack([roots.real, roots.imag], axis=-1)
                            ).to(device))


def odd_primes(m: int) -> list:
    """The prime factors of m's odd part, ascending, with multiplicity: the
    radices of the mixed kernel's odd passes for an m-point block."""
    while m and m % 2 == 0:
        m //= 2
    out, p = [], 3
    while m > 1:
        if p * p > m:
            p = m
        while m % p == 0:
            out.append(p)
            m //= p
        p += 2
    return out


@functools.lru_cache(maxsize=32)
def _pass_roots(m_pts: int, device: torch.device) -> torch.Tensor:
    """The mixed kernel's float64 tables for an m_pts-point block, one after
    the other: for each odd pass (Ns, p) in order (``odd_primes``, Ns the
    product of the primes before), W_{Ns p}^u for u < Ns p, as ``(K, 2)``
    float64 (re, im), built in float64 (one entry if there is no odd
    pass)."""
    parts, ns = [np.ones(1)], 1
    for p in odd_primes(m_pts):
        parts.append(np.exp(-2j * np.pi * np.arange(ns * p) / (ns * p)))
        ns *= p
    w = np.concatenate(parts[1:] or parts)
    return torch.as_tensor(np.stack([w.real, w.imag], axis=-1)).to(device)


def check_planes(iq_re: torch.Tensor, iq_im: torch.Tensor, cfg: SpecConfig):
    """Raise unless the planes are what a curscan kernel takes: both float32
    or both uint8, one device, contiguous ``(T, full_size)``."""
    if iq_re.dtype not in (torch.float32, torch.uint8) \
            or iq_im.dtype != iq_re.dtype:
        raise TypeError(f"planes must both be float32 or both uint8, got "
                        f"{iq_re.dtype} and {iq_im.dtype}")
    if iq_re.device != iq_im.device:
        raise ValueError(f"planes on different devices: {iq_re.device}, "
                         f"{iq_im.device}")
    want = (iq_re.shape[0] if iq_re.dim() == 2 else -1, cfg.full_size)
    if iq_re.shape != want or iq_im.shape != iq_re.shape:
        raise ValueError(f"planes must be (T, {cfg.full_size}), got "
                         f"{tuple(iq_re.shape)} and {tuple(iq_im.shape)}")
    if not (iq_re.is_contiguous() and iq_im.is_contiguous()):
        raise ValueError("planes must be contiguous")


def ablate_mask(ablate) -> int:
    """The ablate builds' AB_* mask of ``ablate`` keys (the 3M/4M keys
    ``force3m``/``no3m`` add no bit); raises on an unknown key."""
    if isinstance(ablate, str):
        raise TypeError(f"ablate takes a sequence of keys, not the string "
                        f"{ablate!r}")
    mask = 0
    for key in ablate:
        if key in _PRECISION_KEYS:
            continue
        if key not in ABLATE_KEYS:
            raise ValueError(f"unknown ablate key {key!r}; known: "
                             f"{sorted(ABLATE_KEYS) + list(_PRECISION_KEYS)}")
        mask |= ABLATE_KEYS[key]
    return mask


def _launch_direct(lib_fn, iq_re, iq_im, cfg) -> torch.Tensor:
    """Launch the direct kernel on the planes' device and current stream;
    raise on a launch error."""
    dev = iq_re.device
    out = torch.empty((iq_re.shape[0], cfg.fft_size), dtype=torch.float32,
                      device=dev)
    if iq_re.shape[0] == 0:
        return out
    n = cfg.fft_size
    starts, weights, window, roots = _tables(
        n, cfg.window, cfg.window_starts, cfg.cur_scan_cumu_mode, dev)
    with torch.cuda.device(dev):
        err = lib_fn(
            iq_re.data_ptr(), iq_im.data_ptr(),
            int(iq_re.dtype == torch.uint8), out.data_ptr(),
            starts.data_ptr(), weights.data_ptr(), window.data_ptr(),
            roots.data_ptr(), iq_re.shape[0], cfg.full_size, n,
            len(cfg.window_starts), _FOLD[cfg.cur_scan_cumu_mode],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib_fn)
    return out


def _raise_on(err: int, lib_fn) -> None:
    if err:
        raise RuntimeError(f"{lib_fn.__name__} kernel launch failed: CUDA "
                           f"error {err}")


def _launch_fft(lib, iq_re, iq_im, cfg, stop: int = 0,
                parent: bool = False) -> torch.Tensor:
    """Launch the FFT kernel (and, with more than one window group, its
    combine pass; on the scratch route of :func:`fft_plan` its radix-c
    step, chunk by chunk) on the planes' device and current stream.
    ``stop`` > 0 cuts the mixed kernel off after ``MIXED_STAGES[stop - 1]``
    (profiling only).  The powers of two take :func:`fft_plan`'s blocks
    (``parent``: the library is a build of the parent form) and, in the
    float64 form, its float64 tables."""
    dev = iq_re.device
    t, n = iq_re.shape[0], cfg.fft_size
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    w = len(cfg.window_starts)
    c, via_scratch = fft_plan(n, parent)
    f64 = not parent and not runs_mixed_kernel(n)
    chunk = scratch_chunk(t, n, w) if via_scratch else t
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = groups_for(chunk, c, w, sms)
    part = (torch.empty((t, groups, n), dtype=torch.float32, device=dev)
            if groups > 1 else None)
    scratch = (torch.empty((chunk, w, n, 2), dtype=torch.float32, device=dev)
               if via_scratch else None)
    starts, weights, window, roots = _tables(
        n, cfg.window, cfg.window_starts, cfg.cur_scan_cumu_mode, dev)
    if f64:
        window, roots = _tables64(n, cfg.window, dev)
    pass_roots = _pass_roots(n // c, dev)
    with torch.cuda.device(dev):
        err = lib.kspec_curscan_fft(
            iq_re.data_ptr(), iq_im.data_ptr(),
            int(iq_re.dtype == torch.uint8), out.data_ptr(),
            0 if part is None else part.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), starts.data_ptr(),
            weights.data_ptr(), window.data_ptr(), roots.data_ptr(),
            pass_roots.data_ptr(), t,
            cfg.full_size, n, c, chunk, w, groups,
            _FOLD[cfg.cur_scan_cumu_mode], stop,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib.kspec_curscan_fft)
    return out


def _cuda_lib(dev: torch.device):
    if dev.type != "cuda":
        raise ValueError(f"no curscan kernel for device {dev}")
    from kspecanal_tpu_torch.ops import _build
    return _build.load()


def curscan_fused_sublane(iq_re: torch.Tensor, iq_im: torch.Tensor,
                          cfg: SpecConfig, *, ablate=()) -> torch.Tensor:
    """``(T, full_size)`` float32 or raw-u8 planes -> ``(T, fft_size)``
    fftshifted linear spectra from the FFT kernel, which computes every
    class in float64 (the dispatcher sends it HIGHEST and HIGH/DEFAULT to
    the tensor-core kernels of ``ops/cuda_tc.py``, :func:`kernel_route`).
    CUDA tensors launch the kernel on the current stream without
    synchronising; CPU tensors run its plain version.

    ``ablate`` (forensics only): keys naming stages to remove
    (``ABLATE_KEYS``; the spectra are then wrong by construction) run the
    tensor-core kernel of the config's class with those stages removed, on
    the JAX kernel's configs (the sublane predicate): the ablate build of
    Kernel A up to fft 16384, else of Kernel C on the split ``(n / 128,
    128)`` (``cuda_tc.curscan_tc`` / ``curscan_tc_split(..., ablate)``,
    counted in ``cuda_tc.tc_ablate_launches`` /
    ``tc_split_ablate_launches``; at HIGHEST their six-pass builds), with
    ``force3m`` / ``no3m`` picking the complex form (``force3m`` first, as
    in JAX).  Without a stage key the FFT kernel runs, which has no
    complex-matmul form: ``no3m`` is its own form and changes nothing, and
    ``force3m`` raises ValueError (the tensor-core kernels take their form
    as ``cuda_tc.curscan_tc(..., form)``)."""
    global launches
    ablate_mask(ablate)
    if kernel_route(cfg) is None:
        raise ValueError(f"config not supported by the curscan kernels "
                         f"(fft_size {cfg.fft_size}, full_size "
                         f"{cfg.full_size})")
    stages = tuple(k for k in ablate if k not in _PRECISION_KEYS)
    if stages:
        return _class_ablate(iq_re, iq_im, cfg, ablate, stages)
    if "force3m" in ablate:
        raise ValueError(
            "ablate key 'force3m' picks the 3M form of the tensor-core "
            "kernels (cuda_tc.curscan_tc, curscan_tc_split): the float64 FFT "
            "kernel has no complex-matmul form")
    check_planes(iq_re, iq_im, cfg)
    dev = iq_re.device
    if dev.type == "cpu":
        return curscan_fused_sublane_plain(iq_re, iq_im, cfg)
    out = _launch_fft(_cuda_lib(dev), iq_re, iq_im, cfg)
    launches += 1
    return out


def _class_ablate(iq_re, iq_im, cfg, ablate, stages) -> torch.Tensor:
    """``curscan_fused_sublane(..., ablate)`` with stage keys ``stages``:
    Kernel A's or Kernel C's ablate build at the config's class (see
    there)."""
    from kspecanal_tpu_torch.ops import cuda_tc
    if not _jax_predicate(cfg):
        raise ValueError(f"ablate takes the sublane kernel's configs (fft a "
                         f"multiple of 128 from 256), not fft "
                         f"{cfg.fft_size}")
    form = ("force3m" if "force3m" in ablate else
            "no3m" if "no3m" in ablate else None)
    if cfg.fft_size <= TC_MAX_FFT_SIZE:
        return cuda_tc.curscan_tc(iq_re, iq_im, cfg, form, stages)
    return cuda_tc.curscan_tc_split(iq_re, iq_im, cfg, form,
                                    (cfg.fft_size // _N2, _N2), stages)


def curscan_sublane_direct(iq_re: torch.Tensor, iq_im: torch.Tensor,
                           cfg: SpecConfig) -> torch.Tensor:
    """The direct two-stage DFT kernel (``csrc/curscan_sublane.cu``) on
    ``(T, full_size)`` planes: no session runs it; it is the FFT kernel's
    yardstick.  CPU tensors run the plain version."""
    global direct_launches
    if not supports_direct(cfg):
        raise ValueError(f"config not supported by the direct curscan kernel "
                         f"(fft_size {cfg.fft_size}, full_size "
                         f"{cfg.full_size})")
    check_planes(iq_re, iq_im, cfg)
    if iq_re.device.type == "cpu":
        return curscan_fused_sublane_plain(iq_re, iq_im, cfg)
    lib = _cuda_lib(iq_re.device)
    out = _launch_direct(lib.kspec_curscan_sublane, iq_re, iq_im, cfg)
    direct_launches += 1
    return out


def check_stage_config(iq_re: torch.Tensor, cfg: SpecConfig, stage: str):
    """Raise unless K4 takes the case: a known stage, the JAX sublane
    predicate up to fft ``TC_MAX_FFT_SIZE`` (Kernel A's), float32 planes,
    128-aligned window starts, AVG weights and ``full_size`` a multiple of
    ``fft_size`` (the JAX script frames by ``s // 128`` and reads whole
    n1-row slabs)."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages: {STAGES}")
    if not (_jax_predicate(cfg) and cfg.fft_size <= TC_MAX_FFT_SIZE):
        raise ValueError(f"K4 takes Kernel A's configs (fft a multiple of "
                         f"128 up to {TC_MAX_FFT_SIZE}), not fft_size "
                         f"{cfg.fft_size}")
    if iq_re.dtype != torch.float32:
        raise TypeError(f"the stage ablation takes float32 planes, got "
                        f"{iq_re.dtype}")
    if any(s % _N2 for s in cfg.window_starts):
        raise ValueError("the stage ablation takes 128-aligned window starts "
                         "only (50% overlap at fft >= 256)")
    if cfg.cur_scan_cumu_mode != CUMU_AVG:
        raise ValueError(f"the stage ablation folds with the AVG weights; "
                         f"got {cfg.cur_scan_cumu_mode}")
    if cfg.full_size % cfg.fft_size:
        raise ValueError(f"full_size {cfg.full_size} is not a whole number "
                         f"of fft_size {cfg.fft_size} slabs")


def curscan_stage_ablate(iq_re: torch.Tensor, iq_im: torch.Tensor,
                         cfg: SpecConfig, stage: str) -> torch.Tensor:
    """K4: Kernel A at the config's class cut off after ``stage``
    (``STAGES``), each block reduced to ``(fft_size/128, 128)``:
    ``(T, full_size)`` float32 -> ``(T, n1, 128)`` in the JAX script's
    layout (row k1, or m1 for 'frame'; column m2 or k2; unshifted); 'full'
    is Kernel A's output under ``out[b, (k1 + n1*k2 + N/2) % N] = K4[b, k1,
    k2]`` (:func:`spectrum_to_stage_layout`).  Kernel A's cut-off builds
    (``cuda_tc.curscan_tc_stage``, counted in ``cuda_tc.tc_stage_launches``;
    at HIGHEST the six-pass forensic builds).  CPU tensors run the plain
    version (``cuda_tc.curscan_tc_stage_plain``)."""
    check_stage_config(iq_re, cfg, stage)
    from kspecanal_tpu_torch.ops import cuda_tc
    return cuda_tc.curscan_tc_stage(iq_re, iq_im, cfg, stage)


def runs_mixed_kernel(n: int) -> bool:
    """Whether the FFT kernel serves fft ``n`` with its mixed-radix form:
    every size but the powers of two up to ``CLUSTER_MAX_FFT_SIZE``."""
    return n & (n - 1) != 0 or n > CLUSTER_MAX_FFT_SIZE


def curscan_mixed_stage(iq_re: torch.Tensor, iq_im: torch.Tensor,
                        cfg: SpecConfig, stage: str) -> torch.Tensor:
    """The mixed kernel cut off after ``stage`` (``MIXED_STAGES``), for its
    stage table (profiling only; no session calls it): ``(T, full_size)``
    -> ``(T, fft_size)``.  Below 'full' each point's re + im is folded in
    place of its magnitude, at the output index of the point's position
    (:func:`curscan_mixed_stage_plain` defines the values); 'full' is the
    production kernel.  Counted in ``forensic_launches``; CPU tensors run
    the plain version."""
    global forensic_launches
    if stage not in MIXED_STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages: {MIXED_STAGES}")
    if kernel_route(cfg) is None or not runs_mixed_kernel(cfg.fft_size):
        raise ValueError(f"fft {cfg.fft_size} does not run the mixed kernel")
    check_planes(iq_re, iq_im, cfg)
    if iq_re.device.type == "cpu":
        return curscan_mixed_stage_plain(iq_re, iq_im, cfg, stage)
    out = _launch_fft(_cuda_lib(iq_re.device), iq_re, iq_im, cfg,
                      (MIXED_STAGES.index(stage) + 1) % len(MIXED_STAGES))
    forensic_launches += 1
    return out


def curscan_mixed_stage_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                              cfg: SpecConfig, stage: str) -> torch.Tensor:
    """The plain version of :func:`curscan_mixed_stage`, in float64 on the
    planes' device.  Block q < c of a window takes the M = N/c points z_q
    (the windowed frame a for c = 1, else z_q[i] = W_N^(iq) sum_j a[i + jM]
    W_c^(jq)); position i of the block after each stage holds: 'input'
    z_q[i]; 'odd' the Stockham order after the odd passes (m the odd part
    of M, L = M/m: position b*m + k holds sum_l z_q[b + l*L] W_m^(lk)); 'pow2'
    bin i of the M-point DFT.  The window's weight times re + im of position
    i is folded over the windows (the cumulate mode's fold) into output
    index (c*i + q + N/2) mod N.  'full' is
    :func:`curscan_fused_sublane_plain`."""
    if stage == "full":
        return curscan_fused_sublane_plain(
            spectrum.decode_u8(iq_re).double(),
            spectrum.decode_u8(iq_im).double(), cfg)
    c = fft_plan(cfg.fft_size)[0]
    m = cfg.fft_size // c
    while m % 2 == 0:
        m //= 2
    return _block_stage_plain(iq_re, iq_im, cfg, c,
                              {"input": 1, "odd": m, "pow2": None}[stage],
                              False)


def _block_stage_plain(iq_re, iq_im, cfg, c: int, radix,
                       window64: bool) -> torch.Tensor:
    """The fold of the FFT kernels' cut-offs, in float64: each window's c
    blocks of M = N/c points z_q (see :func:`curscan_mixed_stage_plain`),
    position i of a block holding z_q[i] (``radix`` 1), the Stockham order
    after a first pass of radix r (position b*r + k holds sum_l z_q[b +
    l*M/r] W_r^(lk); ``radix`` r) or bin i of its M-point DFT (None); the
    window's weight times re + im of position i folded over the windows
    into output index (c*i + q + N/2) mod N.  The window is the kernel's:
    float64 (``window64``) or the float32 table widened."""
    n = cfg.fft_size
    m_pts = n // c
    dev = iq_re.device
    re, im = (spectrum.decode_u8(p).double() for p in (iq_re, iq_im))
    _, weights, window, _ = _tables(n, cfg.window, cfg.window_starts,
                                    cfg.cur_scan_cumu_mode, dev)
    window = (_tables64(n, cfg.window, dev)[0] if window64
              else window.double())
    a = torch.complex(spectrum.frame_signal(re, cfg.window_starts, n),
                      spectrum.frame_signal(im, cfg.window_starts, n))
    a = a * window                                        # (T, W, N)
    z = torch.fft.fft(a.reshape(a.shape[:2] + (c, m_pts)), dim=2)
    q = torch.arange(c, device=dev, dtype=torch.float64)
    i = torch.arange(m_pts, device=dev, dtype=torch.float64)
    z = z * torch.exp(-2j * np.pi * torch.outer(q, i) / n)   # (T, W, c, M)
    if radix is None:
        z = torch.fft.fft(z, dim=3)
    elif radix > 1:
        y = torch.fft.fft(z.reshape(z.shape[:3] + (radix, m_pts // radix)),
                          dim=3)
        z = y.transpose(3, 4).reshape(z.shape)
    val = weights.double()[None, :, None, None] * (z.real + z.imag)
    mode = cfg.cur_scan_cumu_mode
    acc = (val.amax(dim=1) if mode == CUMU_MAX else
           val.amin(dim=1) if mode == CUMU_MIN else val.sum(dim=1))
    out = torch.empty((acc.shape[0], n), dtype=torch.float64, device=dev)
    bins = c * torch.arange(m_pts, device=dev)[None, :] + torch.arange(
        c, device=dev)[:, None]                           # (c, M)
    out[:, (bins.reshape(-1) + n // 2) % n] = acc.reshape(acc.shape[0], -1)
    return out


def fft_stage_variants(parent: bool = False):
    """The power-of-two kernel's forensic builds, one a stage of
    ``FFT_STAGES`` (``csrc/curscan_fft.cu`` alone with
    ``-DKSPEC_FFT_STOP=1..4``; ``parent``: the parent form, with
    ``-DKSPEC_FFT_PARENT=1``), as ``_build.build`` and
    ``_build.load_variant`` take them."""
    return [(("curscan_fft.cu",), (f"KSPEC_FFT_STOP={i + 1}",)
             + (("KSPEC_FFT_PARENT=1",) if parent else ()))
            for i in range(len(FFT_STAGES))]


def fft_staging_variant(stage_bytes: int):
    """The power-of-two kernel built alone (``csrc/curscan_fft.cu``, 'full')
    with its next frame staged where the frame (both planes) is at most
    ``stage_bytes`` (``-DKSPEC_FFT_STAGE_BYTES``; 0 stages no frame,
    131072 every frame of one block a window), as ``_build.build`` and
    ``_build.load_variant`` take it."""
    return (("curscan_fft.cu",), ("KSPEC_FFT_STOP=4",
                                  f"KSPEC_FFT_STAGE_BYTES={stage_bytes}"))


def fft_stage_library(stage: str, parent: bool = False):
    """The forensic build of ``stage`` (:func:`fft_stage_variants`), built
    on first use."""
    from kspecanal_tpu_torch.ops import _build
    return _build.load_variant(
        *fft_stage_variants(parent)[FFT_STAGES.index(stage)])


def check_fft_stage(cfg: SpecConfig, stage: str) -> None:
    """Raise unless ``stage`` is a cut-off of the power-of-two kernel and it
    serves ``cfg``."""
    if stage not in FFT_STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages: {FFT_STAGES}")
    if kernel_route(cfg) is None or runs_mixed_kernel(cfg.fft_size):
        raise ValueError(f"fft {cfg.fft_size} does not run the power-of-two "
                         f"kernel")


def curscan_fft_stage(iq_re: torch.Tensor, iq_im: torch.Tensor,
                      cfg: SpecConfig, stage: str, parent: bool = False,
                      stage_bytes: Optional[int] = None) -> torch.Tensor:
    """The power-of-two kernel cut off after ``stage`` (``FFT_STAGES``), for
    its stage table (profiling only; no session calls it): ``(T,
    full_size)`` -> ``(T, fft_size)``, on its forensic build
    (:func:`fft_stage_library`; ``parent``: the parent form's).  Below
    'full' each point's re + im is folded in place of its magnitude, at the
    output index of the point's position (:func:`curscan_fft_stage_plain`
    defines the values); 'full' is the production kernel built alone (the
    parent form's, with ``parent``); ``stage_bytes`` (with 'full' only)
    picks the build :func:`fft_staging_variant` instead.  Counted in
    ``fft_stage_launches`` (``parent``: ``fft_parent_launches``); CPU
    tensors run the plain version."""
    global fft_stage_launches, fft_parent_launches
    check_fft_stage(cfg, stage)
    check_planes(iq_re, iq_im, cfg)
    if stage_bytes is not None and (stage != "full" or parent):
        raise ValueError("stage_bytes picks a build of the production "
                         "form's 'full' stage only")
    if iq_re.device.type == "cpu":
        return curscan_fft_stage_plain(iq_re, iq_im, cfg, stage, parent)
    if stage_bytes is None:
        lib = fft_stage_library(stage, parent)
    else:
        from kspecanal_tpu_torch.ops import _build
        lib = _build.load_variant(*fft_staging_variant(stage_bytes))
    out = _launch_fft(lib, iq_re, iq_im, cfg, parent=parent)
    if parent:
        fft_parent_launches += 1
    else:
        fft_stage_launches += 1
    return out


def curscan_fft_stage_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                            cfg: SpecConfig, stage: str,
                            parent: bool = False) -> torch.Tensor:
    """The plain version of :func:`curscan_fft_stage`, in float64 on the
    planes' device: the c = ``fft_plan(n, parent)[0]`` blocks of M = N/c
    points of :func:`_block_stage_plain`, position i holding after 'input'
    z_q[i], after 'pass1' the Stockham order after the first pass (radix
    ``pass1_radix(M)``), after 'radix16' bin i of the M-point DFT; 'full'
    is :func:`curscan_fused_sublane_plain`."""
    check_fft_stage(cfg, stage)
    if stage == "full":
        return curscan_fused_sublane_plain(
            spectrum.decode_u8(iq_re).double(),
            spectrum.decode_u8(iq_im).double(), cfg)
    c = fft_plan(cfg.fft_size, parent)[0]
    radix = {"input": 1, "pass1": pass1_radix(cfg.fft_size // c),
             "radix16": None}[stage]
    return _block_stage_plain(iq_re, iq_im, cfg, c, radix, not parent)


def fft_attrs(lib, n: int, u8: bool) -> dict:
    """The library ``lib``'s power-of-two kernel for fft ``n`` on u8 or
    float32 planes (``kspec_curscan_fft_attrs``): registers a thread, local
    memory a thread (bytes of spills and stack), shared memory a block
    (bytes) and resident blocks an SM."""
    import ctypes
    vals = (ctypes.c_int * 4)()
    _raise_on(lib.kspec_curscan_fft_attrs(n, int(u8), vals),
              lib.kspec_curscan_fft_attrs)
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), vals))


class TwoStageSteps(NamedTuple):
    """The steps of a plain two-stage DFT for :func:`two_stage_chain`.  A
    value is what the steps pass on (a complex tensor, or an (re, im) pair)
    of shape ``(T, W, n1, n2)``."""
    start: Callable     # (re, im) of the windowed frames -> value
    keep: Callable      # a removed product's output: its input as staged
    stage1: Callable    # B = F1 A
    twiddle: Callable   # C = B o T
    stage2: Callable    # D = C F2^T
    reduce: Callable    # value -> (T, n1, n2): weighted window sum of re + im
    square: Callable    # value -> |value|^2
    total: Callable     # (T, W, n1, n2) -> its unweighted window sum
    fold: Callable      # (T, W, n1, n2) -> the cumulate mode's weighted fold


def two_stage_chain(fr: torch.Tensor, fi: torch.Tensor, win: torch.Tensor,
                    stop: str, ablate, steps: TwoStageSteps) -> torch.Tensor:
    """The two-stage DFT of framed planes ``(T, W, n1, n2)`` cut off at
    ``stop`` (``STAGES`` but 'read'), with the ``ablate`` stages
    (``ABLATE_KEYS``) passed through, as the JAX kernel's keys and the
    forensic kernels remove them; the plain versions of every class run it
    with their own ``steps``.  'win' skips the window ``win`` ``(n1, n2)``;
    'stage1' makes B the frame as staged, 'twiddle' C = B, 'stage2' D = C
    as staged; below 'full' the result is the weighted window sum of re +
    im of the stage's value; at 'full' the mode's fold of |D| ('sqrt':
    |D|^2), or ('cumulate') its unweighted sum, whatever the mode.
    Returns ``(T, n1, n2)``."""
    if "win" not in ablate:
        fr, fi = fr * win, fi * win
    x = steps.start(fr, fi)
    if stop == "frame":
        return steps.reduce(steps.keep(x))
    x = steps.keep(x) if "stage1" in ablate else steps.stage1(x)
    if stop == "s1":
        return steps.reduce(x)
    if "twiddle" not in ablate:
        x = steps.twiddle(x)
    if stop == "s1tw":
        return steps.reduce(x)
    x = steps.keep(x) if "stage2" in ablate else steps.stage2(x)
    if stop == "s2":
        return steps.reduce(x)
    mag = steps.square(x)
    if "sqrt" not in ablate:
        mag = torch.sqrt(mag)
    return steps.total(mag) if "cumulate" in ablate else steps.fold(mag)


def stage_layout_to_spectrum(acc: torch.Tensor) -> torch.Tensor:
    """``(T, n1, 128)`` -> the production ``(T, N)`` layout:
    ``out[(k1 + n1*k2 + N/2) % N] = acc[k1, k2]``."""
    t, n1, n2 = acc.shape
    return torch.fft.fftshift(acc.transpose(1, 2).reshape(t, n1 * n2),
                              dim=-1)


def spectrum_to_stage_layout(spec: torch.Tensor, n1: int) -> torch.Tensor:
    """The inverse of :func:`stage_layout_to_spectrum`: ``(T, N)`` ->
    ``(T, n1, N / n1)``."""
    t, n = spec.shape
    return torch.fft.ifftshift(spec, dim=-1).view(t, n // n1,
                                                  n1).transpose(1, 2)
