"""Packed tiny-FFT curscan on the card: the wrapper of the hand-written CUDA
kernel ``csrc/curscan_packed.cu``, the port of
``kspecanal_tpu.ops.pallas_curscan.curscan_fused_packed`` (the Pallas kernel
``_kernel_packed``) for fft_size <= 128 dividing 128 (quickFullScan runs 64).

Per IQ block ``(full_size,)`` the kernel runs every window's FFT in the
registers of a group of lanes (the window and ``winAdj*2/N`` applied at the
load), takes ``|.|``, folds the windows (AVG/RAW weighted sum, MAX/MIN
extrema) and writes the fftshifted ``(fft_size,)`` spectrum; u8 planes decode
in its loads.  The dispatcher sends it tpuPrecision HIGHEST (HIGH and
DEFAULT run the tensor-core packed kernel of ``ops/cuda_tc.py``).  Its FFT
runs in float64 and its folds in float32: float32 butterflies miss the
per-bin bound on MIN folds over hundreds of windows (see the source note).
:func:`launch_plan` splits the work: lane groups per IQ block, IQ blocks
per unit (one thread block a unit), windows per staged chunk.

The source also holds the parent form (the first design), built only in
the forensic build ``-DKSPEC_PACKED_PARENT=1`` (:func:`parent_plan`), and
cut-offs of both forms (``-DKSPEC_PACKED_STOP``,
:func:`curscan_packed_stage`, plain version
:func:`curscan_packed_stage_plain`) for ``scripts/packed_stages.py``.

For a CUDA tensor :func:`curscan_fused_packed` launches the kernel or raises;
for a CPU tensor it runs :func:`curscan_fused_packed_plain` and never builds
anything.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from kspecanal_tpu_torch.config import (SpecConfig, cumu_weights, win_adj,
                                        window_lut)
from kspecanal_tpu_torch.ops import spectrum
from kspecanal_tpu_torch.ops.cuda_curscan import _FOLD, check_planes

_LANES = 128
THREADS = 256                       # the kernel's threads per block
# Points a lane P and lanes a window L, by fft size (N = P * L).
SPLIT = {2: (2, 1), 4: (4, 1), 8: (8, 1), 16: (16, 1), 32: (8, 4),
         64: (8, 8), 128: (16, 8)}
H100_SMS = 132
# Bytes of one staged chunk at P <= 8 (both planes of a unit's IQ blocks
# over the chunk's span, and the chunk's starts and weights) where a unit
# has more than one, double-buffered; a unit's windows in one buffer take
# up to twice that.  Either way, with the lane constants and the partial
# folds, within the shared memory of four blocks an SM; P = 16 runs two
# blocks an SM and takes twice the bytes.
CHUNK_BYTES = 20 << 10
# The parent form's staged bytes of a thread block: the whole span in one
# buffer if it fits, else chunks of half of it, double-buffered.
PARENT_STAGE_BYTES = 64 << 10

# The kernel's cut-offs in order (its forensic builds' KSPEC_PACKED_STOP
# values 1..4): 'full' is the production kernel built alone.
STAGES = ("input", "regs", "lanes", "full")
SOURCES = ("curscan_packed.cu",)

launches = 0
stage_launches = 0      # the production form's cut-off builds
parent_launches = 0     # the parent form's builds


class Plan(NamedTuple):
    """How one launch splits the work (``csrc/curscan_packed.cu``)."""
    p: int          # points a lane
    lanes: int      # lanes a window
    groups: int     # lane groups sharing an IQ block
    blocks: int     # IQ blocks of one thread block
    chunk: int      # windows a staged chunk
    n_chunks: int
    stride: int     # samples a staged plane row (the widest chunk span)


def supports_fused_packed(cfg: SpecConfig) -> bool:
    """The JAX predicate (fft_size <= 128 dividing 128, full_size a multiple
    of 128 and >= 256) without its VMEM clause: that clause bounds Mosaic's
    8-block tile of lane-shifted views, and the kernel here stages any block
    in chunks, so it needs no size clause of its own."""
    n = cfg.fft_size
    return (n <= _LANES and _LANES % n == 0
            and cfg.full_size % _LANES == 0
            and cfg.full_size >= 2 * _LANES)


def chunk_spans(starts, n: int, chunk: int, align: int) -> np.ndarray:
    """Staged samples of each chunk of ``chunk`` windows: from the first
    start rounded down to ``align`` samples (16 bytes) to the last window's
    end rounded up."""
    st = np.asarray(starts, np.int64)
    first = st[0::chunk]
    last = st[np.minimum(np.arange(1, len(first) + 1) * chunk, len(st)) - 1]
    return (-(-(last + n) // align) * align) - first // align * align


def _largest(fits: Callable[[int], bool], hi: int) -> int:
    """The largest m in [1, hi] with ``fits(m)``, 0 if none (``fits``
    monotone)."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def groups_for(n: int, w: int, t: int, sms: int) -> int:
    """Lane groups an IQ block, both forms: the smallest power of two that
    gives two waves of 2048 threads on each of the card's ``sms`` SMs over
    T IQ blocks, at most one window a group and ``THREADS / L`` (one IQ
    block a thread block)."""
    lanes = SPLIT[n][1]
    need = -(-(2 * sms * 2048) // max(1, t * lanes))
    return min(THREADS // lanes, 1 << (w.bit_length() - 1),
               1 << (need - 1).bit_length())


def chunk_for(starts, n: int, blocks: int, groups: int) -> int:
    """Windows a staged chunk holds for units of ``blocks`` IQ blocks: all
    of them where their float32 span and tables fit one buffer of
    twice the chunk budget (``CHUNK_BYTES``, doubled at P = 16), else the
    most (a multiple of ``groups`` where ``groups`` windows fit) that fit
    the budget, double-buffered; 0 if one window does not fit.  A u8 span
    takes at most the bytes of the float32 one."""
    w = len(starts)
    bytes_ = CHUNK_BYTES * (1 if SPLIT[n][0] <= 8 else 2)

    def fits(chunk, budget=bytes_):
        span = int(chunk_spans(starts, n, chunk, 4).max())
        return _up16(blocks * 2 * span * 4) + 2 * _up16(4 * chunk) <= budget
    if fits(w, 2 * bytes_):
        return w
    if fits(groups):
        return _largest(lambda m: fits(m * groups), -(-w // groups) - 1) \
            * groups
    return _largest(fits, groups - 1)


def launch_plan(n: int, starts: tuple, t: int, u8: bool,
                sms: int = H100_SMS) -> Plan:
    """The production form's plan for T IQ blocks: the parent form's groups
    (:func:`groups_for`; doubled where one window of so many IQ blocks
    would not fit a chunk), a unit (one thread block) of ``THREADS / L /
    G`` IQ blocks and chunks of :func:`chunk_for` windows.  G and the chunk
    set the order of the float32 folds, so they are the parent's where the
    chunks allow and alike for u8 and float32 planes (u8 gives the bits of
    its decoded float32); ``u8`` sets only the stride (16-byte copies of
    bytes)."""
    p, lanes = SPLIT[n]
    g = groups_for(n, len(starts), t, sms)
    while True:
        blocks = THREADS // lanes // g
        chunk = chunk_for(starts, n, blocks, g)
        if chunk or blocks == 1:
            break
        g *= 2
    if not chunk:
        raise ValueError(f"no packed kernel plan for fft {n}: one window "
                         f"does not fit a chunk")
    stride = int(chunk_spans(starts, n, chunk, 16 if u8 else 4).max())
    return Plan(p, lanes, g, blocks, chunk, -(-len(starts) // chunk), stride)


@functools.lru_cache(maxsize=64)
def parent_plan(n: int, starts: tuple, t: int, u8: bool,
                sms: int = H100_SMS) -> Plan:
    """The parent form's plan: :func:`groups_for`, the thread block then
    holding ``THREADS / L / G`` IQ blocks.  Chunks: all windows at once when
    their span fits ``PARENT_STAGE_BYTES``, else the most windows (a
    multiple of G where G windows fit) whose widest span fits half of
    it."""
    p, lanes = SPLIT[n]
    w = len(starts)
    sb = 1 if u8 else 4
    align = 16 // sb
    groups = groups_for(n, w, t, sms)
    blocks = THREADS // lanes // groups
    row_bytes = blocks * 2 * sb           # bytes a staged sample costs

    def fits(chunk, budget):
        return chunk_spans(starts, n, chunk, align).max() * row_bytes \
            <= budget

    chunk = w
    if not fits(w, PARENT_STAGE_BYTES):
        if fits(groups, PARENT_STAGE_BYTES // 2):
            chunk = max(1, _largest(
                lambda m: fits(m * groups, PARENT_STAGE_BYTES // 2),
                -(-w // groups) - 1)) * groups
        else:       # hops far beyond N (curScanNonOverlap > 1)
            chunk = max(1, _largest(
                lambda m: fits(m, PARENT_STAGE_BYTES // 2), groups - 1))
    stride = int(chunk_spans(starts, n, chunk, align).max())
    return Plan(p, lanes, groups, blocks, chunk, -(-w // chunk), stride)


def curscan_fused_packed_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                               cfg: SpecConfig) -> torch.Tensor:
    """The plain PyTorch version of the kernel: decode u8, then the
    ``torch.fft`` curscan chain.  ``(T, full_size)`` -> ``(T, fft_size)``."""
    return spectrum.curscan_batched(spectrum.decode_u8(iq_re),
                                    spectrum.decode_u8(iq_im), cfg)


@functools.lru_cache(maxsize=32)
def _tables(n: int, window: str, starts: tuple, mode: str,
            device: torch.device):
    """Device tables of one config: int32 starts, float32 per-window
    weights (the closed-form decay weights for AVG/RAW, ones for MAX/MIN),
    and in float64 the window times ``winAdj*2/N`` and the twiddles
    ``exp(-2 pi i m/n)`` as (re, im) pairs."""
    w = cumu_weights(mode, len(starts))
    weights = np.ones(len(starts)) if w is None else w
    wscale = window_lut(window, n) * (win_adj(window, n) * 2.0 / n)
    tw = np.exp(-2j * np.pi * np.arange(n) / n)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(device)

    return (dev(starts, np.int32), dev(weights, np.float32),
            dev(wscale, np.float64),
            dev(np.stack([tw.real, tw.imag], axis=-1), np.float64))


def plan_attrs(lib, n: int, u8: bool, pl: Plan,
               parent: bool = False) -> dict:
    """The library ``lib``'s packed kernel for fft ``n`` on u8 or float32
    planes at plan ``pl`` (``kspec_curscan_packed_attrs``; ``parent``: the
    parent form's ``kspec_curscan_packed_parent_attrs``): registers a
    thread, local memory a thread (bytes of spills and stack), shared
    memory a block (bytes) and resident blocks an SM."""
    import ctypes
    vals = (ctypes.c_int * 4)()
    if parent:
        err = lib.kspec_curscan_packed_parent_attrs(
            n, int(u8), pl.groups, pl.n_chunks, pl.stride, vals)
    else:
        err = lib.kspec_curscan_packed_attrs(
            n, int(u8), pl.groups, pl.chunk, pl.n_chunks, pl.stride, vals)
    if err:
        raise RuntimeError(f"packed kernel attributes: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), vals))


def plan_for(cfg: SpecConfig, t: int, u8: bool, sms: int,
             parent: bool = False) -> Plan:
    """The plan of one launch: :func:`launch_plan` (``parent``:
    :func:`parent_plan`)."""
    plan = parent_plan if parent else launch_plan
    return plan(cfg.fft_size, cfg.window_starts, t, u8, sms)


def attrs(lib, cfg: SpecConfig, t: int, u8: bool,
          parent: bool = False) -> dict:
    """:func:`plan_attrs` of ``lib`` at the plan of ``cfg`` and T."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return plan_attrs(lib, cfg.fft_size, u8,
                      plan_for(cfg, t, u8, sms, parent), parent)


@functools.lru_cache(maxsize=64)
def _launch_args(cfg: SpecConfig, t: int, u8: bool, device: torch.device,
                 parent: bool = False):
    """The device tables and the integer arguments after ``full_size`` of
    one launch, computed once per config and T (``cfg.window_starts`` is a
    Python loop, the bulk of a small launch's host time otherwise)."""
    n, starts = cfg.fft_size, cfg.window_starts
    pl = plan_for(cfg, t, u8, torch.cuda.get_device_properties(
        device).multi_processor_count, parent)
    args = (n, len(starts), _FOLD[cfg.cur_scan_cumu_mode], pl.groups,
            pl.chunk, pl.n_chunks, pl.stride)
    return (_tables(n, cfg.window, starts, cfg.cur_scan_cumu_mode, device),
            args)


def _card(dev: torch.device) -> None:
    """Raise unless ``dev`` is a CUDA device: no other device has a kernel."""
    if dev.type != "cuda":
        raise ValueError(f"no curscan kernel for device {dev}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernel copies 16 bytes at a time: a plane whose data does not
    start on 16 bytes is copied first."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(lib, iq_re: torch.Tensor, iq_im: torch.Tensor, cfg: SpecConfig,
            parent: bool = False) -> torch.Tensor:
    """One launch of ``lib``'s packed kernel (``parent``: the parent form's
    entry) on CUDA planes; returns the ``(T, fft_size)`` output."""
    dev = iq_re.device
    t, n = iq_re.shape[0], cfg.fft_size
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    iq_re, iq_im = _aligned(iq_re), _aligned(iq_im)
    u8 = iq_re.dtype == torch.uint8
    tables, args = _launch_args(cfg, t, u8, dev, parent)
    fn = lib.kspec_curscan_packed_parent if parent else lib.kspec_curscan_packed
    with torch.cuda.device(dev):
        err = fn(iq_re.data_ptr(), iq_im.data_ptr(), int(u8), out.data_ptr(),
                 *(x.data_ptr() for x in tables), t, cfg.full_size, *args,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"curscan_packed kernel launch failed: CUDA error "
                           f"{err}")
    return out


def stage_variants(parent: bool = False):
    """The packed kernel's forensic builds, one a stage of ``STAGES``
    (``csrc/curscan_packed.cu`` alone with ``-DKSPEC_PACKED_STOP=1..4``;
    ``parent``: the parent form, with ``-DKSPEC_PACKED_PARENT=1``), as
    ``_build.build`` and ``_build.load_variant`` take them."""
    return [(SOURCES, (f"KSPEC_PACKED_STOP={i + 1}",)
             + (("KSPEC_PACKED_PARENT=1",) if parent else ()))
            for i in range(len(STAGES))]


def stage_library(stage: str, parent: bool = False):
    """The forensic build of ``stage`` (:func:`stage_variants`), built on
    first use."""
    from kspecanal_tpu_torch.ops import _build
    return _build.load_variant(*stage_variants(parent)[STAGES.index(stage)])


def curscan_packed_stage(iq_re: torch.Tensor, iq_im: torch.Tensor,
                         cfg: SpecConfig, stage: str,
                         parent: bool = False) -> torch.Tensor:
    """The packed kernel cut off after ``stage`` (``STAGES``), for its stage
    table (profiling only; no session calls it): ``(T, full_size)`` ->
    ``(T, fft_size)`` on its forensic build (:func:`stage_library`;
    ``parent``: the parent form's), at the form's plan, so the stages
    differ only in the work cut.  Below 'full' each value's ``|re + im|``
    is folded in place of its
    magnitude at the slot of its position
    (:func:`curscan_packed_stage_plain` defines the values); 'full' is the
    form's production kernel built alone.  Counted in ``stage_launches``
    (``parent``: ``parent_launches``); CPU tensors run the plain version."""
    global stage_launches, parent_launches
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages: {STAGES}")
    if not supports_fused_packed(cfg):
        raise ValueError(f"fft {cfg.fft_size} (full_size {cfg.full_size}) "
                         f"does not run the packed kernel")
    check_planes(iq_re, iq_im, cfg)
    if iq_re.device.type == "cpu":
        return curscan_packed_stage_plain(iq_re, iq_im, cfg, stage, parent)
    _card(iq_re.device)
    out = _launch(stage_library(stage, parent), iq_re, iq_im, cfg, parent)
    if parent:
        parent_launches += 1
    else:
        stage_launches += 1
    return out


def curscan_packed_stage_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                               cfg: SpecConfig, stage: str,
                               parent: bool = False) -> torch.Tensor:
    """The plain version of :func:`curscan_packed_stage`, in float64 on the
    planes' device.  Window w's frame z[j] = x[s_w + j] * ws[j] (ws the
    window times winAdj*2/N), N = P L (``SPLIT``), C = P / L for L > 1,
    holds after 'input' z[j] at slot j (the production form at C = 1, fft
    64: z[j] * W_L^(j2 j1), j = j1 + L j2, its rotation); after 'regs' the
    four-step intermediate Y[j1][k1] = W_N^(j1 k1) sum_j2 z[j1 + L j2]
    W_P^(j2 k1) at slot j1 + L k1 (both forms); after 'lanes' bin k of
    the N-point DFT at slot k (the production form: times W_L^(-k_l p),
    k = C k_l + e + P p, the factor |X| drops).  Each slot folds |re + im|
    over the windows (AVG/RAW: the weighted sum, MAX / MIN: the extremum)
    and is written fftshifted, slot s to (s + N/2) % N; 'full' is
    :func:`curscan_fused_packed_plain`.  ``parent``: the parent form's
    values."""
    n = cfg.fft_size
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages: {STAGES}")
    if stage == "full":
        return curscan_fused_packed_plain(
            spectrum.decode_u8(iq_re).double(),
            spectrum.decode_u8(iq_im).double(), cfg)
    p, lanes = SPLIT[n]
    c = p // lanes if lanes > 1 else 1
    dev = iq_re.device
    ws = torch.as_tensor(window_lut(cfg.window, n)
                         * (win_adj(cfg.window, n) * 2.0 / n), device=dev)
    fr, fi = (spectrum.frame_signal(spectrum.decode_u8(x).double(),
                                    cfg.window_starts, n) * ws
              for x in (iq_re, iq_im))
    z = torch.complex(fr, fi)                           # (T, W, N)
    j = torch.arange(n, device=dev)

    def root(m, q):                                     # W_q^m
        return torch.exp(-2j * np.pi * m.double() / q)
    if stage == "input":
        if not parent and c == 1 and lanes > 1:
            z = z * root((j // lanes) * (j % lanes), lanes)
    elif stage == "regs":
        zz = z.reshape(*z.shape[:-1], p, lanes)         # [j2][j1]
        y = torch.fft.fft(zz, dim=-2)                   # [k1][j1]
        k1 = torch.arange(p, device=dev)[:, None]
        j1 = torch.arange(lanes, device=dev)[None, :]
        z = (y * root(j1 * k1, n)).reshape(z.shape)     # slot j1 + L k1
    else:
        z = torch.fft.fft(z, dim=-1)
        if not parent:
            z = z * root(-((j % p) // c) * (j // p), lanes)
    val = (z.real + z.imag).abs()
    mode = cfg.cur_scan_cumu_mode
    if _FOLD[mode] == 1:
        acc = val.amax(dim=1)
    elif _FOLD[mode] == 2:
        acc = val.amin(dim=1)
    else:
        w = cumu_weights(mode, cfg.num_windows)
        wts = (torch.ones(cfg.num_windows, dtype=torch.float64, device=dev)
               if w is None else torch.as_tensor(w, dtype=torch.float64,
                                                 device=dev))
        acc = (val * wts[:, None]).sum(dim=1)
    return torch.roll(acc, n // 2, dims=-1)


def curscan_fused_packed(iq_re: torch.Tensor, iq_im: torch.Tensor,
                         cfg: SpecConfig) -> torch.Tensor:
    """``(T, full_size)`` float32 or raw-u8 planes -> ``(T, fft_size)``
    fftshifted linear spectra, in float64 at every class.  CUDA tensors
    launch the kernel on the current stream without synchronising; CPU
    tensors run the plain version."""
    global launches
    if not supports_fused_packed(cfg):
        raise ValueError(f"config not supported by the packed curscan "
                         f"kernel (fft_size {cfg.fft_size}, full_size "
                         f"{cfg.full_size})")
    check_planes(iq_re, iq_im, cfg)
    dev = iq_re.device
    if dev.type == "cpu":
        return curscan_fused_packed_plain(iq_re, iq_im, cfg)
    _card(dev)
    from kspecanal_tpu_torch.ops import _build
    out = _launch(_build.load(), iq_re, iq_im, cfg)
    launches += 1
    return out
