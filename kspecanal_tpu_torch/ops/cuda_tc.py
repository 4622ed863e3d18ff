"""The HIGH and DEFAULT precision classes on the card: the wrappers of the
three hand-written tensor-core curscan kernels and their plain versions.

``tpuPrecision`` sets what the JAX package's Pallas kernels compute
(``kspecanal_tpu.ops.pallas_curscan._make_dot``): DEFAULT is one bf16 pass
of every real matrix product, HIGH the bf16x3 split ``a_hi b_hi + (a_hi
b_lo + a_lo b_hi)``, HIGHEST exact float32.  HIGHEST runs the port's
float64 FFT kernels (``cuda_curscan``, ``cuda_packed``).  HIGH and DEFAULT
run these:

* **Kernel A**, ``csrc/curscan_tc.cu`` (:func:`curscan_tc`, counted in
  ``tc_launches``): the two-stage DFT of K1 (``_kernel_sublane``) and of
  K3's cell on the 128 grid (``_kernel``), n = n1 * 128 with n1 <= 128,
  i.e. fft 256-16384 on the 128 grid, any window starts.  Per window
  ``A[m1, m2] = win * x[s + 128 m1 + m2]`` (float32), stage 1 ``B = F1 A``,
  the twiddle ``C = B * T`` in float32, stage 2 ``D = C F2^T``, ``|D|``,
  and the fold of ``_cumulate_frames`` in float32 in window order
  (``winAdj*2/N`` and the decay weights in the per-window weight).
* **Kernel B**, ``csrc/curscan_packed_tc.cu`` (:func:`curscan_packed_tc`,
  counted in ``packed_tc_launches``): K2 (``_kernel_packed``), fft 2-128:
  per window one ``(1 x n) (n x n)`` complex DFT product of the raw frame
  with the table ``dft[j, k] * win[j] * winAdj*2/N`` (folded in float64,
  rounded to float32), in the 4M form at every class as in JAX, then
  ``|.|`` and the float32 fold from the accumulators: each lane folds the
  windows it holds (8 nt + 2t and + 1 of every n-tile), then the 4 lanes of
  a bin combine in one fixed order.  A thread block stages each IQ block's
  span once (:func:`packed_tc_plan`: chunks of windows where a block does
  not fit) and walks IQ blocks a grid apart (:func:`packed_tc_grid`).
* **Kernel C**, ``csrc/curscan_tc_split.cu`` (:func:`curscan_tc_split`,
  counted in ``tc_split_launches``): the two-stage DFT of every other
  config the JAX dispatcher sends to K1 or K3 (K3 off the 128 grid, the
  grid above fft 16384), on the split of the kernel it picks
  (``cuda_curscan.tc_split``: ``(n / 128, 128)`` for the sublane kernel,
  ``_factorize(n)`` for the lane kernel), with Kernel A's math and rounding
  points for any ``n = n1 * n2`` and any window starts.  A thread block
  takes one IQ block, 1-4 m-tiles of 16 rows k1 (the library's
  ``kspec_curscan_tc_split_mt``) and a window group
  (:func:`tc_split_groups` at the library's occupancy) through both stages
  and the fold: the frame staged once a block in chunks of 16 rows (32 or
  64 at HIGH) as bf16 operand planes, the next chunk's loads in flight;
  F1's rows, the fold, the twiddles and F2^T in shared memory where they
  fit; C in bf16 planes; cut-offs after each stage for its stage table
  (:func:`curscan_tc_split_stage`, ``scripts/tc_split_stages.py``).

Each real product rounds its float32 operands to bf16 (to nearest, ties to
even) and sums in float32 (``mma.sync`` bf16 -> f32), once at DEFAULT and
as the bf16x3 split at HIGH.  Each kernel rounds each operand once, where
it stores it in shared memory (Kernel A the windowed frame, then C; Kernel
B the staged samples, beside a copy shifted by one sample for odd starts;
both tables are rounded by the wrapper; Kernel C each frame element as it
stages it, then C), and every product reads the rounded values; they are
those the plain version rounds.  (At HIGH, Kernel C sums a product's two
correction terms in one float32 chain, Kernel A in two: an order of float32
sums, as inside each product.)
A complex product is 4M (four real products) or 3M: ``T1 = Fr Xr``,
``T2 = Fi Xi``, ``T3 = (Fr + Fi)(Xr + Xi)``, ``Re = T1 - T2``,
``Im = T3 - T1 - T2``, the sum table precomputed and ``Xr + Xi`` formed in float32 before its rounding.  Both classes run 4M
(:func:`three_mult`).  The JAX gate (``pallas_curscan.py:456-472``) takes
3M at HIGH everywhere and at DEFAULT but for misaligned window starts on u8
planes.  That 3M misses its class's bound (the worst bin against the
float64 oracle: HIGH 5e-5, DEFAULT 3.9e-2, both measured at fft 2048 and
50% overlap) at cells the JAX package did not measure: HIGH at fft 8192 and
50%, DEFAULT at fft 16384 and 50% on float32 planes, both at 90% overlap.
4M meets them there, but for HIGH at 90% overlap from fft 8192
(``scripts/threemult_smoke.py --forms``; ROADMAP.md C, faults C3 and C4).
``form="force3m"`` / ``"no3m"`` pick the form, as the JAX kernel's ablate
keys do.  The JAX kernel's bf16 staging of deep-overlap DEFAULT frames is a
TPU data-movement device, not part of the contract: here the frames stay
float32 until each product rounds them.  u8 planes decode exactly (x - 127
is exact in bf16), so u8 is bit-identical to decoded float32 in the same
form.

So at HIGH and DEFAULT every config the JAX dispatcher sends to a Pallas
curscan kernel runs a tensor-core kernel; the float64 FFT kernels serve
HIGHEST.

K4 (``scripts/roofline_r2.py``'s stage ablation) runs Kernel A cut off
after each stage (:func:`curscan_tc_stage`, counted in
``tc_stage_launches``): forensic builds of its sources with
``-DKSPEC_TC_STOP`` (:func:`stage_library`), each writing its stage's
reduction (``csrc/curscan_tc.cuh``; plain version
:func:`curscan_tc_stage_plain`), and for 'full' the port's library.  K1's
``ablate`` keys (``scripts/kernel_ablate.py``) run the ablate builds of
Kernel A and Kernel C (:func:`ablate_variants`, ``-DKSPEC_TC_ABLATE`` /
``-DKSPEC_TCS_ABLATE``: one build each, the mask a run-time argument;
``curscan_tc`` / ``curscan_tc_split(..., ablate)``, counted in
``tc_ablate_launches`` / ``tc_split_ablate_launches``).

Both forensic forms run HIGHEST too, as the JAX kernels compute it (Mosaic's
six bf16 passes, ``pallas_curscan._make_dot``): the class of three parts an
operand (:func:`six_pass_matmul`, ``mxu_fft.split3_bf16``), compiled only
into forensic builds with ``-DKSPEC_TC_HIGHEST=1`` (:func:`highest_variants`:
Kernel A whole, :func:`highest_library`, its five cut-offs and its ablate
build, Kernel C's ablate build), counted on the same counters.  No session
runs them: a HIGHEST session runs the float64 FFT kernels.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version (:func:`curscan_tc_plain`, :func:`curscan_packed_tc_plain`,
:func:`curscan_tc_split_plain`), which rounds at the same points and in the
same form.  The order of the sums inside each product differs from the
kernels'; Kernels A and C fold the windows in the plain version's window
order, Kernel B's AVG/RAW sums in its lanes' order (MAX/MIN are
unaffected); ``torch_parity.TC_TOL`` holds all three.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from kspecanal_tpu_torch.config import (CUMU_AVG, CUMU_MAX, CUMU_RAW,
                                        SpecConfig, cumu_weights, win_adj,
                                        window_lut)
from kspecanal_tpu_torch.ops import cuda_packed, spectrum
from kspecanal_tpu_torch.ops.cuda_packed import _aligned
from kspecanal_tpu_torch.ops.cuda_curscan import (_FOLD, STAGES,
                                                  TC_CLASSES,
                                                  TC_MAX_FFT_SIZE,
                                                  TwoStageSteps,
                                                  _jax_predicate, _raise_on,
                                                  _tables, ablate_mask,
                                                  check_planes,
                                                  check_stage_config,
                                                  kernel_route,
                                                  spectrum_to_stage_layout,
                                                  stage_layout_to_spectrum,
                                                  tc_split, two_stage_chain)
from kspecanal_tpu_torch.ops.mxu_fft import (_dft_tables_for, class_matmul,
                                             round_bf16, split3_bf16,
                                             split_bf16)

FORMS = ("force3m", "no3m")
# The classes of the forensic forms (K4, the ablate keys): the production
# classes and HIGHEST's six passes.  The kernels' `precision` argument.
FORENSIC_CLASSES = ("HIGHEST",) + TC_CLASSES
PREC_CODE = {"DEFAULT": 0, "HIGH": 1, "HIGHEST": 2}
_N2 = 128
_MMA = 16                       # mma.sync m16n8k16: M and K tiles
# Kernel A stacks at most TC_PASS_ROWS rows of frames a pass (n1 rounded up
# to 16 a window); its shared-memory layout is layout() in
# csrc/curscan_tc.cuh, which the library reports (kspec_curscan_tc_smem).
TC_PASS_ROWS = 64
# A block's shared memory on the H100 (bytes), which Kernel A's planes must
# fit: HIGHEST's nine 3M planes do up to n1p = 80 only.
TC_SMEM_LIMIT = 232448
# Kernel B: bytes of a thread block's staging buffers and operand planes
# (packed_tc_plan keeps a staged span within it by chunks of windows).
PACKED_TC_STAGE_BYTES = 48 << 10

# Kernel A's sources, which the forensic cut-offs (K4 at HIGH/DEFAULT,
# scripts/tc_stages.py) build with -DKSPEC_TC_STOP.
TC_SOURCES = ("curscan_tc.cu", "curscan_tc_high.cu")
# Kernel C's sources, which its forensic cut-offs (scripts/tc_split_stages.py)
# build with -DKSPEC_TCS_STOP; its stages, each cut-off's name (csrc/
# curscan_tc_split.cuh), 'full' the production kernel.
TC_SPLIT_SOURCES = ("curscan_tc_split.cu", "curscan_tc_split_high.cu")
TC_SPLIT_STAGES = ("frame", "s1", "s1tw", "s2", "full")
# The ablate builds (sources, defines): Kernels A and C with a run-time mask
# of stages to remove (the JAX kernel's ablate keys at HIGH and DEFAULT,
# scripts/kernel_ablate.py).
TC_ABLATE = (TC_SOURCES, ("KSPEC_TC_ABLATE=1",))
TC_SPLIT_ABLATE = (TC_SPLIT_SOURCES, ("KSPEC_TCS_ABLATE=1",))
# The define of the HIGHEST forensic builds: the HIGH translation units
# instantiate the six-pass class, the DEFAULT ones none (csrc/
# curscan_tc_common.cuh); the port's library never has it.
HIGHEST_DEFINE = "KSPEC_TC_HIGHEST=1"

tc_launches = 0             # Kernel A (csrc/curscan_tc.cu)
packed_tc_launches = 0      # Kernel B (csrc/curscan_packed_tc.cu)
tc_stage_launches = 0       # K4 on Kernel A (curscan_tc_stage; HIGHEST too)
tc_split_launches = 0       # Kernel C (csrc/curscan_tc_split.cu)
tc_split_stage_launches = 0  # Kernel C's cut-offs (curscan_tc_split_stage)
tc_ablate_launches = 0      # Kernel A's ablate builds (curscan_tc, ablate)
tc_split_ablate_launches = 0  # Kernel C's (curscan_tc_split, ablate)


def precision_class(cfg: SpecConfig) -> str:
    return cfg.tpu_precision.upper()


def supports_tc(cfg: SpecConfig) -> bool:
    """Kernel A takes ``cfg`` (``cuda_curscan.kernel_route`` is "tc"):
    class HIGH or DEFAULT, the JAX sublane predicate (fft a multiple of 128
    from 256, full_size a multiple of 128) and fft <=
    ``cuda_curscan.TC_MAX_FFT_SIZE``;
    that set holds K3's cell on the grid (fft 16384)."""
    return kernel_route(cfg) == "tc"


def supports_packed_tc(cfg: SpecConfig) -> bool:
    """Kernel B takes ``cfg``: class HIGH or DEFAULT and K2's predicate."""
    return (precision_class(cfg) in TC_CLASSES
            and cuda_packed.supports_fused_packed(cfg))


def three_mult(form: Optional[str] = None) -> bool:
    """Kernel A takes the 3M form: only for ``form`` "force3m"; 4M, which
    meets the class bounds where 3M misses them (fault C3), is the
    production form at both classes and ``form`` "no3m"."""
    if form is not None and form not in FORMS:
        raise ValueError(f"unknown complex form {form!r}; forms: {FORMS}")
    return form == "force3m"


def _check_class(cfg: SpecConfig, classes=TC_CLASSES) -> str:
    prec = precision_class(cfg)
    if prec not in classes:
        raise ValueError(f"the tensor-core kernels serve tpuPrecision "
                         f"{' and '.join(classes)}, not {cfg.tpu_precision}")
    return prec


def supports_highest_forensics(cfg: SpecConfig) -> bool:
    """The HIGHEST forensic builds take ``cfg``: class HIGHEST and the JAX
    sublane predicate, whose kernel the ablate keys and K4 take apart
    (Kernel A up to fft ``TC_MAX_FFT_SIZE``, Kernel C above)."""
    return precision_class(cfg) == "HIGHEST" and _jax_predicate(cfg)


def six_pass_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the HIGHEST forensic builds compute it: both operands
    split in three bf16 parts (``mxu_fft.split3_bf16``), the six products
    whose parts' orders sum to at most 2, each a float32 product (exact for
    bf16 values), summed smallest first, ``hh + ((hm + mh) + ((hl + mm) +
    lh))``.  Only the order of the float32 sums differs from the kernels'
    (Kernel A sums the first- and second-order terms in two chains, Kernel
    C in one)."""
    ah, am, al = split3_bf16(a)
    bh, bm, bl = split3_bf16(b)
    return ah @ bh + ((ah @ bm + am @ bh) + ((ah @ bl + am @ bm) + al @ bh))


def _class_dot(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """A real product of the class kernels at ``prec``: the six passes at
    HIGHEST (:func:`six_pass_matmul`), else ``mxu_fft.class_matmul``."""
    if prec == "HIGHEST":
        return six_pass_matmul(a, b)
    return class_matmul(a, b, prec)


def _complex_dot(dot, fr, fi, fs, xr, xi, left: bool, tm: bool):
    """(Re, Im) of the complex product ``F X`` (``left``) or ``X F`` (not
    ``left``) in the 3M or 4M form; ``fs`` = Fr + Fi."""
    def d(f, x):
        return dot(f, x) if left else dot(x, f)
    if tm:
        t1, t2, t3 = d(fr, xr), d(fi, xi), d(fs, xr + xi)
        return t1 - t2, t3 - t1 - t2
    return d(fr, xr) - d(fi, xi), d(fr, xi) + d(fi, xr)


def _fold(mode: str, acc, v):
    if acc is None:
        return v
    if mode in (CUMU_AVG, CUMU_RAW):
        return acc + v
    if mode == CUMU_MAX:
        return torch.maximum(acc, v)
    return torch.minimum(acc, v)


@functools.lru_cache(maxsize=32)
def _plain_tables(n: int, window: str, device: torch.device,
                  n2: int = _N2):
    """The two-stage tables of the split ``n = n1 * n2`` (Kernel A's n2 =
    128 by default) in float32 on ``device``: F1 (re, im, re + im), F2^T
    (re, im, re + im), the twiddle (re, im) and the window, ``(n1, n2)``."""
    n1 = n // n2
    f1r, f1i, f2r, f2i, twr, twi = _dft_tables_for(n, n1, n2)
    win = np.asarray(window_lut(window, n).reshape(n1, n2), np.float32)
    tabs = (f1r, f1i, f1r + f1i, f2r.T, f2i.T, (f2r + f2i).T, twr, twi, win)
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(device)
                 for a in tabs)


def _two_stage_tc(iq_re: torch.Tensor, iq_im: torch.Tensor,
                  cfg: SpecConfig, stage: str, tm: bool,
                  split: Optional[Tuple[int, int]] = None,
                  ablate: frozenset = frozenset()) -> torch.Tensor:
    """The tensor-core kernels' two-stage math in PyTorch at the config's
    class (HIGHEST: the forensic builds' six passes), on the split ``n = n1
    * n2`` (default Kernel A's ``(n / 128, 128)``), cut off after ``stage``
    (``STAGES``), with the ``ablate`` stages passed through
    (``cuda_curscan.two_stage_chain``): ``(T, n1, n2)``, row k1 (m1 for
    'frame'), column k2 (m2), unshifted.  'read' is the unweighted float32
    sum of the block's n-sample slabs of re + im, slab by slab, in K4's
    ``(n / 128, 128)`` layout; 'frame' (as rounded: :func:`_operand_value`),
    's1' (B), 's1tw' (C) and 's2' (D) the sum over windows, in window order,
    of weights[w] (x_re + x_im); 'full' the cumulate mode's fold of
    weights[w] |D| in window order.  A removed stage 1 leaves B the frame
    as rounded, a removed stage 2 D = C as rounded for stage 2 (the
    operands the kernels stage); 'cumulate' sums |D| over the windows in
    window order."""
    prec = _check_class(cfg, FORENSIC_CLASSES)
    n = cfg.fft_size
    n1, n2 = split or (n // _N2, _N2)
    dev = iq_re.device
    re, im = spectrum.decode_u8(iq_re), spectrum.decode_u8(iq_im)
    t = re.shape[0]
    if stage == "read":      # no rounding: every sample once
        acc = torch.zeros((t, n // _N2, _N2), dtype=torch.float32,
                          device=dev)
        slabs = (p.reshape(t, -1, n // _N2, _N2) for p in (re, im))
        for sr, si in zip(*(x.unbind(1) for x in slabs)):
            acc = acc + sr + si
        return acc
    f1r, f1i, f1s, f2r, f2i, f2s, twr, twi, win = _plain_tables(
        n, cfg.window, dev, n2)
    weights = _tables(n, cfg.window, cfg.window_starts,
                      cfg.cur_scan_cumu_mode, dev)[1]

    def dot(a, b):
        return _class_dot(a, b, prec)

    def over_windows(mode, x, w):
        acc = None
        for j in range(x.shape[1]):
            acc = _fold(mode, acc, x[:, j] if w is None else w[j] * x[:, j])
        return acc

    def rounded(x):
        return tuple(_operand_value(v, prec) for v in x)

    def twiddle(x):
        br, bi = x
        return br * twr - bi * twi, br * twi + bi * twr

    frame = (spectrum.frame_signal(p, cfg.window_starts, n).reshape(
        t, -1, n1, n2) for p in (re, im))
    return two_stage_chain(*frame, win, stage, ablate, TwoStageSteps(
        start=lambda fr, fi: (fr, fi), keep=rounded,
        stage1=lambda x: _complex_dot(dot, f1r, f1i, f1s, *x, True, tm),
        twiddle=twiddle,
        stage2=lambda x: _complex_dot(dot, f2r, f2i, f2s, *x, False, tm),
        reduce=lambda x: over_windows(CUMU_AVG, x[0] + x[1], weights),
        square=lambda x: x[0] * x[0] + x[1] * x[1],
        total=lambda mag: over_windows(CUMU_AVG, mag, None),
        fold=lambda mag: over_windows(cfg.cur_scan_cumu_mode, mag,
                                      weights)))


def _stage_keys(ablate: Optional[Sequence[str]]) -> frozenset:
    """The stage keys of a class kernel's ``ablate`` (``ABLATE_KEYS``; None
    is none); raises on others, the form keys among them (the form is the
    kernel's ``form``)."""
    if ablate is None:
        return frozenset()
    ablate_mask(ablate)
    forms = [k for k in ablate if k in FORMS]
    if forms:
        raise ValueError(f"ablate takes stage keys; {forms} pick the form, "
                         f"which is the form argument")
    return frozenset(ablate)


def _operand_value(x: torch.Tensor, prec: str) -> torch.Tensor:
    """The value of float32 ``x`` as Kernel A stores it as an operand: bf16
    at DEFAULT, hi + lo of the bf16x3 split at HIGH, (hi + mid) + lo of the
    three-part split at HIGHEST."""
    if prec == "HIGHEST":
        hi, mid, lo = split3_bf16(x)
        return (hi + mid) + lo
    if prec == "HIGH":
        hi, lo = split_bf16(x)
        return hi + lo
    return round_bf16(x)


def curscan_tc_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                     cfg: SpecConfig, form: Optional[str] = None,
                     ablate: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The plain PyTorch version of Kernel A: ``(T, full_size)`` float32 or
    raw-u8 planes -> ``(T, fft_size)`` fftshifted spectra, at the config's
    class, in the 4M form or ``form``'s, on the planes' device, with the
    ``ablate`` stages removed (:func:`curscan_tc`)."""
    return stage_layout_to_spectrum(_two_stage_tc(
        iq_re, iq_im, cfg, "full", three_mult(form),
        ablate=_stage_keys(ablate)))


def curscan_tc_split_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                           cfg: SpecConfig, form: Optional[str] = None,
                           split: Optional[Tuple[int, int]] = None,
                           ablate: Optional[Sequence[str]] = None
                           ) -> torch.Tensor:
    """The plain PyTorch version of Kernel C: ``(T, full_size)`` float32 or
    raw-u8 planes -> ``(T, fft_size)`` fftshifted spectra, at the config's
    class, in the 4M form or ``form``'s, on ``split`` (default the JAX
    dispatcher's for the planes' type, ``cuda_curscan.tc_split``), on the
    planes' device, with the ``ablate`` stages removed
    (:func:`curscan_tc_split`).  Kernel A's plain version is this at
    ``(n / 128, 128)``."""
    split = split or tc_split(cfg, iq_re.dtype == torch.uint8)
    return stage_layout_to_spectrum(_two_stage_tc(
        iq_re, iq_im, cfg, "full", three_mult(form), split,
        _stage_keys(ablate)))


def curscan_tc_split_stage_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                                 cfg: SpecConfig, stage: str,
                                 form: Optional[str] = None,
                                 split: Optional[Tuple[int, int]] = None
                                 ) -> torch.Tensor:
    """The plain PyTorch version of :func:`curscan_tc_split_stage`: Kernel
    C's math cut off after ``stage`` (``TC_SPLIT_STAGES``), each element's
    weighted re + im summed over the windows, in the production layout
    ``(T, fft_size)``; 'full' is :func:`curscan_tc_split_plain`."""
    check_tc_split_stage(stage)
    split = split or tc_split(cfg, iq_re.dtype == torch.uint8)
    return stage_layout_to_spectrum(
        _two_stage_tc(iq_re, iq_im, cfg, stage, three_mult(form), split))


def curscan_tc_stage_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                           cfg: SpecConfig, stage: str) -> torch.Tensor:
    """The plain PyTorch version of :func:`curscan_tc_stage` (4M, Kernel
    A's rounding points, at every class of ``FORENSIC_CLASSES``): ``(T,
    full_size)`` float32 -> ``(T, n1, 128)``; 'full' is
    :func:`curscan_tc_plain` before the layout map."""
    check_stage_config(iq_re, cfg, stage)
    return _two_stage_tc(iq_re, iq_im, cfg, stage, False)


@functools.lru_cache(maxsize=32)
def _packed_plain_tables(n: int, window: str, mode: str, w_cnt: int,
                         device: torch.device):
    """Kernel B's float32 tables: the DFT table with the window and
    ``winAdj*2/N`` folded on its input index (re, im; ``(n, n)``, as
    ``_build_packed`` folds them) and the per-window fold weights (the decay
    weights for AVG/RAW, ones for MAX/MIN)."""
    k = np.arange(n)
    dft = np.exp(-2j * np.pi * np.outer(k, k) / n)
    scale = window_lut(window, n)[:, None] * (win_adj(window, n) * 2.0 / n)
    w = cumu_weights(mode, w_cnt)
    tabs = ((dft.real * scale).astype(np.float32),
            (dft.imag * scale).astype(np.float32),
            (np.ones(w_cnt) if w is None else w).astype(np.float32))
    return tuple(torch.as_tensor(a).to(device) for a in tabs)


def curscan_packed_tc_plain(iq_re: torch.Tensor, iq_im: torch.Tensor,
                            cfg: SpecConfig) -> torch.Tensor:
    """The plain PyTorch version of Kernel B: ``(T, full_size)`` float32 or
    raw-u8 planes -> ``(T, fft_size)`` fftshifted spectra, 4M at the
    config's class, on the planes' device."""
    prec = _check_class(cfg)
    n = cfg.fft_size
    dtr, dti, weights = _packed_plain_tables(
        n, cfg.window, cfg.cur_scan_cumu_mode, cfg.num_windows, iq_re.device)
    fr = spectrum.frame_signal(spectrum.decode_u8(iq_re), cfg.window_starts,
                               n)
    fi = spectrum.frame_signal(spectrum.decode_u8(iq_im), cfg.window_starts,
                               n)

    def dot(a, b):
        return class_matmul(a, b, prec)

    dr, di = _complex_dot(dot, dtr, dti, None, fr, fi, False, False)
    mag = torch.sqrt(dr * dr + di * di)                 # (T, W, n)
    acc = None
    for j in range(mag.shape[1]):
        acc = _fold(cfg.cur_scan_cumu_mode, acc, weights[j] * mag[:, j])
    return torch.fft.fftshift(acc, dim=-1)


# ---------------------------------------------------------------------------
# The kernels' tables and launches.
# ---------------------------------------------------------------------------

def _frag_a_index():
    """(row, col) of the 8 bf16 values lane l holds in an m16n8k16 A
    fragment (16 x 16, row-major), in register order: a0 (g, 2t..2t+1), a1
    (g+8, ..), a2 (g, 2t+8..), a3 (g+8, 2t+8..); g = l // 4, t = l % 4."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rows = np.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], axis=1)
    cols = np.stack([2 * t, 2 * t + 1, 2 * t, 2 * t + 1,
                     2 * t + 8, 2 * t + 9, 2 * t + 8, 2 * t + 9], axis=1)
    return rows, cols


def _frag_b_index():
    """(row k, col n) of the 4 bf16 values lane l holds in an m16n8k16 B
    fragment (16 x 8): b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rows = np.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], axis=1)
    return rows, np.repeat(g[:, None], 4, axis=1)


def ldmatrix_lanes(trans: bool):
    """(plane offset, row, column) of the 8 bf16 that lane l points
    ``ldmatrix.x4`` at in Kernel A, relative to the fragment's tile: stage
    1's B fragments (``trans``: row l % 16 of plane q + l // 16, so one x4
    loads the fragments of planes q and q + 1) and stage 2's A fragments
    (row l % 8 + 8 ((l // 8) % 2), column 8 (l // 16); registers a0..a3)."""
    lane = np.arange(32)
    if trans:
        return lane // 16, lane % 16, np.zeros(32, int)
    return (np.zeros(32, int), lane % 8 + 8 * ((lane // 8) % 2),
            8 * (lane // 16))


def bf16_halves(x: np.ndarray, parts: int = 2):
    """The bf16 bits (uint16) of the hi and lo halves of float32 ``x``
    (``parts`` 3: hi, mid and lo of ``mxu_fft.split3_bf16``)."""
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def bits(v):
        return v.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return tuple(bits(v) for v in (split3_bf16(x) if parts == 3
                                   else split_bf16(x)))


def frag_a(mats, m_tiles: int, k_tiles: int, parts: int = 2) -> np.ndarray:
    """A fragments of matrices padded to (16 m_tiles, 16 k_tiles):
    ``[slot][mt][kc][lane][8]`` uint16, slot = parts * matrix + part (0 hi,
    1 lo; with 3 parts 1 mid, 2 lo)."""
    rows, cols = _frag_a_index()
    mt = np.arange(m_tiles)[:, None, None, None] * 16
    kc = np.arange(k_tiles)[None, :, None, None] * 16
    out = []
    for m in mats:
        pad = np.zeros((16 * m_tiles, 16 * k_tiles), np.float32)
        pad[:m.shape[0], :m.shape[1]] = m
        for half in bf16_halves(pad, parts):
            out.append(half[mt + rows, kc + cols])
    return np.stack(out)


def frag_b(mats, k_tiles: int, n_tiles: int, parts: int = 2) -> np.ndarray:
    """B fragments of matrices padded to (16 k_tiles, 8 n_tiles):
    ``[slot][kc][nt][lane][4]`` uint16, slot = parts * matrix + part."""
    rows, cols = _frag_b_index()
    kc = np.arange(k_tiles)[:, None, None, None] * 16
    nt = np.arange(n_tiles)[None, :, None, None] * 8
    out = []
    for m in mats:
        pad = np.zeros((16 * k_tiles, 8 * n_tiles), np.float32)
        pad[:m.shape[0], :m.shape[1]] = m
        for half in bf16_halves(pad, parts):
            out.append(half[kc + rows, nt + cols])
    return np.stack(out)


def table_parts(prec: str) -> int:
    """The bf16 parts a matrix of the kernels' tables holds at ``prec``: 2
    (hi, lo) up to HIGH, 3 at HIGHEST."""
    return 3 if prec == "HIGHEST" else 2


def _padded16(n1: int) -> int:
    return -(-n1 // _MMA) * _MMA


@functools.lru_cache(maxsize=32)
def tc_tables(n: int, device: torch.device, parts: int = 2):
    """Kernel A's tables for fft ``n`` on ``device``: F1's A fragments
    (F1r, F1i, F1r + F1i; 6 slots, 9 with 3 ``parts``, ``(n1p/16)^2``
    tiles), F2^T's B fragments (F2r^T, F2i^T, (F2r + F2i)^T; as many slots,
    8 x 16 tiles), both bf16 bits as int16, and the twiddles ``(n1p, 128,
    2)`` float32 with zero rows from n1."""
    n1 = n // _N2
    n1p = _padded16(n1)
    f1r, f1i, f2r, f2i, twr, twi = _dft_tables_for(n, n1, _N2)
    f1 = frag_a((f1r, f1i, f1r + f1i), n1p // _MMA, n1p // _MMA, parts)
    f2 = frag_b((f2r.T, f2i.T, (f2r + f2i).T), _N2 // _MMA, _N2 // 8, parts)
    tw = np.zeros((n1p, _N2, 2), np.float32)
    tw[:n1, :, 0], tw[:n1, :, 1] = twr, twi

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)
    return dev(f1.view(np.int16)), dev(f2.view(np.int16)), dev(tw)


@functools.lru_cache(maxsize=32)
def tc_split_tables(n1: int, n2: int, device: torch.device, parts: int = 2):
    """Kernel C's tables for the split ``n = n1 * n2`` on ``device``: F1's A
    fragments (F1r, F1i, F1r + F1i; 6 slots, 9 with 3 ``parts``,
    ``(n1p/16)^2`` tiles), F2^T's B fragments (F2r^T, F2i^T, (F2r + F2i)^T;
    as many slots, ``n2p/16 x n2p/8`` tiles), both bf16 bits as int16, and
    the twiddles ``(n1p, n2p, 2)`` float32, zero outside ``(n1, n2)``."""
    n1p, n2p = _padded16(n1), _padded16(n2)
    f1r, f1i, f2r, f2i, twr, twi = _dft_tables_for(n1 * n2, n1, n2)
    f1 = frag_a((f1r, f1i, f1r + f1i), n1p // _MMA, n1p // _MMA, parts)
    f2 = frag_b((f2r.T, f2i.T, (f2r + f2i).T), n2p // _MMA, n2p // 8, parts)
    tw = np.zeros((n1p, n2p, 2), np.float32)
    tw[:n1, :n2, 0], tw[:n1, :n2, 1] = twr, twi

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)
    return dev(f1.view(np.int16)), dev(f2.view(np.int16)), dev(tw)


def packed_k_tiles(n: int) -> int:
    """Kernel B's k-chunks of 16 for fft ``n`` (n padded to 16 on K), also
    its m-tiles of 16 bins (n padded to 16 on M) and warps a block."""
    return max(1, n // _MMA)


@functools.lru_cache(maxsize=32)
def packed_tc_tables(n: int, window: str, mode: str, w_cnt: int,
                     device: torch.device):
    """Kernel B's tables on ``device``: the A fragments of the transposed
    DFT table ``Dt^T`` (bins x samples; slots Dr hi, Dr lo, Di hi, Di lo;
    ``packed_k_tiles(n)`` m-tiles x as many k-chunks, bf16 bits as int16)
    and the float32 fold weights."""
    dtr, dti, weights = _packed_plain_tables(n, window, mode, w_cnt,
                                             torch.device("cpu"))
    kc = packed_k_tiles(n)
    dt = frag_a((dtr.numpy().T, dti.numpy().T), kc, kc)
    return (torch.as_tensor(np.ascontiguousarray(dt.view(np.int16))).to(
        device), weights.to(device))


class PackedTcPlan(NamedTuple):
    """How Kernel B stages one launch (``csrc/curscan_packed_tc.cu``)."""
    chunk: int      # windows a staged span
    n_chunks: int
    stride: int     # samples a staging row: the widest chunk's span
    smem: int       # shared memory a block, bytes


def packed_tc_hold(n: int, high: bool) -> bool:
    """Kernel B keeps the table's fragments of a warp's m-tile in registers
    (at most 64 a thread): every fft but 128 at HIGH, which reads them from
    a copy in shared memory."""
    return packed_k_tiles(n) * (2 if high else 1) <= 8


def packed_tc_plane_words(stride: int) -> int:
    """32-bit words of one of Kernel B's operand planes for a staging row of
    ``stride`` samples: the row's pairs and 16 samples past it, padded so a
    shifted plane starts 16 banks from its unshifted one."""
    return -(-(stride // 2 + 8) // 32) * 32 + 16


def packed_tc_table_bytes(n: int, high: bool) -> int:
    """Kernel B's copy of the table in shared memory: 4 slots of
    ``packed_k_tiles(n)``^2 tiles of 32 lanes x 16 bytes, where
    :func:`packed_tc_hold` is false, else none."""
    kc = packed_k_tiles(n)
    return 0 if packed_tc_hold(n, high) else 4 * kc * kc * 32 * 16


def packed_tc_smem(n: int, stride: int, u8: bool, high: bool) -> int:
    """Kernel B's shared memory a block: two staging buffers of both
    planes, the operand planes (re, im; hi, HIGH lo; unshifted and
    shifted) and the table's copy (:func:`packed_tc_table_bytes`)."""
    return (4 * stride * (1 if u8 else 4)
            + 16 * (2 if high else 1) * packed_tc_plane_words(stride)
            + packed_tc_table_bytes(n, high))


def packed_tc_spans(starts, n: int, chunk: int, u8: bool) -> np.ndarray:
    """``(n_chunks, 2)``: the first sample and the length of each chunk's
    staged span (from the chunk's first start rounded down to 16 bytes to
    its last window's end rounded up)."""
    align = 16 if u8 else 4
    st = np.asarray(starts, np.int64)
    a0 = st[0::chunk] // align * align
    return np.stack([a0, cuda_packed.chunk_spans(st, n, chunk, align)], 1)


@functools.lru_cache(maxsize=64)
def packed_tc_plan(n: int, starts: tuple, u8: bool,
                   high: bool) -> PackedTcPlan:
    """Kernel B's chunks: all windows in one span when their float32
    staging fits ``PACKED_TC_STAGE_BYTES``, else the most windows, a
    multiple of 8 (an n-tile) where 8 fit, whose widest span fits.  The
    chunk comes from float32 planes for both input types, so a u8 block
    folds its windows on the same lanes, in the same order, as its decoded
    float32."""
    w = len(starts)

    def fits(chunk):
        stride = int(cuda_packed.chunk_spans(starts, n, chunk, 4).max())
        return (packed_tc_smem(n, stride, False, high)
                - packed_tc_table_bytes(n, high)) <= PACKED_TC_STAGE_BYTES

    def most(hi, step):
        """The largest m in [1, hi] with m * step windows fitting (1 if
        none does)."""
        lo = 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if fits(mid * step):
                lo = mid
            else:
                hi = mid - 1
        return lo

    chunk = w
    if not fits(w):
        chunk = most(-(-w // 8) - 1, 8) * 8 if fits(8) else most(7, 1)
    stride = int(packed_tc_spans(starts, n, chunk, u8)[:, 1].max())
    return PackedTcPlan(chunk, -(-w // chunk), stride,
                        packed_tc_smem(n, stride, u8, high))


def packed_tc_grid(t: int, sms: int, per_sm: int) -> int:
    """Kernel B's thread blocks: one an IQ block up to the card's resident
    blocks (``sms`` x ``per_sm``), then that many, each walking IQ blocks a
    grid apart."""
    return max(1, min(t, sms * max(1, per_sm)))


def tc_windows_per_pass(n1: int, n_windows: int) -> int:
    """Kernel A's windows a pass: as many as stack into ``TC_PASS_ROWS``
    rows of n1 rounded up to 16, at least 1, at most the windows."""
    return max(1, min(n_windows, TC_PASS_ROWS // _padded16(n1)))


def tc_groups(t: int, n1: int, n_windows: int, sms: int,
              per_sm: int) -> int:
    """Kernel A's window groups per IQ block: the G in 1..W that minimises
    ``ceil(t G / (sms per_sm)) (W / G + 1)``, waves of blocks times a
    block's windows plus one window's worth of set-up, the smallest on a
    tie.  ``per_sm`` is the blocks an SM holds (:func:`tc_occupancy`)."""
    slots = max(1, sms * per_sm)
    t = max(1, t)
    return min(range(1, max(1, n_windows) + 1),
               key=lambda g: (-(-t * g // slots) * (n_windows + g) / g, g))


def _cuda_lib(dev: torch.device):
    if dev.type != "cuda":
        raise ValueError(f"no tensor-core curscan kernel for device {dev}")
    from kspecanal_tpu_torch.ops import _build
    return _build.load()


def tc_stage_stop(stage: str) -> int:
    """``KSPEC_TC_STOP`` of K4's ``stage``: read 1 .. s2 5; 'full' is the
    production kernel (0)."""
    return (STAGES.index(stage) + 1) % len(STAGES)


def stage_variants():
    """``(sources, defines)`` of Kernel A's five cut-off builds, as
    ``_build.build`` and ``_build.load_variant`` take them."""
    return [(TC_SOURCES, (f"KSPEC_TC_STOP={tc_stage_stop(s)}",))
            for s in STAGES[:-1]]


def stage_library(stage: str, highest: bool = False):
    """The forensic build of Kernel A cut off after ``stage`` (any but
    'full'; ``highest``: the HIGHEST build's), built on first use
    (``build_stage_libraries`` builds all five at once)."""
    from kspecanal_tpu_torch.ops import _build
    return _build.load_variant(
        TC_SOURCES, (HIGHEST_DEFINE,) * highest
        + (f"KSPEC_TC_STOP={tc_stage_stop(stage)}",))


def build_stage_libraries(highest: bool = False) -> None:
    """Build the five cut-off libraries that are not built yet at once (one
    nvcc per source and cut-off, all started together); ``highest``: the
    HIGHEST forensic builds (:func:`highest_variants`) instead."""
    from kspecanal_tpu_torch.ops import _build
    _build.build(highest_variants() if highest else stage_variants(),
                 library=False)


def ablate_variants():
    """``(sources, defines)`` of the two ablate builds (Kernels A and C), as
    ``_build.build`` and ``_build.load_variant`` take them."""
    return [TC_ABLATE, TC_SPLIT_ABLATE]


def highest_variants():
    """``(sources, defines)`` of the HIGHEST forensic builds: Kernel A
    whole (:func:`highest_library`), its five cut-offs and its ablate
    build, and Kernel C's ablate build."""
    return [(TC_SOURCES, (HIGHEST_DEFINE,))] + [
        (names, (HIGHEST_DEFINE,) + defines)
        for names, defines in stage_variants() + ablate_variants()]


def highest_library():
    """Kernel A at HIGHEST (``-DKSPEC_TC_HIGHEST=1``, forensics: K4's 'full'
    and the window groups of the HIGHEST forms), built on first use."""
    from kspecanal_tpu_torch.ops import _build
    return _build.load_variant(TC_SOURCES, (HIGHEST_DEFINE,))


def tc_ablate_library(highest: bool = False):
    """Kernel A's ablate build (``-DKSPEC_TC_ABLATE=1``; ``highest``: with
    ``-DKSPEC_TC_HIGHEST=1``), built on first use."""
    from kspecanal_tpu_torch.ops import _build
    return _build.load_variant(
        TC_ABLATE[0], (HIGHEST_DEFINE,) * highest + TC_ABLATE[1])


def tc_split_ablate_library(highest: bool = False):
    """Kernel C's ablate build (``-DKSPEC_TCS_ABLATE=1``; ``highest``: with
    ``-DKSPEC_TC_HIGHEST=1``), built on first use."""
    from kspecanal_tpu_torch.ops import _build
    return _build.load_variant(
        TC_SPLIT_ABLATE[0], (HIGHEST_DEFINE,) * highest + TC_SPLIT_ABLATE[1])


def curscan_tc(iq_re: torch.Tensor, iq_im: torch.Tensor, cfg: SpecConfig,
               form: Optional[str] = None,
               ablate: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Kernel A: ``(T, full_size)`` float32 or raw-u8 planes ->
    ``(T, fft_size)`` fftshifted linear spectra at the config's class, in
    the 4M complex form or ``form``'s ("force3m" 3M, "no3m" 4M).  CUDA
    tensors launch the kernel on the current stream without synchronising;
    CPU tensors run :func:`curscan_tc_plain`.

    ``ablate`` (forensics; the JAX kernel's keys at the class): a sequence
    of stage keys (``cuda_curscan.ABLATE_KEYS``) launches Kernel A's ablate
    build (:func:`tc_ablate_library`) with those stages removed, at the
    port's library's window groups, counted in ``tc_ablate_launches``; the
    spectra are then wrong by construction.  No key, or 'concat' alone,
    runs the production kernel's operations: its output equals the
    production launch's bit for bit.  At HIGHEST (``ablate`` only; up to fft
    ``TC_MAX_FFT_SIZE``) the HIGHEST ablate build runs, at the window
    groups of :func:`highest_library`."""
    global tc_launches, tc_ablate_launches
    highest = ablate is not None and supports_highest_forensics(cfg) \
        and cfg.fft_size <= TC_MAX_FFT_SIZE
    if not (supports_tc(cfg) or highest):
        raise ValueError(f"config not supported by the tensor-core curscan "
                         f"kernel (tpuPrecision {cfg.tpu_precision}, fft_size "
                         f"{cfg.fft_size}, full_size {cfg.full_size})")
    check_planes(iq_re, iq_im, cfg)
    tm = three_mult(form)
    stages = _stage_keys(ablate)
    if iq_re.device.type == "cpu":
        return curscan_tc_plain(iq_re, iq_im, cfg, form, ablate)
    prod = highest_library() if highest else _cuda_lib(iq_re.device)
    if ablate is None:
        out = launch_tc(prod, iq_re, iq_im, cfg, tm)
        tc_launches += 1
        return out
    lib = tc_ablate_library(highest=True) if highest else tc_ablate_library()
    n1 = cfg.fft_size // _N2
    if highest and lib.kspec_curscan_tc_smem(
            n1, tc_windows_per_pass(n1, cfg.num_windows), PREC_CODE["HIGHEST"],
            int(tm)) > TC_SMEM_LIMIT:
        raise ValueError(f"Kernel A's HIGHEST operand planes (n1 = {n1}, "
                         f"{'3M' if tm else '4M'}) exceed a block's "
                         f"{TC_SMEM_LIMIT} bytes of shared memory: 3M fits "
                         f"up to n1 = 80")
    out = launch_tc(lib, iq_re, iq_im, cfg, tm,
                    tc_launch_groups(prod, iq_re, cfg, tm),
                    ablate_mask(stages))
    tc_ablate_launches += 1
    return out


@functools.lru_cache(maxsize=256)
def tc_occupancy(lib, u8: bool, n1: int, wb: int, prec: int,
                 tm: bool) -> int:
    """The blocks an SM holds of ``lib``'s Kernel A instantiation for these
    arguments (``prec`` the kernels' precision code, ``PREC_CODE``; the
    CUDA occupancy calculator: registers and shared memory); raises where
    the library cannot say."""
    blocks = lib.kspec_curscan_tc_occupancy(int(u8), n1, wb, int(prec),
                                            int(tm))
    if blocks < 1:
        raise RuntimeError(f"Kernel A's occupancy for n1 {n1}, {wb} "
                           f"window(s) a pass: {blocks}")
    return blocks


def tc_launch_groups(lib, iq_re: torch.Tensor, cfg: SpecConfig,
                     tm: bool) -> int:
    """Kernel A's window groups for ``iq_re``'s blocks of ``cfg``:
    :func:`tc_groups` at ``lib``'s occupancy on the planes' card."""
    n1, w = cfg.fft_size // _N2, cfg.num_windows
    return tc_groups(
        iq_re.shape[0], n1, w,
        torch.cuda.get_device_properties(
            iq_re.device).multi_processor_count,
        tc_occupancy(lib, iq_re.dtype == torch.uint8, n1,
                     tc_windows_per_pass(n1, w),
                     PREC_CODE[precision_class(cfg)], tm))


def curscan_tc_stage(iq_re: torch.Tensor, iq_im: torch.Tensor,
                     cfg: SpecConfig, stage: str) -> torch.Tensor:
    """K4: Kernel A (4M) cut off after ``stage`` (``STAGES``) at the
    config's class (``FORENSIC_CLASSES``) on ``(T, full_size)`` float32
    planes -> ``(T, n1, 128)`` in the layout of
    ``cuda_curscan.curscan_stage_ablate``.  Each cut-off is a build of its
    own (:func:`stage_library`), 'full' the port's library (HIGHEST:
    :func:`highest_library`); all run that library's window groups
    (:func:`tc_launch_groups`), so 'full' after the layout map is its
    output bit for bit (its map to K4's layout is a copy: the cut-offs
    store that layout themselves).  CUDA tensors launch (counted in
    ``tc_stage_launches``); CPU tensors run
    :func:`curscan_tc_stage_plain`."""
    global tc_stage_launches
    check_stage_config(iq_re, cfg, stage)
    highest = supports_highest_forensics(cfg)
    if not (supports_tc(cfg) or highest):
        raise ValueError(f"config not supported by the tensor-core curscan "
                         f"kernel (tpuPrecision {cfg.tpu_precision}, fft_size "
                         f"{cfg.fft_size})")
    check_planes(iq_re, iq_im, cfg)
    if iq_re.device.type == "cpu":
        return curscan_tc_stage_plain(iq_re, iq_im, cfg, stage)
    prod = highest_library() if highest else _cuda_lib(iq_re.device)
    lib = prod if stage == "full" else (stage_library(stage, highest=True)
                                        if highest else stage_library(stage))
    out = launch_tc(lib, iq_re, iq_im, cfg, False,
                    tc_launch_groups(prod, iq_re, cfg, False))
    tc_stage_launches += 1
    n1 = cfg.fft_size // _N2
    if stage == "full":
        return spectrum_to_stage_layout(out, n1)
    return out.view(-1, n1, _N2)       # a cut-off stores K4's layout


def launch_tc(lib, iq_re: torch.Tensor, iq_im: torch.Tensor,
              cfg: SpecConfig, tm: bool, groups: Optional[int] = None,
              ablate: Optional[int] = None) -> torch.Tensor:
    """Launch ``lib``'s Kernel A (the port's library, or a forensic build of
    the same sources, ``scripts/tc_stages.py``) on CUDA planes checked by
    :func:`curscan_tc`, in ``groups`` window groups (default
    :func:`tc_groups` at ``lib``'s occupancy), through the ablate build's
    entry with the mask ``ablate`` where given; counts nothing."""
    dev = iq_re.device
    u8 = iq_re.dtype == torch.uint8
    t, n = iq_re.shape[0], cfg.fft_size
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    iq_re, iq_im = _aligned(iq_re), _aligned(iq_im)
    n1, w = n // _N2, cfg.num_windows
    prec = precision_class(cfg)
    wb = tc_windows_per_pass(n1, w)
    if groups is None:
        groups = tc_launch_groups(lib, iq_re, cfg, tm)
    part = (torch.empty((t, groups, n), dtype=torch.float32, device=dev)
            if groups > 1 else None)
    starts, weights, window, _ = _tables(n, cfg.window, cfg.window_starts,
                                         cfg.cur_scan_cumu_mode, dev)
    f1, f2, tw = tc_tables(n, dev, table_parts(prec))
    fn = lib.kspec_curscan_tc if ablate is None else \
        lib.kspec_curscan_tc_ablate
    with torch.cuda.device(dev):
        err = fn(
            iq_re.data_ptr(), iq_im.data_ptr(), int(u8), out.data_ptr(),
            0 if part is None else part.data_ptr(), starts.data_ptr(),
            weights.data_ptr(), window.data_ptr(), f1.data_ptr(),
            f2.data_ptr(), tw.data_ptr(), t, cfg.full_size, n, n1, w, groups,
            _FOLD[cfg.cur_scan_cumu_mode], wb, PREC_CODE[prec], int(tm),
            *(() if ablate is None else (ablate,)),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, fn)
    return out


def check_tc_split_stage(stage: str) -> None:
    if stage not in TC_SPLIT_STAGES:
        raise ValueError(f"unknown Kernel C stage {stage!r}; stages: "
                         f"{TC_SPLIT_STAGES}")


def tc_split_stage_stop(stage: str) -> int:
    """``KSPEC_TCS_STOP`` of Kernel C's ``stage``: frame 1 .. s2 4; 'full'
    is the production kernel (0)."""
    check_tc_split_stage(stage)
    return (TC_SPLIT_STAGES.index(stage) + 1) % len(TC_SPLIT_STAGES)


def tc_split_stage_variants():
    """``(sources, defines)`` of Kernel C's four cut-off builds, as
    ``_build.build`` and ``_build.load_variant`` take them."""
    return [(TC_SPLIT_SOURCES, (f"KSPEC_TCS_STOP={tc_split_stage_stop(s)}",))
            for s in TC_SPLIT_STAGES[:-1]]


def tc_split_stage_library(stage: str):
    """The forensic build of Kernel C cut off after ``stage`` (any but
    'full'), built on first use."""
    from kspecanal_tpu_torch.ops import _build
    return _build.load_variant(
        TC_SPLIT_SOURCES, (f"KSPEC_TCS_STOP={tc_split_stage_stop(stage)}",))


def curscan_tc_split_stage(iq_re: torch.Tensor, iq_im: torch.Tensor,
                           cfg: SpecConfig, stage: str,
                           form: Optional[str] = None,
                           split: Optional[Tuple[int, int]] = None
                           ) -> torch.Tensor:
    """Kernel C cut off after ``stage`` (``TC_SPLIT_STAGES``, forensics):
    ``(T, full_size)`` planes -> ``(T, fft_size)`` in the production
    layout, each element of the stage's weighted re + im summed over the
    windows ('full' is the production kernel).  Each cut-off is a build of
    its own (:func:`tc_split_stage_library`), and all run the window groups
    of the port's library (:func:`tc_split_launch_groups`), so 'full' is
    Kernel C's production output bit for bit.  CUDA tensors launch (counted
    in ``tc_split_stage_launches``); CPU tensors run
    :func:`curscan_tc_split_stage_plain`."""
    global tc_split_stage_launches
    check_tc_split_stage(stage)
    if not supports_tc_split(cfg):
        raise ValueError(f"config not supported by the split tensor-core "
                         f"curscan kernel (tpuPrecision {cfg.tpu_precision}, "
                         f"fft_size {cfg.fft_size})")
    check_planes(iq_re, iq_im, cfg)
    split = split or tc_split(cfg, iq_re.dtype == torch.uint8)
    if iq_re.device.type == "cpu":
        return curscan_tc_split_stage_plain(iq_re, iq_im, cfg, stage, form,
                                            split)
    prod = _cuda_lib(iq_re.device)
    lib = prod if stage == "full" else tc_split_stage_library(stage)
    tm = three_mult(form)
    out = launch_tc_split(lib, iq_re, iq_im, cfg, tm, split,
                          tc_split_launch_groups(prod, iq_re, cfg, tm, split))
    tc_split_stage_launches += 1
    return out


@functools.lru_cache(maxsize=256)
def tc_split_occupancy(lib, u8: bool, n1: int, n2: int, prec: int,
                       tm: bool) -> int:
    """The blocks an SM holds of ``lib``'s Kernel C instantiation for the
    split ``n1 x n2`` (``prec`` the precision code, ``PREC_CODE``; the CUDA
    occupancy calculator: registers and shared memory); raises where the
    library cannot say."""
    blocks = lib.kspec_curscan_tc_split_occupancy(int(u8), n1, n2,
                                                  int(prec), int(tm))
    if blocks < 1:
        raise RuntimeError(f"Kernel C's occupancy for the split {n1} x "
                           f"{n2}: {blocks}")
    return blocks


def supports_tc_split(cfg: SpecConfig) -> bool:
    """Kernel C takes ``cfg`` (``cuda_curscan.kernel_route`` is
    "tc_split"): class HIGH or DEFAULT and a config the JAX dispatcher sends
    to a Pallas curscan kernel that Kernel A does not take."""
    return kernel_route(cfg) == "tc_split"


def curscan_tc_split(iq_re: torch.Tensor, iq_im: torch.Tensor,
                     cfg: SpecConfig, form: Optional[str] = None,
                     split: Optional[Tuple[int, int]] = None,
                     ablate: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Kernel C: ``(T, full_size)`` float32 or raw-u8 planes ->
    ``(T, fft_size)`` fftshifted linear spectra at the config's class, in
    the 4M complex form or ``form``'s, on ``split`` ``(n1, n2)`` (default
    ``cuda_curscan.tc_split`` for the planes' type: the JAX dispatcher's).
    CUDA tensors launch the kernel on the current stream without
    synchronising; CPU tensors run :func:`curscan_tc_split_plain`.
    ``ablate``: as :func:`curscan_tc`'s, on Kernel C's ablate build
    (:func:`tc_split_ablate_library`, which takes the splits whose frame it
    stages), counted in ``tc_split_ablate_launches``; at HIGHEST (``ablate``
    only, the sublane predicate; default split ``(n / 128, 128)``) its
    HIGHEST build, at its own occupancy's window groups."""
    global tc_split_launches, tc_split_ablate_launches
    highest = ablate is not None and supports_highest_forensics(cfg)
    if not (supports_tc_split(cfg) or highest):
        raise ValueError(f"config not supported by the split tensor-core "
                         f"curscan kernel (tpuPrecision {cfg.tpu_precision}, "
                         f"fft_size {cfg.fft_size}, full_size "
                         f"{cfg.full_size})")
    check_planes(iq_re, iq_im, cfg)
    tm = three_mult(form)
    n1, n2 = split or ((cfg.fft_size // _N2, _N2) if highest else
                       tc_split(cfg, iq_re.dtype == torch.uint8))
    if n1 < 1 or n2 < 1 or n1 * n2 != cfg.fft_size:
        raise ValueError(f"split {(n1, n2)} is not a factorisation of "
                         f"fft_size {cfg.fft_size}")
    stages = _stage_keys(ablate)
    if iq_re.device.type == "cpu":
        return curscan_tc_split_plain(iq_re, iq_im, cfg, form, (n1, n2),
                                      ablate)
    if highest:
        lib = prod = tc_split_ablate_library(highest=True)
    else:
        prod = _cuda_lib(iq_re.device)
        if ablate is None:
            out = launch_tc_split(prod, iq_re, iq_im, cfg, tm, (n1, n2))
            tc_split_launches += 1
            return out
        lib = tc_split_ablate_library()
    out = launch_tc_split(lib, iq_re, iq_im, cfg, tm, (n1, n2),
                          tc_split_launch_groups(prod, iq_re, cfg, tm,
                                                 (n1, n2)),
                          ablate_mask(stages))
    tc_split_ablate_launches += 1
    return out


def tc_split_max_n2(prec: str, tm: bool = False) -> int:
    """The widest n2 whose 16 rows of C fit a block's shared memory in
    Kernel C at class ``prec`` and form (``tm``: 3M), as its ``pick``
    (``csrc/curscan_tc_split.cuh``) decides: forms x parts planes of 16 rows
    of n2 padded to 16, plus 8, bf16, within 232,448 bytes.  4M: 3616 at
    DEFAULT, 1808 at HIGH, 1200 at HIGHEST (3M: 2400, 1200, 784; ROADMAP
    G1).  The sublane split's n2 = 128 fits at every class, so the ablate
    keys at HIGHEST take every fft of the sublane predicate above 16384."""
    planes = (3 if tm else 2) * (PREC_CODE[prec] + 1)
    return (232448 // (planes * 16 * 2) - 8) // _MMA * _MMA


def tc_split_tiles(lib, n1: int, n2: int, prec: int, tm: bool) -> int:
    """Kernel C's k1 tiles a block of the split ``n1 x n2`` at precision
    code ``prec``: n1's m-tiles of 16 over the library's m-tiles a block (0
    where none fits)."""
    mt = lib.kspec_curscan_tc_split_mt(n1, n2, int(prec), int(tm))
    nmt = -(-n1 // _MMA)
    return -(-nmt // mt) if mt > 0 else 0


def tc_split_groups(t: int, tiles: int, n_windows: int, sms: int,
                    per_sm: int) -> int:
    """Kernel C's window groups per IQ block and k1 tile: :func:`tc_groups`
    over its ``t * tiles`` thread blocks (the G in 1..W that minimises
    waves of blocks times a block's windows plus one window's set-up)."""
    return tc_groups(t * tiles, 0, n_windows, sms, per_sm)


def tc_split_launch_groups(lib, iq_re: torch.Tensor, cfg: SpecConfig,
                           tm: bool, split: Tuple[int, int]) -> int:
    """Kernel C's window groups for ``iq_re``'s blocks of ``cfg`` on
    ``split``: :func:`tc_split_groups` at ``lib``'s occupancy on the
    planes' card."""
    n1, n2 = split
    prec = PREC_CODE[precision_class(cfg)]
    return tc_split_groups(
        iq_re.shape[0], tc_split_tiles(lib, n1, n2, prec, tm),
        cfg.num_windows,
        torch.cuda.get_device_properties(iq_re.device).multi_processor_count,
        tc_split_occupancy(lib, iq_re.dtype == torch.uint8, n1, n2, prec,
                           tm))


def launch_tc_split(lib, iq_re: torch.Tensor, iq_im: torch.Tensor,
                    cfg: SpecConfig, tm: bool, split: Tuple[int, int],
                    groups: Optional[int] = None,
                    ablate: Optional[int] = None) -> torch.Tensor:
    """Launch ``lib``'s Kernel C (the port's library, or a forensic build of
    the same sources, ``scripts/tc_split_stages.py``) on CUDA planes checked
    by :func:`curscan_tc_split`, in ``groups`` window groups (default
    :func:`tc_split_launch_groups` at ``lib``'s occupancy), through the
    ablate build's entry with the mask ``ablate`` where given; counts
    nothing.
    Raises where 16 rows of C do not fit a block's shared memory (the
    library's m-tiles a block are 0: n2 above :func:`tc_split_max_n2`)."""
    dev = iq_re.device
    t, n = iq_re.shape[0], cfg.fft_size
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    n1, n2 = split
    prec = precision_class(cfg)
    if lib.kspec_curscan_tc_split_mt(n1, n2, PREC_CODE[prec], int(tm)) < 1:
        raise ValueError(
            f"Kernel C keeps 16 rows of C (n2 = {n2}) in a block's shared "
            f"memory, which they exceed at {prec} {'3M' if tm else '4M'}: "
            f"n2 <= {tc_split_max_n2(prec, tm)} fits")
    if groups is None:
        groups = tc_split_launch_groups(lib, iq_re, cfg, tm, split)
    part = (torch.empty((t, groups, n), dtype=torch.float32, device=dev)
            if groups > 1 else None)
    starts, weights, window, _ = _tables(n, cfg.window, cfg.window_starts,
                                         cfg.cur_scan_cumu_mode, dev)
    f1, f2, tw = tc_split_tables(n1, n2, dev, table_parts(prec))
    fn = lib.kspec_curscan_tc_split if ablate is None else \
        lib.kspec_curscan_tc_split_ablate
    with torch.cuda.device(dev):
        err = fn(
            iq_re.data_ptr(), iq_im.data_ptr(),
            int(iq_re.dtype == torch.uint8), out.data_ptr(),
            0 if part is None else part.data_ptr(), starts.data_ptr(),
            weights.data_ptr(), window.data_ptr(), f1.data_ptr(),
            f2.data_ptr(), tw.data_ptr(), t, cfg.full_size, n, n1, n2,
            cfg.num_windows, groups, _FOLD[cfg.cur_scan_cumu_mode],
            PREC_CODE[prec], int(tm), *(() if ablate is None else (ablate,)),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, fn)
    return out


def curscan_packed_tc(iq_re: torch.Tensor, iq_im: torch.Tensor,
                      cfg: SpecConfig) -> torch.Tensor:
    """Kernel B: ``(T, full_size)`` float32 or raw-u8 planes ->
    ``(T, fft_size)`` fftshifted linear spectra at the config's class (4M).
    CUDA tensors launch the kernel on the current stream without
    synchronising; CPU tensors run :func:`curscan_packed_tc_plain`."""
    global packed_tc_launches
    if not supports_packed_tc(cfg):
        raise ValueError(f"config not supported by the tensor-core packed "
                         f"kernel (tpuPrecision {cfg.tpu_precision}, "
                         f"fft_size {cfg.fft_size}, full_size "
                         f"{cfg.full_size})")
    check_planes(iq_re, iq_im, cfg)
    if iq_re.device.type == "cpu":
        return curscan_packed_tc_plain(iq_re, iq_im, cfg)
    out = launch_packed_tc(_cuda_lib(iq_re.device), iq_re, iq_im, cfg)
    packed_tc_launches += 1
    return out


@functools.lru_cache(maxsize=256)
def packed_tc_occupancy(lib, u8: bool, n: int, high: bool, mode: str,
                        stride: int) -> int:
    """The blocks an SM holds of ``lib``'s Kernel B instantiation for these
    arguments (cumulate ``mode``; the CUDA occupancy calculator: registers
    and shared memory); raises where the library cannot say."""
    blocks = lib.kspec_curscan_packed_tc_occupancy(int(u8), n, int(high),
                                                   _FOLD[mode], stride)
    if blocks < 1:
        raise RuntimeError(f"Kernel B's occupancy for fft {n}, a staging "
                           f"row of {stride} samples: {blocks}")
    return blocks


@functools.lru_cache(maxsize=64)
def _packed_tc_args(lib, cfg: SpecConfig, t: int, u8: bool,
                    device: torch.device):
    """The device tables (starts, weights, table) and the integer arguments
    from ``t`` on of one launch, computed once per library, config, T and
    input type (``cfg.window_starts`` is a Python loop)."""
    n, starts = cfg.fft_size, cfg.window_starts
    mode, high = cfg.cur_scan_cumu_mode, precision_class(cfg) == "HIGH"
    plan = packed_tc_plan(n, starts, u8, high)
    grid = packed_tc_grid(t, torch.cuda.get_device_properties(
        device).multi_processor_count, packed_tc_occupancy(
            lib, u8, n, high, mode, plan.stride))
    dt, weights = packed_tc_tables(n, cfg.window, mode, len(starts), device)
    tables = (_tables(n, cfg.window, starts, mode, device)[0], weights, dt)
    return tables, (t, cfg.full_size, n, len(starts), _FOLD[mode],
                    int(high), plan.chunk, plan.stride, grid)


def launch_packed_tc(lib, iq_re: torch.Tensor, iq_im: torch.Tensor,
                     cfg: SpecConfig) -> torch.Tensor:
    """Launch ``lib``'s Kernel B (the port's library, or a forensic build of
    the same source, ``scripts/packed_tc_stages.py``) on CUDA planes checked
    by :func:`curscan_packed_tc`, as :func:`packed_tc_plan` and
    :func:`packed_tc_grid` at the library's occupancy say; counts
    nothing."""
    dev = iq_re.device
    t = iq_re.shape[0]
    out = torch.empty((t, cfg.fft_size), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    iq_re, iq_im = _aligned(iq_re), _aligned(iq_im)
    u8 = iq_re.dtype == torch.uint8
    tables, ints = _packed_tc_args(lib, cfg, t, u8, dev)
    with torch.cuda.device(dev):
        err = lib.kspec_curscan_packed_tc(
            iq_re.data_ptr(), iq_im.data_ptr(), int(u8), out.data_ptr(),
            *(x.data_ptr() for x in tables), *ints,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib.kspec_curscan_packed_tc)
    return out
