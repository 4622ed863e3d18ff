"""The HIGH and DEFAULT precision classes of the port (``ops/cuda_tc.py``)
on the CPU, where the tensor-core kernels' wrappers run their plain
versions: against the JAX package's Pallas kernels at the same class (in
interpret mode), against the float64 oracle at the class bounds, the 3M
gate, u8 against decoded float32, HIGHEST unchanged, the route sets and
the class of the plain matrix products.

Tolerances, per bin (``m`` is the largest magnitude of any single window's
spectrum on the same planes, the level the class's rounding is a share
of; a MIN or RAW fold keeps that error while its own values go far below
it):

* port vs JAX at DEFAULT: on the CPU JAX's DEFAULT dots are float32
  (tests/test_pallas.py:88-107) while the port rounds every operand to
  bf16, so the two differ by the whole class error: ``|err| <= 3.9e-2 *
  (|jax| + m)``, the DEFAULT bound (docs/DESIGN.md:274-276).
* port vs JAX at HIGH: the port in the JAX gate's complex form
  (:func:`jax_form`; the port's own production form is 4M) and JAX take the
  same explicit bf16x3 split (``_make_dot.dot3``) and differ in the order of
  their float32 sums and,
  where the JAX kernel folds packed slots through a dot, in that dot's
  split: ``|err| <= 2e-5 * |jax| + 4e-6 * m``.
* the plain versions vs the float64 oracle, measured as
  ``scripts/threemult_smoke.py`` measures (AVG, per bin
  ``|got - oracle| / (|oracle| + 1e-6)``, worst bin): HIGH <= 5e-5,
  DEFAULT <= 3.9e-2 (ROADMAP.md C's table).
"""
import contextlib
import dataclasses
import stat
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu.ops import spectrum as jspec
from kspecanal_tpu_torch.config import (WINDOW_KAISER, WINDOW_ONES,
                                        win_adj, window_lut)
from kspecanal_tpu_torch.ops import _build, cuda_curscan, cuda_packed, cuda_tc
from kspecanal_tpu_torch.ops import mxu_fft
from kspecanal_tpu_torch.ops import spectrum as tspec
from kspecanal_tpu_torch.scripts import threemult_smoke
from torch_parity import MODES, assert_tc_close, decoded, raw_planes, zs_cfg

sys.path.insert(0, str(Path(__file__).parent))
from oracle import oracle_curscan  # noqa: E402

CLASSES = ("HIGH", "DEFAULT")
ORACLE_BOUND = {"HIGH": 5e-5, "DEFAULT": 3.9e-2}


def window_peak(re, im, cfg):
    """``m``: the largest winAdj*2/N * |fft(frame * win)| over the blocks,
    windows and bins of float planes, in float64."""
    n = cfg.fft_size
    x = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    idx = np.asarray(cfg.window_starts)[:, None] + np.arange(n)[None, :]
    spec = np.fft.fft(x[:, idx] * window_lut(cfg.window, n), axis=-1)
    return float(np.abs(spec).max()) * win_adj(cfg.window, n) * 2.0 / n


def assert_class_close(got, want, prec, m):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    if prec == "DEFAULT":
        tol = 3.9e-2 * (np.abs(want) + m)
    else:
        tol = 2e-5 * np.abs(want) + 4e-6 * m
    worst = float(np.max(err / tol))
    assert worst <= 1.0, f"{prec}: {worst:.3f} of the tolerance"


def oracle_error(got, re, im, cfg):
    """threemult_smoke.py's measure: per bin |got - oracle| / (|oracle| +
    1e-6), worst bin over the blocks."""
    win = window_lut(cfg.window, cfg.fft_size)
    worst = 0.0
    for b in range(got.shape[0]):
        x = re[b].astype(np.float64) + 1j * im[b].astype(np.float64)
        want = oracle_curscan(x, cfg.fft_size, cfg.cur_scan_non_overlap, win,
                              cfg.cur_scan_cumu_mode)
        worst = max(worst, float(np.max(np.abs(got[b] - want)
                                        / (np.abs(want) + 1e-6))))
    return worst


def gauss(cfg, t, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((t, cfg.full_size)).astype(np.float32)
                 for _ in range(2))


def port(fn, re, im, cfg, **kw):
    return fn(torch.from_numpy(re), torch.from_numpy(im), cfg, **kw).numpy()


def jax_form(cfg, u8):
    """The JAX gate's complex form as Kernel A's ``form``
    (``pallas_curscan.py:456-472``): 3M at HIGH, and at DEFAULT but for
    misaligned window starts on u8 planes."""
    deep_u8 = u8 and any(s % 128 for s in cfg.window_starts)
    three = cfg.tpu_precision == "HIGH" or not deep_u8
    return "force3m" if three else "no3m"


def tc_in_jax_form(re, im, cfg):
    """Kernel A's plain version in the JAX gate's form on numpy planes."""
    return port(cuda_tc.curscan_tc, re, im, cfg,
                form=jax_form(cfg, re.dtype == np.uint8))


# --- K1 against the JAX sublane kernel (50% overlap: aligned starts) -------

@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fft", [256, 1280, 2048])
def test_k1_aligned_matches_jax(fft, mode, prec):
    """Raw u8 planes through Kernel A's plain version in JAX's form (3M
    here; bit-identical to its decoded float32, and the dispatcher's u8
    to its decoded float32 too) against the JAX kernel on the decoded
    planes (its u8 input is bit-identical to them,
    tests/test_pallas.py:220-237)."""
    cfg = zs_cfg(fft, 0.5, mode, tpu_precision=prec)
    re, im = raw_planes(cfg, 2, seed=fft + MODES.index(mode))
    want = np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(decoded(re)), jnp.asarray(decoded(im)), cfg, t_tile=2))
    got = tc_in_jax_form(re, im, cfg)
    np.testing.assert_array_equal(
        got, port(cuda_tc.curscan_tc, decoded(re), decoded(im), cfg,
                  form="force3m"))
    np.testing.assert_array_equal(
        port(tspec.curscan_auto_batched, re, im, cfg),
        port(tspec.curscan_auto_batched, decoded(re), decoded(im), cfg))
    assert_class_close(got, want, prec, window_peak(decoded(re),
                                                    decoded(im), cfg))


# --- K3's cell on the 128 grid against the JAX lane kernel ------------------

@pytest.mark.parametrize("prec", CLASSES)
def test_k3_cell_matches_jax(prec):
    """fft 16384 kaiser 50% (factors 128 x 128), two blocks: the JAX
    dispatcher's lane kernel (3M) against the port's tensor-core route's
    plain version in that form."""
    cfg = zs_cfg(16384, 0.5, tpu_precision=prec)
    assert cuda_curscan.kernel_route(cfg) == "tc"
    re, im = gauss(cfg, 2, seed=16384)
    want = np.asarray(jpk.curscan_fused(jnp.asarray(re), jnp.asarray(im),
                                        cfg, t_tile=2))
    got = tc_in_jax_form(re, im, cfg)
    assert_class_close(got, want, prec, window_peak(re, im, cfg))


# --- K2 against the JAX packed kernel ----------------------------------------

K2_CASES = [(64, 0.1, WINDOW_ONES, "AVG"), (64, 0.1, WINDOW_ONES, "MIN"),
            (128, 0.5, WINDOW_KAISER, "AVG")]


@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("fft,nono,window,mode", K2_CASES)
def test_k2_matches_jax(fft, nono, window, mode, prec):
    """quickFullScan's geometry (fft 64, ones, 90%: 71 windows at 10 start
    residues) and fft 128 kaiser 50%, float32 and u8 planes."""
    cfg = zs_cfg(fft, nono, mode, window=window, tpu_precision=prec)
    assert cuda_tc.supports_packed_tc(cfg)
    re, im = raw_planes(cfg, 8, seed=fft)
    want = np.asarray(jpk.curscan_fused_packed(
        jnp.asarray(decoded(re)), jnp.asarray(decoded(im)), cfg))
    got = port(tspec.curscan_auto_batched, re, im, cfg)
    np.testing.assert_array_equal(
        got, port(tspec.curscan_auto_batched, decoded(re), decoded(im), cfg))
    assert_class_close(got, want, prec, window_peak(decoded(re),
                                                    decoded(im), cfg))


# --- the class bounds against the float64 oracle -----------------------------

ORACLE_K1 = [(fft, nono, u8) for fft in (256, 1280, 2048)
             for nono in (0.5, 0.1) for u8 in (False, True)]


@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("fft,nono,u8", ORACLE_K1)
def test_k1_plain_meets_the_class_bound(fft, nono, u8, prec):
    cfg = zs_cfg(fft, nono, tpu_precision=prec)
    re, im = raw_planes(cfg, 8, seed=7) if u8 else gauss(cfg, 8, seed=7)
    got = port(cuda_tc.curscan_tc_plain, re, im, cfg)
    f64 = (decoded(re), decoded(im)) if u8 else (re, im)
    assert oracle_error(got, *f64, cfg) <= ORACLE_BOUND[prec]


@pytest.mark.parametrize("case", [
    ("K3 cell fft 16384 kaiser 50% f32", 16384, 0.5, WINDOW_KAISER, False,
     "HIGH"),
    ("K3 cell fft 16384 kaiser 50% f32", 16384, 0.5, WINDOW_KAISER, False,
     "DEFAULT"),
    ("fmScan f32", 16384, 0.1, WINDOW_ONES, False, "DEFAULT"),
    ("fmScan u8", 16384, 0.1, WINDOW_ONES, True, "DEFAULT"),
    ("quickFullScan f32", 64, 0.1, WINDOW_ONES, False, "DEFAULT"),
    ("quickFullScan u8", 64, 0.1, WINDOW_ONES, True, "DEFAULT"),
    ("quickFullScan f32", 64, 0.1, WINDOW_ONES, False, "HIGH"),
    ("fft 128 kaiser 50% u8", 128, 0.5, WINDOW_KAISER, True, "HIGH")],
    ids=lambda c: f"{c[0]}-{c[5]}")
def test_presets_plain_meet_the_class_bound(case):
    """The fmScan and quickFullScan presets' geometry (fmScan's full_size
    131072, 71 misaligned windows; quickFullScan's 512, 71 windows) and
    K3's cell, through the dispatcher."""
    _, fft, nono, window, u8, prec = case
    cfg = zs_cfg(fft, nono, window=window, tpu_precision=prec)
    t = 2 if fft > 128 else 16
    re, im = raw_planes(cfg, t, seed=9) if u8 else gauss(cfg, t, seed=9)
    got = port(tspec.curscan_auto_batched, re, im, cfg)
    f64 = (decoded(re), decoded(im)) if u8 else (re, im)
    assert oracle_error(got, *f64, cfg) <= ORACLE_BOUND[prec]


# --- the 3M gate, u8 and HIGHEST ---------------------------------------------

# Where the JAX gate takes 3M (HIGH everywhere, DEFAULT but deep-overlap
# u8) and 4M, the port takes 4M (fault C3).
GATE_CASES = [
    (0.5, "DEFAULT", True, "no3m"),
    (0.5, "DEFAULT", False, "no3m"),
    (0.1, "DEFAULT", False, "no3m"),
    (0.1, "DEFAULT", True, "no3m"),
    (0.1, "HIGH", False, "no3m"),
    (0.1, "HIGH", True, "no3m"),
    (0.5, "HIGH", True, "no3m")]


@pytest.mark.parametrize("nono,prec,u8,expect", GATE_CASES)
def test_threemult_gate_per_path(nono, prec, u8, expect):
    """``tests/test_pallas.py::test_threemult_gate_per_path`` on the port:
    the dispatcher's output is bitwise the expected override's and not the
    other's (3M and 4M differ by rounding)."""
    cfg = zs_cfg(512, nono, tpu_precision=prec)
    re, im = raw_planes(cfg, 1, seed=13) if u8 else gauss(cfg, 1, seed=13)
    prod = port(tspec.curscan_auto_batched, re, im, cfg)
    np.testing.assert_array_equal(
        prod, port(cuda_tc.curscan_tc, re, im, cfg, form=expect))
    other = "no3m" if expect == "force3m" else "force3m"
    assert not np.array_equal(
        prod, port(cuda_tc.curscan_tc, re, im, cfg, form=other))
    assert cuda_tc.three_mult() == (expect == "force3m")


# Fault C3 (ROADMAP.md C, closed by taking 4M): cells where the JAX gate's
# 3M misses its class's bound and 4M meets it, at blocks that show it.
C3_CELLS = [(16384, 0.5, WINDOW_KAISER, 64, "DEFAULT"),
            (16384, 0.1, WINDOW_ONES, 16, "DEFAULT"),
            (8192, 0.1, WINDOW_ONES, 64, "DEFAULT"),
            (8192, 0.5, WINDOW_KAISER, 64, "HIGH"),
            (2048, 0.1, WINDOW_ONES, 64, "HIGH")]


def form_error(cfg, blocks, form=None):
    """threemult_smoke's measure on its float32 planes: Kernel A's plain
    version in ``form`` (the production form if None), 8 blocks a call."""
    re, im = threemult_smoke.planes(cfg, blocks, False, 7,
                                    torch.device("cpu"))
    got = torch.cat([cuda_tc.curscan_tc(re[i:i + 8], im[i:i + 8], cfg, form)
                     for i in range(0, blocks, 8)])
    return oracle_error(got.numpy().astype(np.float64), re.numpy(),
                        im.numpy(), cfg)


@pytest.mark.parametrize("fft,nono,window,blocks,prec", C3_CELLS)
def test_4m_meets_the_bound_where_3m_misses(fft, nono, window, blocks,
                                            prec):
    """The lane kernel's cell, fmScan's geometry, fft 8192 at 50% and 90%
    and fft 2048 at 90% on float32 noise: 3M misses the class bound, the
    dispatcher (4M) meets it."""
    cfg = threemult_smoke.job_cfg(fft, nono, prec, window)
    assert form_error(cfg, blocks, "force3m") > ORACLE_BOUND[prec]
    assert form_error(cfg, blocks) <= ORACLE_BOUND[prec]


def test_jax_high_3m_misses_its_bound_as_the_port_3m_does():
    """At fft 2048, ones, 90% overlap, 64 blocks, the JAX kernel at HIGH
    (3M by its gate) misses 5e-5 as the port's 3M does, within 5% of it:
    the miss is the form's, not the port's."""
    cfg = threemult_smoke.job_cfg(2048, 0.1, "HIGH", WINDOW_ONES)
    re, im = threemult_smoke.planes(cfg, 64, False, 7, torch.device("cpu"))
    want = np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(re.numpy()), jnp.asarray(im.numpy()), cfg, t_tile=8))
    theirs = oracle_error(want.astype(np.float64), re.numpy(), im.numpy(),
                          cfg)
    ours = form_error(cfg, 64, "force3m")
    assert min(ours, theirs) > ORACLE_BOUND["HIGH"]
    assert abs(ours - theirs) <= 0.05 * theirs


def test_high_deep_overlap_fault_c4_is_open():
    """Fault C4 (ROADMAP.md C, closed as a property of the bf16x3 class):
    at 90% overlap with the ones window and fft 16384 (fmScan's geometry),
    HIGH's worst bin passes 5e-5 in the 4M form too, as the JAX kernel's
    does (``tests/test_torch_precision_c4.py`` holds the port within 1.05
    of it).  A HIGH form beyond bf16x3 makes this test fail: then hold the
    cell to the bound in ``test_4m_meets_the_bound_where_3m_misses``."""
    cfg = threemult_smoke.job_cfg(16384, 0.1, "HIGH", WINDOW_ONES)
    assert form_error(cfg, 16) > ORACLE_BOUND["HIGH"]


@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("form", ["force3m", "no3m"])
def test_u8_bit_identical_in_the_same_form(form, prec):
    """At 90% overlap (misaligned starts, where the JAX gate parts u8 from
    float32 at DEFAULT) u8 equals decoded float32 bit for bit in either
    form."""
    cfg = zs_cfg(512, 0.1, "MIN", tpu_precision=prec)
    re, im = raw_planes(cfg, 1, seed=5)
    np.testing.assert_array_equal(
        port(cuda_tc.curscan_tc, re, im, cfg, form=form),
        port(cuda_tc.curscan_tc, decoded(re), decoded(im), cfg, form=form))


@pytest.mark.parametrize("fft,nono,window", [
    (2048, 0.5, WINDOW_KAISER), (16384, 0.1, WINDOW_ONES),
    (1280, 0.1, WINDOW_KAISER), (64, 0.1, WINDOW_ONES),
    (128, 0.5, WINDOW_KAISER)])
def test_highest_is_unchanged(fft, nono, window):
    """HIGHEST runs what it ran before the classes: the dispatcher's CPU
    path is the float32 ``torch.fft`` chain bit for bit, ``no3m`` changes
    nothing and ``force3m`` raises, since the float64 FFT kernel has no
    complex-matmul form."""
    cfg = zs_cfg(fft, nono, window=window)
    assert cfg.tpu_precision == "HIGHEST"
    re, im = raw_planes(cfg, 2, seed=fft)
    chain = tspec.curscan_batched(*(torch.from_numpy(decoded(p))
                                    for p in (re, im)), cfg).numpy()
    np.testing.assert_array_equal(
        port(tspec.curscan_auto_batched, re, im, cfg), chain)
    if fft > 128:
        assert cuda_curscan.kernel_route(cfg) == "fft"
        np.testing.assert_array_equal(
            port(cuda_curscan.curscan_fused_sublane, re, im, cfg,
                 ablate=("no3m",)), chain)
        with pytest.raises(ValueError, match="force3m"):
            port(cuda_curscan.curscan_fused_sublane, re, im, cfg,
                 ablate=("force3m",))


def test_forms_outside_the_tensor_core_kernel():
    """The FFT kernel's wrapper, given a HIGH/DEFAULT config directly (K3
    off the grid, which the dispatcher sends to Kernel C, where both forms
    exist), and the stage ablation take ``no3m`` as their own form and
    refuse ``force3m``.  With a stage key at HIGH the ablation runs Kernel
    A's ablate form, which takes ``force3m`` as JAX's kernel does: the
    result holds to JAX's within the class's tolerance."""
    off_grid = zs_cfg(3000, 0.5, tpu_precision="DEFAULT")
    assert cuda_curscan.kernel_route(off_grid) == "tc_split"
    z = torch.zeros((1, off_grid.full_size))
    with pytest.raises(ValueError, match="force3m"):
        cuda_curscan.curscan_fused_sublane(z, z, off_grid,
                                           ablate=("force3m",))
    np.testing.assert_array_equal(
        cuda_curscan.curscan_fused_sublane(z, z, off_grid,
                                           ablate=("no3m",)).numpy(),
        cuda_curscan.curscan_fused_sublane(z, z, off_grid).numpy())
    for form in ("force3m", "no3m"):
        assert cuda_tc.curscan_tc_split(z, z, off_grid, form).shape == (
            1, 3000)
    cfg = zs_cfg(512, tpu_precision="HIGH")
    rng = np.random.default_rng(512)
    re, im = (rng.standard_normal((2, cfg.full_size)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(re), jnp.asarray(im), cfg, ablate=("win", "force3m")))
    got = cuda_curscan.curscan_fused_sublane(
        torch.from_numpy(re), torch.from_numpy(im), cfg,
        ablate=("win", "force3m"))
    assert_tc_close(got.numpy(), want, "HIGH")
    z = torch.zeros((1, cfg.full_size))
    with pytest.raises(ValueError, match="unknown complex form"):
        cuda_tc.curscan_tc(z, z, cfg, form="3m")


# --- the route sets ----------------------------------------------------------

def test_route_sets():
    """At HIGH and DEFAULT Kernel A takes exactly the sublane predicate up to
    fft 16384 (every multiple of 128 from 256) and Kernel B exactly K2's;
    Kernel C the rest of what JAX sends to a Pallas kernel; at HIGHEST
    nothing changes: the FFT kernel takes it all."""
    jcfg = pytest.importorskip("kspecanal_tpu.config")
    for fft in list(range(128, 20000, 128)) + [2500, 3000, 10000, 16256,
                                               16500, 20480, 32768]:
        for nono in (0.5, 0.1):
            for prec in ("HIGHEST",) + CLASSES:
                cfg = zs_cfg(fft, nono, tpu_precision=prec,
                             x_res=min(512, fft))
                jc = jcfg.SpecConfig(**dataclasses.asdict(cfg))
                pallas = jspec._fused_choice(jc) is not None
                sub = jpk.supports_fused_sublane(jc)
                want = (None if not pallas else
                        "fft" if prec == "HIGHEST" else
                        "tc" if sub and fft <= 16384 else "tc_split")
                assert cuda_curscan.kernel_route(cfg) == want, (fft, nono,
                                                                prec)
    for fft in (2, 4, 8, 16, 32, 64, 128, 48, 96, 200, 256):
        for prec in ("HIGHEST",) + CLASSES:
            cfg = zs_cfg(fft, 0.5, tpu_precision=prec, x_res=min(512, fft))
            assert cuda_tc.supports_packed_tc(cfg) == (
                prec != "HIGHEST" and cuda_packed.supports_fused_packed(cfg))


def test_dispatcher_takes_the_class_route(monkeypatch):
    """``curscan_auto_batched`` hands HIGH/DEFAULT configs to the
    tensor-core wrappers (K3 off the grid to Kernel C's) and HIGHEST ones to
    the FFT kernels' plain versions."""
    calls = []
    for name in ("curscan_tc_plain", "curscan_packed_tc_plain",
                 "curscan_tc_split_plain"):
        real = getattr(cuda_tc, name)
        monkeypatch.setattr(cuda_tc, name, lambda *a, _r=real, _n=name,
                            **k: calls.append(_n) or _r(*a, **k))
    for fft, prec, want in ((2048, "DEFAULT", "curscan_tc_plain"),
                            (16384, "HIGH", "curscan_tc_plain"),
                            (64, "DEFAULT", "curscan_packed_tc_plain"),
                            (2048, "HIGHEST", None),
                            (3000, "DEFAULT", "curscan_tc_split_plain"),
                            (64, "HIGHEST", None)):
        calls.clear()
        cfg = zs_cfg(fft, 0.5, tpu_precision=prec, x_res=min(512, fft))
        z = torch.zeros((1, cfg.full_size))
        tspec.curscan_auto_batched(z, z, cfg)
        assert calls == ([want] if want else []), (fft, prec)


# --- the plain matrix products follow the class ------------------------------

@pytest.mark.parametrize("prec", ("HIGHEST",) + CLASSES)
def test_class_matmul_matches_jax_dots(prec):
    """``mxu_fft.class_matmul`` against the JAX package's dot at the class:
    HIGH against ``_make_dot('HIGH')`` (the same split), DEFAULT against a
    dot of the operands cast to bf16 with float32 sums (the TPU's DEFAULT
    pass), HIGHEST against the float32 dot; only float32 sum order
    differs."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((24, 40)).astype(np.float32)
    b = rng.standard_normal((40, 16)).astype(np.float32)
    got = mxu_fft.class_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               prec).numpy()
    if prec == "DEFAULT":
        want = jnp.dot(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16),
                       preferred_element_type=jnp.float32)
    else:
        want = jpk._make_dot(prec)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    if prec == "HIGHEST":
        np.testing.assert_array_equal(
            got, (torch.from_numpy(a) @ torch.from_numpy(b)).numpy())


@pytest.mark.parametrize("prec", ("HIGHEST",) + CLASSES)
@pytest.mark.parametrize("fft", [48, 200])
def test_direct_dft_matches_jax_at_the_class(fft, prec):
    """``spectrum.curscan_direct_batched`` (the card's route for small ffts
    no kernel takes) against the JAX package's at the class."""
    cfg = zs_cfg(fft, 0.5, tpu_precision=prec, x_res=min(512, fft))
    re, im = gauss(cfg, 3, seed=fft)
    want = np.asarray(jspec.curscan_direct_batched(jnp.asarray(re),
                                                   jnp.asarray(im), cfg))
    got = port(tspec.curscan_direct_batched, re, im, cfg)
    if prec == "HIGHEST":
        np.testing.assert_allclose(got, want, rtol=5e-5,
                                   atol=1e-6 * np.abs(want).max())
    else:
        assert_class_close(got, want, prec, window_peak(re, im, cfg))


class _FakeLib:
    """A stand-in for the kernels' library: records each launch's entry
    point and arguments and reports success; Kernel A's and Kernel B's
    occupancy queries answer one block an SM and are not launches."""

    def __init__(self):
        self.calls = []
        for name in ("kspec_curscan_tc", "kspec_curscan_packed_tc",
                     "kspec_curscan_fft", "kspec_curscan_packed"):
            setattr(self, name, self._entry(name))

    @staticmethod
    def kspec_curscan_tc_occupancy(*args):
        return 1

    @staticmethod
    def kspec_curscan_packed_tc_occupancy(*args):
        return 1

    def _entry(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        fn.__name__ = name
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """'meta' tensors routed as the card's up to the launch, which a
    :class:`_FakeLib` records (as in tests/test_torch_curscan.py)."""
    lib = _FakeLib()
    for mod in (cuda_curscan, cuda_tc):
        monkeypatch.setattr(mod, "_cuda_lib", lambda dev: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev=None: types.SimpleNamespace(multi_processor_count=132))
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_card_dispatch_launches_the_class_kernels(fake_card, dtype):
    """On the card, HIGH/DEFAULT configs launch Kernel A (counted in
    ``tc_launches``) with the class, the gate's form and the window groups,
    and K2's configs Kernel B (``packed_tc_launches``) with its plan (one
    span of 71 windows, a staging row of 512 samples) and its persistent
    grid (the SMs times the library's blocks an SM); the FFT kernels'
    counters do not move."""
    u8 = dtype == torch.uint8
    for fft, nono, prec, t in ((2048, 0.5, "DEFAULT", 4096),
                               (2048, 0.1, "DEFAULT", 64),
                               (16384, 0.1, "HIGH", 288),
                               (256, 0.5, "HIGH", 8)):
        cfg = zs_cfg(fft, nono, tpu_precision=prec, x_res=512)
        planes = torch.empty((t, cfg.full_size), device="meta", dtype=dtype)
        fake_card.calls.clear()
        before = (cuda_tc.tc_launches, cuda_curscan.launches)
        out = tspec.curscan_auto_batched(planes, planes, cfg)
        assert out.shape == (t, fft)
        [(name, args)] = fake_card.calls
        assert name == "kspec_curscan_tc"
        groups = cuda_tc.tc_groups(t, fft // 128, cfg.num_windows, 132, 1)
        assert args[11:21] == (t, cfg.full_size, fft, fft // 128,
                               cfg.num_windows, groups,
                               cuda_curscan._FOLD["AVG"],
                               cuda_tc.tc_windows_per_pass(
                                   fft // 128, cfg.num_windows),
                               int(prec == "HIGH"),
                               0)
        assert (cuda_tc.tc_launches, cuda_curscan.launches) == (
            before[0] + 1, before[1])
    cfg = zs_cfg(64, 0.1, window=WINDOW_ONES, tpu_precision="DEFAULT")
    planes = torch.empty((1226, cfg.full_size), device="meta", dtype=dtype)
    fake_card.calls.clear()
    before = (cuda_tc.packed_tc_launches, cuda_packed.launches)
    tspec.curscan_auto_batched(planes, planes, cfg)
    [(name, args)] = fake_card.calls
    assert name == "kspec_curscan_packed_tc"
    assert args[7:16] == (1226, 512, 64, 71, cuda_curscan._FOLD["AVG"], 0,
                          71, 512, 132)
    assert (cuda_tc.packed_tc_launches, cuda_packed.launches) == (
        before[0] + 1, before[1])


@pytest.mark.parametrize("groups", [None, 1, 3])
def test_launch_tc_takes_the_groups(fake_card, groups):
    """``cuda_tc.launch_tc`` launches the groups it is given (as
    ``scripts/tc_stages.py`` gives every cut-off build the port's library's
    groups), else those of ``tc_groups`` at the library's occupancy; it
    counts nothing."""
    cfg = zs_cfg(2048, 0.1, tpu_precision="DEFAULT", x_res=512)
    planes = torch.empty((64, cfg.full_size), device="meta")
    before = cuda_tc.tc_launches
    out = cuda_tc.launch_tc(fake_card, planes, planes, cfg, False, groups)
    assert out.shape == (64, 2048)
    [(name, args)] = fake_card.calls
    want = groups or cuda_tc.tc_groups(64, 16, cfg.num_windows, 132, 1)
    assert name == "kspec_curscan_tc" and args[16] == want
    assert cuda_tc.tc_launches == before


def test_stage_variant_builds_kernel_a_with_its_cut_off(tmp_path,
                                                        monkeypatch):
    """``_build.load_variant`` (``scripts/tc_stages.py``'s cut-offs) with a
    stand-in nvcc that logs its arguments: Kernel A's two sources, each
    compiled with the ``-D`` flag, linked into a variant library of its own
    name beside the port's, which it leaves alone."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
                    "  shift\n"
                    "done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(path=path))
    from kspecanal_tpu_torch.scripts import tc_stages
    lib = _build.load_variant(tc_stages.SOURCES, ("KSPEC_TC_STOP=2",))
    calls = log.read_text().splitlines()
    compiles = [c.split() for c in calls if " -c " in c]
    assert sorted(Path(c[-1]).name for c in compiles) == [
        "curscan_tc.cu", "curscan_tc_high.cu"]
    assert all("-DKSPEC_TC_STOP=2" in c for c in compiles)
    assert calls[-1].startswith("-shared")
    assert Path(lib.path).name.startswith("libkspec_variant_")
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        Path(lib.path).name]
    assert Path(lib.path).name != _build.library_path().name


def test_stage_variant_builds_kernel_b_with_its_cut_off(tmp_path,
                                                        monkeypatch):
    """``scripts/packed_tc_stages.py``'s cut-offs: Kernel B's one source
    compiled with ``-DKSPEC_PTC_STOP=1`` by a stand-in nvcc into a variant
    library of its own, the port's library left alone."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
                    "  shift\n"
                    "done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(path=path))
    from kspecanal_tpu_torch.scripts import packed_tc_stages
    lib = _build.load_variant(packed_tc_stages.SOURCES,
                              ("KSPEC_PTC_STOP=1",))
    compiles = [c.split() for c in log.read_text().splitlines()
                if " -c " in c]
    assert [Path(c[-1]).name for c in compiles] == ["curscan_packed_tc.cu"]
    assert "-DKSPEC_PTC_STOP=1" in compiles[0]
    assert Path(lib.path).name.startswith("libkspec_variant_")
    assert Path(lib.path).name != _build.library_path().name


def test_window_groups_and_chunks():
    """Kernel A's groups at the blocks an SM holds: the count that fills
    the card's waves best (one a block at the zero-span main cell's two
    blocks an SM, five at fmScan's 288 blocks of fft 16384 at one, where
    one group leaves a third wave of 24 blocks), more for short batches,
    never more than the windows; its windows a pass: at most 64 stacked
    rows; Kernel B's chunk (windows a staged span): all of quickFullScan's
    71, the 951-window block in spans of 304, u8 as float32.
    (Kernel A's shared memory is the library's, held on the card by
    ``test_torch_gpu.py::test_tc_shared_memory_and_occupancy``.)"""
    assert cuda_tc.tc_groups(4096, 16, 15, 132, 2) == 1
    assert cuda_tc.tc_groups(288, 128, 71, 132, 1) == 5
    assert cuda_tc.tc_groups(1, 16, 15, 132, 2) == 15
    assert cuda_tc.tc_groups(16, 128, 71, 132, 1) == 8
    # Fewer blocks an SM, fewer groups for the same waves.
    assert cuda_tc.tc_groups(64, 16, 15, 132, 2) == 4
    assert cuda_tc.tc_groups(64, 16, 15, 132, 1) == 2
    assert cuda_tc.tc_groups(4096, 16, 15, 132, 1) == 1
    for t in (1, 7, 64, 288, 4096):
        for w in (1, 3, 15, 71):
            for per_sm in (1, 2, 5):
                assert 1 <= cuda_tc.tc_groups(t, 16, w, 132, per_sm) <= w
    for mult, chunk in ((8, 71), (96, 304)):
        starts = zs_cfg(64, 0.1, x_res=64,
                        fft2full_mult4less=mult).window_starts
        assert {cuda_tc.packed_tc_plan(64, starts, u8, False).chunk
                for u8 in (False, True)} == {chunk}
    assert [cuda_tc.tc_windows_per_pass(n1, 15) for n1 in (2, 16, 17, 32,
                                                           64, 128)] == [
        4, 4, 2, 2, 1, 1]
    assert cuda_tc.tc_windows_per_pass(16, 3) == 3


def test_threemult_smoke_on_the_cpu(capsys):
    """The port of scripts/threemult_smoke.py, errors only (two blocks,
    the plain versions): its eight jobs, their routes and each class within
    its bound (HIGHEST, the float64 FFT kernel's class, within HIGH's)."""
    rows = threemult_smoke.main(["--device", "cpu", "--blocks", "2"])
    assert list(rows) == [j.name for j in threemult_smoke.JOBS]
    for job in threemult_smoke.JOBS:
        row = rows[job.name]
        assert row["route"] == ("FFT kernel (float64)"
                                if job.precision == "HIGHEST" else
                                "tensor-core 4M")
        assert row["max_rel_err"] <= ORACLE_BOUND.get(job.precision, 5e-5)
        assert "ms_lo" not in row
    assert "no device time" in capsys.readouterr().out


def _ldmatrix_x4(planes, lanes, trans):
    """NumPy model of ``ldmatrix.sync.aligned.m8n8.x4[.trans].b16``:
    ``planes`` (plane, row, column) values, ``lanes`` the (plane, row,
    column) each lane points at (8 values from there); returns
    ``[lane][register][2]``.  Matrix m is rows of lanes 8m..8m+7; lane i
    gets row i // 4, columns 2 (i % 4).. of each (``trans``: rows 2 (i %
    4).., column i // 4)."""
    plane, row, col = lanes
    mats = np.stack([planes[plane[l], row[l], col[l]:col[l] + 8]
                     for l in range(32)]).reshape(4, 8, 8)
    i = np.arange(32)[:, None]
    pair = 2 * (i % 4) + np.arange(2)
    if trans:
        return np.stack([mats[m][pair, i // 4] for m in range(4)], axis=1)
    return np.stack([mats[m][i // 4, pair] for m in range(4)], axis=1)


@pytest.mark.parametrize("stage", ["stage1_frames", "stage2_c",
                                   "tables"])
def test_kernel_a_fragments_rebuild_the_product(stage):
    """Kernel A's fragments, placed back by the m16n8k16 index maps
    (``_frag_a_index`` / ``_frag_b_index``), rebuild the operand tiles, so
    the tensor-core products are the NumPy products: stage 1's B fragments
    loaded by ``ldmatrix.x4.trans`` from two planes (a 16 x 8 strip of the
    frame's rows), stage 2's A fragments by ``ldmatrix.x4`` (a 16 x 16 tile
    of C), and the wrapper's F1 and F2^T tables (``frag_a``, ``frag_b``)."""
    rng = np.random.default_rng(7)
    ar, ac = cuda_tc._frag_a_index()
    br, bc = cuda_tc._frag_b_index()
    if stage == "tables":
        n = 2048
        n1 = n // 128
        f1r, f1i, f2r, f2i = mxu_fft._dft_tables_for(n, n1, 128)[:4]
        f1 = cuda_tc.frag_a((f1r, f1i), 1, 1)       # [slot][mt][kc][l][8]
        f2 = cuda_tc.frag_b((f2r.T,), 8, 16)         # [slot][kc][nt][l][4]
        hi = cuda_tc.bf16_halves(f1r)[0]
        got = np.zeros((16, 16), np.uint16)
        got[ar, ac] = f1[0, 0, 0]
        assert np.array_equal(got[:n1, :n1], hi)
        assert not got[n1:].any() and not got[:, n1:].any()
        t = np.zeros((128, 128), np.uint16)
        for kc in range(8):
            for nt in range(16):
                t[kc * 16 + br, nt * 8 + bc] = f2[0, kc, nt]
        assert np.array_equal(t, cuda_tc.bf16_halves(f2r.T)[0])
        lo = np.zeros((16, 16), np.uint16)
        lo[ar, ac] = f1[3, 0, 0]                      # F1i, lo
        assert np.array_equal(lo[:n1, :n1], cuda_tc.bf16_halves(f1i)[1])
        return
    if stage == "stage1_frames":
        # Two planes of 48 rows x 136; the strip at rows 16.., columns 24..
        planes = rng.standard_normal((2, 48, 136))
        frags = _ldmatrix_x4(planes, tuple(
            np.asarray(v) + o for v, o in zip(
                cuda_tc.ldmatrix_lanes(True), (0, 16, 24))), trans=True)
        for q in range(2):
            tile = planes[q, 16:32, 24:32]               # k x n
            got = np.zeros((16, 8))
            got[br, bc] = frags[:, 2 * q:2 * q + 2].reshape(32, 4)
            assert np.array_equal(got, tile)
            a = rng.standard_normal((16, 16))
            np.testing.assert_allclose(a @ got, a @ tile, rtol=0, atol=0)
        return
    planes = rng.standard_normal((1, 64, 136))
    frags = _ldmatrix_x4(planes, tuple(
        np.asarray(v) + o for v, o in zip(cuda_tc.ldmatrix_lanes(False),
                                          (0, 32, 48))), trans=False)
    got = np.zeros((16, 16))
    got[ar, ac] = frags.reshape(32, 8)
    tile = planes[0, 32:48, 48:64]
    assert np.array_equal(got, tile)
    b = rng.standard_normal((16, 8))
    np.testing.assert_allclose(got @ b, tile @ b, rtol=0, atol=0)
