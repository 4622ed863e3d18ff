"""Shared helpers of the port's parity tests (``test_torch_*.py``): configs,
seeded numpy inputs, cached JAX references and the tolerance checks.

The configs and the synth source are the port's (``kspecanal_tpu_torch``'s
copies, held to the JAX package's by test_torch_standalone.py), and JAX is
imported only inside :func:`jax_refs`, so the card's tests
(test_torch_gpu.py) run where neither JAX nor the JAX package is
installed."""
import functools

import numpy as np
import pytest
import torch

from kspecanal_tpu_torch.config import SpecConfig, WINDOW_KAISER
from kspecanal_tpu_torch.io.sources import SynthIQSource
from kspecanal_tpu_torch.ops import cuda_curscan

MODES = ("AVG", "MAX", "MIN", "RAW")


def zs_cfg(fft=2048, nono=0.5, mode="AVG", window=WINDOW_KAISER, **kw):
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
                      window=window, cur_scan_non_overlap=nono,
                      cur_scan_cumu_mode=mode, **kw).finalize()


def raw_planes(cfg, t, seed):
    """(re, im) raw u8 planes of white noise, ``(t, full_size)``."""
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (t, cfg.full_size), dtype=np.uint8)
                 for _ in range(2))


def blocks(cfg, k, seed):
    """k blocks of synth tones (integer MHz) plus white noise, float32."""
    src = SynthIQSource(cfg.center_freq, cfg.sampling_rate, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        re, im = src.read(cfg.full_size)
        out.append((re + rng.standard_normal(cfg.full_size).astype(np.float32),
                    im + rng.standard_normal(cfg.full_size).astype(np.float32)))
    return (np.stack([b[0] for b in out]), np.stack([b[1] for b in out]))


def write_capture(path, cfg, n_samples, seed):
    """An rtl_sdr capture (octave/load_rtlsdr.m: u8, value-127 offset, I
    then Q) of tones at every integer MHz in the band plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / cfg.sampling_rate
    lo, hi = cfg.start_end_freq
    x = rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples)
    for f in np.arange(np.ceil(lo / 1e6), np.floor(hi / 1e6) + 1) * 1e6:
        x += 30 * np.exp(2j * np.pi * (f - cfg.center_freq) * t
                         + 1j * rng.uniform(0, 2 * np.pi))
    raw = np.empty(2 * n_samples, np.uint8)
    for j, part in enumerate((x.real, x.imag)):
        raw[j::2] = np.clip(np.round(part + 127), 0, 255)
    raw.tofile(path)


def decoded(p):
    return p.astype(np.float32) - np.float32(127.0)


@functools.lru_cache(maxsize=None)
def jax_refs(fft, nono, mode):
    """Raw u8 planes of white noise ``(2, full_size)`` and the JAX results on
    them decoded to float32: the Pallas kernel (interpret mode) and the XLA
    chain.  The JAX kernel's u8 input is bit-identical to decoded float32
    (tests/test_pallas.py:220-237), so one build serves both dtypes."""
    import jax.numpy as jnp
    from kspecanal_tpu.ops import pallas_curscan as jpk
    from kspecanal_tpu.ops import spectrum as jspec
    cfg = zs_cfg(fft, nono, mode)
    re, im = raw_planes(cfg, 2, fft * 100 + int(nono * 10) * 10
                        + MODES.index(mode))
    fre, fim = jnp.asarray(decoded(re)), jnp.asarray(decoded(im))
    kern = np.asarray(jpk.curscan_fused_sublane(fre, fim, cfg, t_tile=2))
    chain = np.asarray(jspec.curscan_batched(fre, fim, cfg))
    return re, im, kern, chain


def assert_spectra_close(got, want):
    """Linear spectra: max-rel (max abs error over the peak) < 1e-5, and per
    bin rtol 5e-5 (the HIGHEST-class bound of tests/test_pallas.py:145)
    plus atol 1e-6 of the peak.  The atol term is the float32 FFT's own
    absolute rounding, set by the frame's energy and not by the bin: a MIN
    fold over many windows keeps bins near 0.5% of the peak, where even the
    JAX kernel and the JAX chain differ by 2e-4 relative."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / peak < 1e-5
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6 * peak)


# The tensor-core kernels against their plain versions (ops/cuda_tc.py),
# per bin: (rtol, atol of the peak) by class.  Only the order of the
# float32 sums inside each product differs, but at DEFAULT that can move a
# stage-1 value across a bf16 rounding boundary, one bf16 step of an
# operand: a quarter of the class bound (3.9e-2) of the bin, plus a floor
# of the peak for the near-zero bins of MIN and RAW folds.  HIGH: the class
# bound 5e-5 of the bin and of the peak.  HIGHEST (the forensic builds' six
# passes): the HIGHEST per-bin bound of assert_spectra_close, 5e-5 of the
# bin plus 1e-6 of the peak, no looser: the products of the three bf16
# parts are exact in float32 and their dropped terms are below float32's
# rounding, so only the order of float32 sums differs, as in the float32
# chain that bound was set for.
TC_TOL = {"DEFAULT": (1e-2, 1e-2), "HIGH": (5e-5, 5e-5),
          "HIGHEST": (5e-5, 1e-6)}


def assert_tc_close(got, want, prec):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    rtol, atol = TC_TOL[prec]
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.max(np.abs(want)))


def assert_db_close(got, want, span_db=100.0, tol_db=1e-3, peak=None):
    """dB curves: within ``tol_db`` wherever the reference is within
    ``span_db`` of its peak, or of ``peak`` where given (bins at the float32
    noise floor differ in rounding only)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    mask = want >= (np.max(want) if peak is None else peak) - span_db
    assert mask.any()
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=tol_db)


def check_grid_case(fft, nono, mode, u8):
    """The port's kernel wrapper on CPU tensors (its plain version) against
    the JAX Pallas kernel and the JAX chain."""
    re, im, kern, chain = jax_refs(fft, nono, mode)
    if not u8:
        re, im = decoded(re), decoded(im)
    got = cuda_curscan.curscan_fused_sublane(
        torch.from_numpy(re), torch.from_numpy(im), zs_cfg(fft, nono, mode))
    assert got.dtype == torch.float32
    assert_spectra_close(got.numpy(), kern)
    assert_spectra_close(got.numpy(), chain)


@pytest.fixture(autouse=True)
def restore_jax_iter_logging():
    """A test module that imports this fixture runs the JAX CLI, whose
    ``tpuLogIter`` sets a process-wide flag of the JAX package
    (``utils.logging.set_iter_logging``); it is put back after each test,
    so later test files on the same worker see the default."""
    from kspecanal_tpu.utils import logging as jlog
    before = jlog._iter_logging
    yield
    jlog.set_iter_logging(before)


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
