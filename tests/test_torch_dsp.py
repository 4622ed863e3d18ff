"""Port parity: every ``kspecanal_tpu_torch.ops.dsp`` function against its
JAX original on the same numpy inputs (CPU).

Tolerances: extrema, selections and copies are exact; arithmetic (means,
weighted sums, logs, convolution) agrees to float32 rounding, within 1e-6
relative, because the two libraries sum in different orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.config import cumu_weights
from kspecanal_tpu.ops import dsp as jdsp
from kspecanal_tpu_torch.ops import dsp as tdsp

RTOL = 1e-6


def _pair(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(got, want, exact=False):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.fixture
def spec(rng):
    """A positive spectrum with an exact zero (log -> -inf)."""
    v = rng.gamma(2.0, 1e-3, 2048).astype(np.float32)
    v[7] = 0.0
    return v


def test_hist_low_clip_and_clip2minamp(spec):
    j, t = _pair(spec)
    _close(tdsp.hist_low_clip(t), jdsp.hist_low_clip(j), exact=True)
    _close(tdsp.clip2minamp(t, 1e-4), jdsp.clip2minamp(j, 1e-4), exact=True)


def test_hist_low_clip_reduces_per_row(rng):
    """A batch of rows clips each row at its own edge: the port's batched
    call equals the JAX function vmapped over rows."""
    rows = rng.gamma(2.0, 1.0, (5, 256)).astype(np.float32)
    rows *= np.float32(10.0) ** np.arange(5, dtype=np.float32)[:, None]
    j, t = _pair(rows)
    _close(tdsp.hist_low_clip(t), jax.vmap(jdsp.hist_low_clip)(j), exact=True)


@pytest.mark.parametrize("inf_to", [None, -300.0])
def test_log_transforms(spec, inf_to):
    j, t = _pair(spec)
    _close(tdsp.log_db(t, inf_to), jdsp.log_db(j, inf_to))
    _close(tdsp.log_no_gain(t, 19.1, inf_to), jdsp.log_no_gain(j, 19.1, inf_to))


@pytest.mark.parametrize("n", [2048, 100])
def test_conv_smooth(rng, n):
    j, t = _pair(rng.standard_normal(n) - 60.0)
    _close(tdsp.conv_smooth(t), jdsp.conv_smooth(j))


@pytest.mark.parametrize("proc", ["HistLowClip", "Clip2MinAmp", "Log",
                                  "LogNoGain", "Conv"])
def test_data_proc(spec, proc):
    j, t = _pair(spec)
    kw = dict(gain=19.1, min_amp=1e-4, inf_to=-200.0)
    _close(tdsp.data_proc(t, proc, **kw), jdsp.data_proc(j, proc, **kw))


@pytest.mark.parametrize("chain", ["LogNoGain", "Raw", "LogNoGain.HistLowClip",
                                   "HistLowClip.LogNoGain"])
def test_fftvals_dispproc(spec, chain):
    j, t = _pair(spec + 1e-6)
    _close(tdsp.fftvals_dispproc(t, chain, gain=19.1),
           jdsp.fftvals_dispproc(j, chain, gain=19.1))


def test_unknown_names_raise(spec):
    t = torch.from_numpy(spec)
    for call in (lambda: tdsp.data_proc(t, "Nope"),
                 lambda: tdsp.fftvals_dispproc(t, "Log", gain=0.0),
                 lambda: tdsp.cumulate("NOPE", t, t),
                 lambda: tdsp.reduce_windows("NOPE", t[None], None),
                 lambda: tdsp.compress_1d(t, "NOPE", 512)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("mode", ["AVG", "MAX", "MIN", "RAW"])
def test_cumulate(rng, mode):
    a, b = rng.standard_normal((2, 512))
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    _close(tdsp.cumulate(mode, ta, tb), jdsp.cumulate(mode, ja, jb),
           exact=True)
    _close(tdsp.cumulate(mode, None, tb), jdsp.cumulate(mode, None, jb),
           exact=True)


@pytest.mark.parametrize("mode", ["AVG", "MAX", "MIN", "RAW"])
def test_reduce_windows(rng, mode):
    mags = rng.gamma(2.0, 1.0, (15, 2048))
    j, t = _pair(mags)
    w = cumu_weights(mode, 15)
    _close(tdsp.reduce_windows(mode, t, w), jdsp.reduce_windows(mode, j, w),
           exact=mode != "AVG")
    # the port also reduces a leading batch axis: (T, W, n) -> (T, n)
    batch = tdsp.reduce_windows(mode, torch.stack([t, 2 * t]), w)
    _close(batch[1], jdsp.reduce_windows(mode, 2 * j, w), exact=mode != "AVG")


@pytest.mark.parametrize("mode,x_res", [("MAX", 512), ("MIN", 512),
                                        ("AVG", 512), ("RAW", 512),
                                        ("CONV", 512), ("AVG", 4096),
                                        ("MAX", 300)])
def test_compress(rng, mode, x_res):
    x = np.linspace(90.8e6, 93.2e6, 2048)
    y = rng.standard_normal(2048) - 50.0
    rows = rng.standard_normal((4, 2048)) - 50.0
    (jx, tx), (jy, ty), (jr, tr) = _pair(x), _pair(y), _pair(rows)
    exact = mode in ("MAX", "MIN", "RAW")
    _close(tdsp.compress_1d(ty, mode, x_res), jdsp.compress_1d(jy, mode, x_res),
           exact=exact)
    gx, gy = tdsp.compress_xy(tx, ty, mode, x_res)
    wx, wy = jdsp.compress_xy(jx, jy, mode, x_res)
    _close(gx, wx, exact=mode in ("RAW", "CONV") or 2048 // x_res == 0)
    _close(gy, wy, exact=exact)
    _close(tdsp.compress_2d(tr, mode, x_res), jdsp.compress_2d(jr, mode, x_res),
           exact=exact)


@pytest.mark.parametrize("mode", ["MAX", "MIN", "AVG", "RAW", "CONV"])
def test_heatmap_width(mode):
    for fft, x_res in ((2048, 512), (256, 512), (64, 64)):
        assert (tdsp.heatmap_width(fft, x_res, mode)
                == jdsp.heatmap_width(fft, x_res, mode))


@pytest.mark.parametrize("k", [0, 1, 16])
def test_skip_edge_bins(rng, k):
    j, t = _pair(rng.standard_normal((3, 256)) - 40.0)
    _close(tdsp.skip_edge_bins(t, k), jdsp.skip_edge_bins(j, k), exact=True)
    _close(tdsp.skip_edge_bins(t[0], k), jdsp.skip_edge_bins(j[0], k),
           exact=True)


@pytest.mark.parametrize("mode", ["RAW", "AVG", "MAX", "MIN"])
def test_cumulate_range(rng, mode):
    """A slice of ``new`` cumulated into a slice of ``cur``; the rest of
    ``cur`` is kept and the input is not changed.  (a+b)/2 rounds once in
    both libraries, so every mode is exact."""
    cur = rng.standard_normal(300).astype(np.float32)
    new = rng.standard_normal(128).astype(np.float32)
    jc, tc = _pair(cur)
    jn, tn = _pair(new)
    want = jdsp.cumulate_range(mode, jc, 100, 164, jn, 32, 96)
    _close(tdsp.cumulate_range(mode, tc, 100, 164, tn, 32, 96), want,
           exact=True)
    np.testing.assert_array_equal(tc.numpy(), cur)
    with pytest.raises(ValueError):
        tdsp.cumulate_range("SUM", tc, 0, 4, tn, 0, 4)
