"""The port's on-device sources (``kspecanal_tpu_torch/io/sources.py``) on
``device="cpu"`` against ``kspecanal_tpu.io.sources``, and a zero-span
catch-up session fed device batches, against the JAX session.

The two packages draw different random numbers, so the synthesis is
compared as a function of the per-block start times: the test draws them
with ``jax.random.bits`` on the split keys, as ``_build_device_synth`` does,
and hands them to ``synth_batch``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu import session as jsess
from kspecanal_tpu.io import sources as jsrc
from kspecanal_tpu_torch import session as tsess
from kspecanal_tpu_torch.io import sources as tsrc
from kspecanal_tpu_torch.models.convert import state_to_numpy
from torch_parity import raw_planes, zs_cfg

EDGE_PHASES = [0, 1 << 29, (1 << 29) - 1, 1 << 30, (1 << 30) + 1, 1 << 31,
               3 << 29, 3 << 30, 7 << 29, 2 ** 32 - 1, 2 ** 31 - 1]


def test_sincos_matches_jax_on_edge_and_random_phases():
    rng = np.random.default_rng(30)
    phase = np.concatenate([np.asarray(EDGE_PHASES, np.uint32),
                            rng.integers(0, 2 ** 32, 4096,
                                         dtype=np.uint64).astype(np.uint32)])
    want = jsrc._sincos_from_phase_u32(jnp.asarray(phase))
    got = tsrc.sincos_from_phase_u32(torch.from_numpy(phase.astype(np.int64)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-7)
    # the polynomials' own error against the true sin/cos
    ang = 2 * np.pi * phase / 2.0 ** 32
    np.testing.assert_allclose(got[0].numpy(), np.sin(ang), atol=5e-7)
    np.testing.assert_allclose(got[1].numpy(), np.cos(ang), atol=5e-7)


@pytest.mark.parametrize("center,rate,k,n", [
    (92e6, 2.4e6, 3, 16384), (100e6, 9.6e6, 2, 4096), (92e6, 2.4e6, 1, 1)])
def test_synth_batch_matches_jax_device_synth(center, rate, k, n):
    """Bound: 1e-6 x gain_mult x tones, absolute (float32 sums of unit
    tones)."""
    tones = tuple(jsrc._grid_tone_offsets(center, rate, 1e6))
    key = jax.random.key(int(center) % 1000 + k)
    want = jsrc._build_device_synth(tones, rate, 0.5, k, n)(key)
    t0 = np.array([int(jax.random.bits(sub, (), jnp.uint32))
                   for sub in jax.random.split(key, k)], np.int64)
    got = tsrc.synth_batch(torch.from_numpy(t0), tones, rate, 0.5, n, "cpu")
    bound = 1e-6 * 10 ** (0.5 / 10) * len(tones)
    for g, w in zip(got, want):
        assert g.shape == (k, n) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=bound)


def test_synth_batch_chunks_rows_without_changing_the_result(monkeypatch):
    tones = (1e6, 0.0, -1e6)
    t0 = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 123456789])
    whole = tsrc.synth_batch(t0, tones, 2.4e6, 0.5, 2048, "cpu")
    monkeypatch.setattr(tsrc, "_PHASE_CHUNK", 2 * 2048)
    chunked = tsrc.synth_batch(t0, tones, 2.4e6, 0.5, 2048, "cpu")
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_devicesynth_phase_precision():
    """tests/test_gui_and_io.py::test_devicesynth_phase_precision on the
    port's source: >= 120 dB windowed peak over the median floor, tones on
    91/92/93 MHz."""
    src = tsrc.DeviceSynthIQSource(center_freq=92e6, sample_rate=2.4e6,
                                   gain=0.5, seed=3, device="cpu")
    n = 16384
    re, im = src.read(n)
    assert re.dtype == np.float32 and re.shape == (n,)
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    spec = np.abs(np.fft.fftshift(np.fft.fft(x * np.hanning(n))))
    freqs = np.fft.fftshift(np.fft.fftfreq(n, 1 / 2.4e6)) + 92e6
    ratio_db = 20 * np.log10(spec.max() / np.median(spec))
    assert ratio_db > 120.0, f"tone purity collapsed: {ratio_db:.1f} dB"
    top3 = sorted(round(f / 1e6, 3) for f in freqs[np.argsort(spec)[-3:]])
    assert top3 == [91.0, 92.0, 93.0], top3


def test_devicesynth_is_seeded_and_retunes():
    a = tsrc.DeviceSynthIQSource(seed=4, device="cpu")
    b = tsrc.DeviceSynthIQSource(seed=4, device="cpu")
    for x, y in zip(a.read_device_batch(2, 256), b.read_device_batch(2, 256)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert a.retune(100e6, 2.4e6, 0.5)
    assert a.tones() == (1e6, 0.0, -1e6)


def test_devicenoise_dtype_shape_and_reuse():
    src = tsrc.DeviceNoiseIQSource(seed=5, device="cpu")
    re, im = src.read_device_batch(3, 4096)
    assert re.dtype == im.dtype == torch.uint8
    assert re.shape == im.shape == (3, 4096)
    assert abs(float(re.float().mean()) - 127.5) < 2.0
    again = src.read_device_batch(3, 4096)
    assert not torch.equal(again[0], re)
    reuse = tsrc.DeviceNoiseIQSource(seed=5, reuse=True, device="cpu")
    first = reuse.read_device_batch(3, 4096)
    assert reuse.read_device_batch(3, 4096) is first
    assert reuse.read_device_batch(2, 4096) is not first
    fre, fim = src.read(1024)
    assert fre.dtype == np.float32 and fre.shape == (1024,)
    assert fre.min() >= -127.0 and fre.max() <= 128.0


def test_device_sources_need_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tsrc.DeviceSynthIQSource, tsrc.DeviceNoiseIQSource):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
        assert cls(device="cpu").device.type == "cpu"


class StubDeviceSource:
    """Hands both sessions the same planes through ``read_device_batch``:
    ``jnp`` arrays to the JAX session, ``torch`` tensors to the port's."""

    def __init__(self, re, im, as_array):
        self.re, self.im, self.as_array = re, im, as_array
        self.pos = 0
        self.batches = []

    def read_device_batch(self, k, n):
        assert n == self.re.shape[1]
        sl = slice(self.pos, self.pos + k)
        self.pos += k
        self.batches.append(k)
        return self.as_array(self.re[sl]), self.as_array(self.im[sl])

    def read(self, n):
        raise AssertionError("the catch-up driver takes device batches")

    def retune(self, *args):
        return True

    def close(self):
        pass


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_device_batch_catchup_session_matches_jax(u8):
    """Catch-up 4 over 10 blocks (batches 4, 4, 2), no host staging cap:
    the final curves agree to rtol 5e-5."""
    cfg = zs_cfg(2048, prg_loop_cnt=10)
    re, im = raw_planes(cfg, 10, seed=31)
    if not u8:
        re = re.astype(np.float32) - 127.0
        im = im.astype(np.float32) - 127.0
    js = jsess.Session(cfg, StubDeviceSource(re, im, jnp.asarray),
                       catch_up=4)
    tsrc_stub = StubDeviceSource(re, im, torch.from_numpy)
    ts = tsess.Session(cfg, tsrc_stub, device="cpu", catch_up=4)
    jstate, tstate = jsess.run_zero_span(js), tsess.run_zero_span(ts)
    assert tsrc_stub.batches == [4, 4, 2]
    assert tsess._catchup_block_cap(ts, cfg) == 4
    got = state_to_numpy(tstate)
    for k in ("fft_max", "fft_min", "fft_avg"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jstate, k)),
                                   rtol=5e-5)
    np.testing.assert_allclose(ts.final_avg, js.final_avg, rtol=5e-5)
    assert int(got["iteration"]) == 10
