"""The port's offline capture analyzer (``kspecanal_tpu_torch.tools``) and
fixture writer (``scripts/make_fixture.py``) against the JAX package's
(``kspecanal_tpu/tools.py``, ``scripts/make_fixture.py``) on the CPU.

The four spectra (complex, real, imag, abs) of the same seeded u8 capture
agree within rtol 5e-5 plus atol 1e-6 of the peak at fft 2048 and 128, with
and without decimation; ``main`` writes the same npz keys; the fixture is
byte for byte the JAX script's.  Without ``device="cpu"`` both the analyzer
and ``render_demo`` need a card."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from kspecanal_tpu import tools as jtools
from kspecanal_tpu_torch import tools as ttools
from kspecanal_tpu_torch.scripts import make_fixture, render_demo
from torch_parity import write_capture, zs_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("complex", "real", "imag", "abs")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """150,000 samples of tones at every integer MHz plus noise, u8."""
    path = str(tmp_path_factory.mktemp("cap") / "cap.iq")
    write_capture(path, zs_cfg(2048), 150_000, seed=5)
    return path


@pytest.mark.parametrize("decimate", [None, 4], ids=["raw", "decimate4"])
@pytest.mark.parametrize("fft", [2048, 128])
def test_analyze_capture_matches_jax(capture, fft, decimate):
    want = jtools.analyze_capture(capture, fft, decimate=decimate)
    got = ttools.analyze_capture(capture, fft, decimate=decimate,
                                 device="cpu")
    assert set(got) == set(want)
    assert (got["num_blocks"], got["fft_size"]) == (want["num_blocks"],
                                                    want["fft_size"])
    for k in KEYS:
        assert got[k].shape == (fft,) and got[k].dtype == np.float32
        peak = np.max(np.abs(want[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=5e-5,
                                   atol=1e-6 * peak)


def test_main_writes_the_same_npz_keys(capture, tmp_path):
    jout, tout = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    argv = [capture, "fftSize", "128", "window", "kaiser", "decimate", "2"]
    assert jtools.main(argv + ["out", jout]) == 0
    assert ttools.main(argv + ["out", tout], device="cpu") == 0
    jz, tz = np.load(jout), np.load(tout)
    assert sorted(tz.files) == sorted(jz.files)
    assert f"{capture}:complex" in tz.files
    for k in jz.files:
        want = jz[k]
        if want.ndim:
            np.testing.assert_allclose(tz[k], want, rtol=5e-5,
                                       atol=1e-6 * np.max(np.abs(want)))
        else:
            assert tz[k] == want


def test_main_without_files_prints_its_usage(capsys):
    assert ttools.main([], device="cpu") == 1
    assert "kspecanal_tpu_torch.tools capture.iq" in capsys.readouterr().out


def test_analyzer_and_render_demo_need_the_card(capture, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttools.analyze_capture(capture, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttools.main([capture, "fftSize", "128"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_demo.main(["unused.png"])


def test_short_capture_raises(tmp_path):
    path = str(tmp_path / "short.iq")
    np.zeros(2 * 100, np.uint8).tofile(path)
    for dec in (None, 2):
        with pytest.raises(ValueError, match="shorter than one block"):
            ttools.analyze_capture(path, 128, decimate=dec, device="cpu")


@pytest.mark.parametrize("args", [
    (20_000,), (12_345, 95e6, 3.0, 2.4e6, 7)], ids=["defaults", "custom"])
def test_make_fixture_is_byte_identical_to_jax(tmp_path, args):
    spec = importlib.util.spec_from_file_location(
        "make_fixture_jax", os.path.join(REPO, "scripts", "make_fixture.py"))
    jfix = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfix)
    n, rest = args[0], args[1:]
    kw = dict(zip(("center_freq", "gain", "sample_rate", "seed"), rest))
    jfix.make_capture(str(tmp_path / "jax.iq"), n, **kw)
    make_fixture.make_capture(str(tmp_path / "port.iq"), n, **kw)
    a = (tmp_path / "jax.iq").read_bytes()
    assert len(a) == 2 * n
    assert (tmp_path / "port.iq").read_bytes() == a


def test_make_fixture_main_then_the_analyzer(tmp_path, capsys):
    """The CLI form writes the capture the analyzer reads; its complex
    spectrum peaks on the synth's 91/92/93 MHz tones."""
    from kspecanal_tpu_torch.config import SpecConfig
    from kspecanal_tpu_torch.ops.spectrum import fft_freqs
    path = str(tmp_path / "fix.iq")
    make_fixture.main([path, "65536"])
    assert "wrote" in capsys.readouterr().out
    r = ttools.analyze_capture(path, 2048, device="cpu")
    cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=2048).finalize()
    top = sorted(fft_freqs(cfg)[np.argsort(r["complex"])[-3:]])
    np.testing.assert_allclose(top, [91e6, 92e6, 93e6],
                               atol=cfg.sampling_rate / 2048)
