"""The port's zero-span slice as a whole: ``session.run_zero_span`` and
``cli.main`` against the JAX session on the same seeded sources (fft 2048,
kaiser, 50% overlap), the u8 file-source route, peak placement, the
device sources and ``tpuProfile``, that nothing of the JAX CLI is left
unported (the matplotlib renderer runs: test_torch_gui.py), and that the
port never loads JAX.
Save, replay and checkpoints: test_torch_replay.py.
Tolerances as in ``torch_parity``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kspecanal_tpu import session as jsess
from kspecanal_tpu.cli import RunOptions, make_source
from kspecanal_tpu.io.replay import load_sig_lvls
from kspecanal_tpu.io.sources import SynthIQSource
from kspecanal_tpu_torch import cli as tcli
from kspecanal_tpu_torch import session as tsess
from kspecanal_tpu_torch.models.convert import state_to_numpy
from kspecanal_tpu_torch.ops import dsp
from kspecanal_tpu_torch.ops.peaks import find_peaks
from kspecanal_tpu_torch.ops.spectrum import fft_freqs
from torch_parity import assert_db_close, write_capture, zs_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = zs_cfg(2048, prg_loop_cnt=4)
ZS_ARGS = ["zeroSpan", "centerFreq", "92e6", "fftSize", "2048", "window",
           "kaiser", "curScanNonOverlap", "0.5", "tpuLogIter", "false"]


def run_both(make_src, catch_up, span_db=100.0):
    """Both sessions on fresh sources from ``make_src``; final states and
    averages compared within ``span_db`` of their peaks."""
    js = jsess.Session(CFG, make_src(), catch_up=catch_up)
    ts = tsess.Session(CFG, make_src(), device="cpu", catch_up=catch_up)
    jstate, tstate = jsess.run_zero_span(js), tsess.run_zero_span(ts)
    got = state_to_numpy(tstate)
    for k in ("hm_index", "iteration", "seeded"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jstate, k)))
    for k in ("fft_max", "fft_min", "fft_avg", "fft_cur", "heatmap"):
        assert_db_close(got[k], np.asarray(getattr(jstate, k)), span_db)
    assert_db_close(ts.final_avg, js.final_avg, span_db)
    assert ts.final_avg.dtype == np.float64
    return ts


@pytest.mark.parametrize("catch_up", [0, 4], ids=["serial", "catchup4"])
def test_run_zero_span_synth_matches_jax(catch_up):
    """The synth tones carry no noise, so away from them the spectra sit on
    the float32 rounding floor, some 70 dB (10*log10 of the magnitude)
    under the peak; 1e-3 dB holds for bins within 30 dB of the peak."""
    ts = run_both(lambda: SynthIQSource(CFG.center_freq, CFG.sampling_rate,
                                        seed=21), catch_up, span_db=30.0)
    assert ts.timer.count("step") == (4 if catch_up == 0 else 1)


@pytest.mark.parametrize("catch_up", [0, 4], ids=["serial", "catchup4"])
def test_run_zero_span_u8_file_matches_jax(tmp_path, catch_up):
    """A file source ships raw u8 planes: the serial route takes the
    batched step at K=1, catch-up stages u8 batches."""
    path = str(tmp_path / "cap.iq")
    write_capture(path, CFG, 3 * CFG.full_size, seed=22)
    run = RunOptions(source=f"file:{path}")
    ts = run_both(lambda: make_source(CFG, run), catch_up)
    assert hasattr(ts.source, "read_raw")


def avg_peaks(cfg, avg, n=3):
    """Top peaks of a final average curve, compressed for display as the
    session's views are."""
    x, y = dsp.compress_xy(torch.as_tensor(fft_freqs(cfg), dtype=torch.float32),
                           torch.as_tensor(avg, dtype=torch.float32),
                           cfg.plt_compress, cfg.x_res)
    return find_peaks(x.numpy(), y.numpy(), cfg.plt_highs_num_markers,
                      cfg.plt_highs_delta4marking)[:n]


@pytest.mark.parametrize("extra", [[], ["tpuCatchUp", "4"]],
                         ids=["serial", "catchup4"])
def test_cli_synth_peaks_on_integer_mhz(tmp_path, extra):
    """Through the entry point, with the final average saved by
    ``saveSigLvls``: the three strongest peaks sit on 91/92/93 MHz, within
    one display cell."""
    lvls = str(tmp_path / "lvls.bin")
    rc = tcli.main(ZS_ARGS + ["tpuSource", "synth", "tpuHeadless", "true",
                              "prgLoopCnt", "4", "saveSigLvls", lvls] + extra,
                   device="cpu")
    assert rc == 0
    start, end, avg = load_sig_lvls(lvls)
    assert (start, end) == CFG.start_end_freq and avg.shape == (2048,)
    cell = CFG.sampling_rate / CFG.x_res
    peaks = sorted(p.freq for p in avg_peaks(CFG, avg))
    np.testing.assert_allclose(peaks, [91e6, 92e6, 93e6], atol=cell)


def test_cli_term_renderer_and_baseline(tmp_path, capsys):
    """The term renderer gets numpy views; a saved baseline loads back as
    the display adjustment."""
    lvls = str(tmp_path / "lvls.bin")
    path = str(tmp_path / "cap.iq")
    write_capture(path, CFG, 2 * CFG.full_size, seed=23)
    src = ["tpuSource", f"file:{path}", "prgLoopCnt", "2"]
    assert tcli.main(ZS_ARGS + src + ["tpuHeadless", "true",
                                      "saveSigLvls", lvls], device="cpu") == 0
    assert tcli.main(ZS_ARGS + src + ["tpuRenderer", "term",
                                      "adjSigLvls", lvls], device="cpu") == 0
    out = capsys.readouterr().out
    assert "plotHighs:Marked:" in out and "iter 1" in out


@pytest.mark.parametrize("extra", [[], ["tpuCatchUp", "4"]],
                         ids=["serial", "catchup4"])
def test_cli_devicesynth_peaks_on_integer_mhz(tmp_path, extra):
    """``tpuSource devicesynth``: the serial loop reads it through
    ``read()``, catch-up through device batches; the final average's three
    strongest peaks sit on 91/92/93 MHz."""
    lvls = str(tmp_path / "lvls.bin")
    rc = tcli.main(ZS_ARGS + ["tpuSource", "devicesynth", "tpuHeadless",
                              "true", "prgLoopCnt", "4", "saveSigLvls", lvls]
                   + extra, device="cpu")
    assert rc == 0
    _, _, avg = load_sig_lvls(lvls)
    cell = CFG.sampling_rate / CFG.x_res
    peaks = sorted(p.freq for p in avg_peaks(CFG, avg))
    np.testing.assert_allclose(peaks, [91e6, 92e6, 93e6], atol=cell)


def test_cli_devicenoise_catchup_ships_u8_planes(monkeypatch, caplog):
    """``tpuSource devicenoise tpuCatchUp 4``: the kernel's wrapper gets the
    u8 planes undecoded, in batches of 4; ``tpuPrefetch`` is ignored for an
    on-device source."""
    from kspecanal_tpu_torch.ops import cuda_curscan
    seen = []
    orig = cuda_curscan.curscan_fused_sublane

    def spy(re, im, cfg, **kw):
        seen.append((re.dtype, re.shape[0]))
        return orig(re, im, cfg, **kw)

    monkeypatch.setattr(cuda_curscan, "curscan_fused_sublane", spy)
    caplog.set_level("INFO", logger="kspecanal_tpu")
    assert tcli.main(ZS_ARGS + ["tpuSource", "devicenoise", "tpuCatchUp",
                                "4", "prgLoopCnt", "8", "tpuPrefetch", "true",
                                "tpuHeadless", "true"], device="cpu") == 0
    assert seen == [(torch.uint8, 4), (torch.uint8, 4)]
    assert "tpuPrefetch: ignored for on-device sources" in caplog.text


def test_cli_tpu_profile_traces_the_session(tmp_path, caplog):
    """``tpuProfile <dir>`` runs the session inside the port's trace: a
    Chrome trace lands in the directory and the log carries the card's
    busy share, absent on the CPU."""
    caplog.set_level("INFO", logger="kspecanal_tpu")
    out = tmp_path / "prof"
    assert tcli.main(ZS_ARGS + ["tpuSource", "devicenoise", "tpuCatchUp",
                                "2", "prgLoopCnt", "4", "tpuProfile",
                                str(out), "tpuHeadless", "true"],
                     device="cpu") == 0
    assert [f for f in os.listdir(out) if f.endswith(".json")]
    assert "profile: device busy share absent" in caplog.text


def test_cli_requires_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(ZS_ARGS + ["prgLoopCnt", "1"])


@pytest.mark.parametrize("args,item", [
    (["tpuRenderer", "png:frames"], "item 8"),
])
def test_unported_modes_and_options_name_their_roadmap_item(
        tmp_path, monkeypatch, caplog, args, item):
    """Nothing of the JAX CLI is left unported: the last option that named
    a ROADMAP.md 'Still to port' item (``item``, the matplotlib renderer)
    now runs, writes its frame, and no message names such an item."""
    monkeypatch.chdir(tmp_path)
    caplog.set_level("INFO", logger="kspecanal_tpu_torch")
    assert tcli.main(ZS_ARGS + ["prgLoopCnt", "1", "tpuHeadless", "true"]
                     + args, device="cpu") == 0
    assert os.listdir(tmp_path / "frames") == ["frame_000000.png"]
    assert "Still to port" not in caplog.text
    assert not hasattr(tsess, "not_ported")


def test_port_never_imports_jax():
    """Importing every module of the port and running one CPU step and one
    devicesynth catch-up step through the entry point leaves JAX
    unloaded."""
    code = (
        "import sys\n"
        "import kspecanal_tpu_torch.cli as cli\n"
        "import kspecanal_tpu_torch.ops.cuda_curscan, "
        "kspecanal_tpu_torch.ops._build, kspecanal_tpu_torch.models.convert, "
        "kspecanal_tpu_torch.parallel.stream, kspecanal_tpu_torch.render_term, "
        "kspecanal_tpu_torch.io.sources, kspecanal_tpu_torch.utils.profiling, "
        "kspecanal_tpu_torch.scripts.roofline_r2, "
        "kspecanal_tpu_torch.scripts.kernel_ablate, "
        "kspecanal_tpu_torch.scripts.session_ablate, "
        "kspecanal_tpu_torch.scripts.qfs_ablate\n"
        "assert cli.main(%r, device='cpu') == 0\n"
        "assert cli.main(%r, device='cpu') == 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n"
        "print('nojax ok')\n" % (
            ZS_ARGS + ["prgLoopCnt", "1", "tpuHeadless", "true"],
            ZS_ARGS + ["tpuSource", "devicesynth", "tpuCatchUp", "2",
                       "prgLoopCnt", "2", "tpuHeadless", "true"]))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "nojax ok" in proc.stdout
