"""The port's matplotlib renderer (``kspecanal_tpu_torch/gui.py``) and the
session's step-boundary toggles (``Session._apply_pending_toggles``) on the
CPU, on matplotlib's Agg backend.

  * counterparts of tests/test_gui_and_io.py's headless smoke, toggle and
    png tests, with ``device="cpu"``;
  * toggle parity: the same seeded source through the JAX package's and the
    port's five unsharded drivers (zero-span serial, catch-up and replay,
    scan serial and catch-up) with a renderer that turns ``b_data_min`` off
    after its second frame: the final curves agree (``torch_parity``'s dB
    bound) and the min curve of every later view equals the second view's;
  * the CLI: ``tpuRenderer png:<Dir>`` writes one PNG an iteration into the
    directory as spelled, a missing matplotlib fails that run with
    ``ImportError``, and an interactive renderer is held at the end of a
    run (``hold_until_key``)."""
import dataclasses
import os
import sys

import numpy as np
import pytest

from kspecanal_tpu import session as jsess
from kspecanal_tpu_torch import cli as tcli
from kspecanal_tpu_torch import session as tsess
from kspecanal_tpu_torch.config import MODE_SCAN, WINDOW_HANNING, SpecConfig
from kspecanal_tpu_torch.io.replay import ZeroSpanRecorder
from kspecanal_tpu_torch.io.sources import SynthIQSource
from kspecanal_tpu_torch.models.convert import (scan_state_to_numpy,
                                                state_to_numpy)
from torch_parity import assert_db_close, zs_cfg

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)
from kspecanal_tpu_torch.gui import MatplotlibRenderer  # noqa: E402

ZS_ARGS = ["zeroSpan", "centerFreq", "92e6", "fftSize", "2048", "window",
           "kaiser", "curScanNonOverlap", "0.5", "tpuLogIter", "false"]


def small_cfg():
    return SpecConfig(prg_mode="ZEROSPAN", fft_size=128, sampling_rate=2.4e6,
                      x_res=128).finalize()


def test_gui_headless_smoke():
    cfg = small_cfg()
    r = MatplotlibRenderer(cfg, interactive=False)
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=2)
    sess = tsess.Session(cfg, src, renderer=r, device="cpu")
    tsess.run_zero_span(sess, max_iters=2)
    # toggle a curve off and re-apply
    r.toggles["b_data_min"] = False
    cfg2 = r.apply_toggles(cfg)
    assert cfg2.b_data_min is False
    # quit path
    r.quit_requested = True
    tsess.run_zero_span(sess, max_iters=2)
    assert sess.stop
    r.close()


def test_toggles_applied_at_step_boundary():
    """Flipping a curve button mid-run changes the effective config for
    subsequent steps (applied between iterations, not mid-step)."""
    cfg = small_cfg()
    r = MatplotlibRenderer(cfg, interactive=False)
    calls = {"n": 0}
    orig_call = r.__call__

    def counting_call(sess, view, peaks, i, ts):
        calls["n"] += 1
        if calls["n"] == 2:
            r.toggles["b_data_min"] = False  # simulate button press
        orig_call(sess, view, peaks, i, ts)

    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=9)
    sess = tsess.Session(cfg, src, renderer=None, device="cpu")

    class R:
        def __call__(self, *a):
            return counting_call(*a)

        def apply_toggles(self, c):
            return r.apply_toggles(c)
    sess.renderer = R()
    tsess.run_zero_span(sess, max_iters=4)
    assert sess.cfg.b_data_min is False
    r.close()


def test_png_renderer_writes_frames(tmp_path):
    cfg = small_cfg()
    r = MatplotlibRenderer(cfg, interactive=False, save_dir=str(tmp_path))
    src = SynthIQSource(center_freq=cfg.center_freq,
                        sample_rate=cfg.sampling_rate, seed=3)
    sess = tsess.Session(cfg, src, renderer=r, device="cpu")
    tsess.run_zero_span(sess, max_iters=2)
    r.close()
    frames = sorted(tmp_path.glob("frame_*.png"))
    assert len(frames) == 2 and frames[0].stat().st_size > 1000


def test_button_handlers_keep_one_curve_and_the_pick_readout():
    """The buttons' handlers: turning every curve off turns Avg back on
    (kspecanal.py:983-984), labels follow, Quit asks the session to stop,
    and a heatmap click reads a frequency."""
    import types
    cfg = small_cfg()
    r = MatplotlibRenderer(cfg, interactive=False)
    for name in ("MaxLvls", "MinLvls", "AvgLvls", "CurLvls"):
        r._make_toggle(name, {"MaxLvls": "b_data_max",
                              "MinLvls": "b_data_min",
                              "AvgLvls": "b_data_avg",
                              "CurLvls": "b_data_cur"}[name])(None)
    assert r.toggles["b_data_avg"] is True
    assert not any(r.toggles[k] for k in ("b_data_max", "b_data_min",
                                          "b_data_cur"))
    assert r._buttons["AvgLvls"].label.get_text() == "AvgLvls[x]"
    assert r._buttons["MinLvls"].label.get_text() == "MinLvls[ ]"
    r._on_pick(types.SimpleNamespace(
        mouseevent=types.SimpleNamespace(xdata=0.5)))
    assert "ClickedFreq:" in r.ax_heatmap.get_xlabel()
    r._on_quit(None)
    sess = types.SimpleNamespace(stop=False)
    r(sess, None, [], 0, None)
    assert sess.stop
    r.close()


# ---------------------------------------------------------------------------
# Toggle parity with the JAX package's drivers
# ---------------------------------------------------------------------------

class NoisyTones:
    """Seeded tones plus unit white noise, so each bin's min curve moves
    from block to block; the same stream in either package."""

    def __init__(self, cfg, seed):
        self.inner = SynthIQSource(cfg.center_freq, cfg.sampling_rate,
                                   seed=seed)
        self.rng = np.random.default_rng(seed)

    def read(self, n):
        re, im = self.inner.read(n)
        return tuple((p + self.rng.standard_normal(n)).astype(np.float32)
                     for p in (re, im))

    def retune(self, center_freq, sample_rate, gain):
        return self.inner.retune(center_freq, sample_rate, gain)

    def close(self):
        pass


class Toggler:
    """A renderer that keeps each view's min curve and, from its second
    frame on, turns b_data_min off (as a click on MinLvls does)."""

    def __init__(self):
        self.mins = []

    def __call__(self, sess, view, peaks, iteration, timestamp_str):
        self.mins.append(np.array(view.min_lvls))

    def apply_toggles(self, cfg):
        if len(self.mins) >= 2:
            return dataclasses.replace(cfg, b_data_min=False)
        return cfg


def jax_cfg(cfg):
    """The JAX package's config with the same fields."""
    from kspecanal_tpu.config import SpecConfig as JSpecConfig
    return JSpecConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


def scan_cfg(**kw):
    return SpecConfig(prg_mode=MODE_SCAN, start_freq=88e6, end_freq=96e6,
                      sampling_rate=2e6, fft_size=128, x_res=128,
                      window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                      scan_range_non_overlap=0.5, **kw).finalize()


def record(path, cfg, frames, seed):
    """A zeroSpanSave stream of ``frames`` positive linear spectra."""
    rng = np.random.default_rng(seed)
    with ZeroSpanRecorder(path, cfg.center_freq, cfg.sampling_rate,
                          cfg.gain) as rec:
        for i in range(frames):
            rec.append(rng.uniform(1e-4, 1.0, cfg.fft_size), timestamp=i)


DRIVERS = {
    "zero-span-serial": (lambda: zs_cfg(2048), dict(), 5, "run_zero_span"),
    "zero-span-catchup": (lambda: zs_cfg(2048), dict(catch_up=2), 8,
                          "run_zero_span"),
    "zero-span-play": (lambda: zs_cfg(256), dict(), 6,
                       "run_zero_span_play"),
    "scan-serial": (scan_cfg, dict(), 4, "run_scan"),
    "scan-catchup": (scan_cfg, dict(catch_up=2), 6, "run_scan"),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_toggle_parity_with_jax(tmp_path, name):
    make, kw, n, run = DRIVERS[name]
    cfg = make()
    replay = run == "run_zero_span_play"
    if replay:
        path = str(tmp_path / "rec.save")
        record(path, cfg, n, seed=61)
        cfg = dataclasses.replace(cfg, prg_mode="ZEROSPANPLAY",
                                  zero_span_play_file=path)
    states, togglers = [], []
    for mod, c in ((tsess, cfg), (jsess, jax_cfg(cfg))):
        r = Toggler()
        extra = {"device": "cpu"} if mod is tsess else {}
        sess = mod.Session(c, None if replay else NoisyTones(cfg, 62), r,
                           **extra, **kw)
        states.append(getattr(mod, run)(sess, n))
        assert sess.cfg.b_data_min is False
        togglers.append(r)
    tstate, jstate = states
    tr, jr = togglers
    assert len(tr.mins) == len(jr.mins) >= 3
    for r in togglers:
        assert not np.array_equal(r.mins[0], r.mins[1])
        for m in r.mins[2:]:
            np.testing.assert_array_equal(m, r.mins[1])
    for got, want in zip(tr.mins, jr.mins):
        assert_db_close(got, want)
    got = (scan_state_to_numpy if run == "run_scan" else state_to_numpy)(
        tstate)
    peak = np.max(np.asarray(jstate.fft_max))
    for k in ("fft_max", "fft_min", "fft_avg", "fft_cur", "heatmap"):
        assert_db_close(got[k], np.asarray(getattr(jstate, k)), peak=peak)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_png_renderer_writes_one_frame_an_iteration(tmp_path,
                                                        monkeypatch):
    """``tpuRenderer PNG:Out/Frames``: the scheme's case folds, the
    directory's does not; one PNG an iteration."""
    monkeypatch.chdir(tmp_path)
    assert tcli.main(ZS_ARGS + ["tpuSource", "synth", "prgLoopCnt", "3",
                                "tpuRenderer", "PNG:Out/Frames"],
                     device="cpu") == 0
    frames = sorted(os.listdir(tmp_path / "Out" / "Frames"))
    assert frames == ["frame_000000.png", "frame_000001.png",
                      "frame_000002.png"]
    assert not (tmp_path / "out").exists()


def test_cli_png_renderer_without_matplotlib_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        tcli.main(ZS_ARGS + ["tpuSource", "synth", "prgLoopCnt", "1",
                             "tpuRenderer", f"png:{tmp_path / 'f'}"],
                  device="cpu")


def test_cli_gui_without_matplotlib_runs_headless(monkeypatch, caplog):
    """The default ``gui`` renderer: where matplotlib cannot make a window
    the session runs headless and says so, as the JAX CLI does."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    caplog.set_level("INFO", logger="kspecanal_tpu_torch")
    assert tcli.main(ZS_ARGS + ["tpuSource", "synth", "prgLoopCnt", "1"],
                     device="cpu") == 0
    assert "GUI unavailable" in caplog.text and "running headless" in \
        caplog.text


def test_cli_holds_an_interactive_renderer_at_the_end(monkeypatch):
    """An interactive window is held until a keypress after the run
    (kspecanal.py:1152-1155); it saw every iteration first."""
    from kspecanal_tpu_torch import gui

    class Window:
        interactive = True
        made = []

        def __init__(self, cfg):
            self.frames, self.held = 0, False
            Window.made.append(self)

        def __call__(self, sess, view, peaks, iteration, ts):
            self.frames += 1

        def hold_until_key(self):
            self.held = True

    monkeypatch.setattr(gui, "MatplotlibRenderer", Window)
    assert tcli.main(ZS_ARGS + ["tpuSource", "synth", "prgLoopCnt", "2"],
                     device="cpu") == 0
    [w] = Window.made
    assert w.frames == 2 and w.held


def test_render_demo_on_the_cpu(tmp_path, capsys):
    """``scripts/render_demo.py`` with ``--device cpu``: the demo session's
    figure lands in the PNG named, and the synth's peaks were marked on
    91/92/93 MHz."""
    from kspecanal_tpu_torch.scripts import render_demo
    out = str(tmp_path / "demo.png")
    assert render_demo.main([out, "--device", "cpu"]) == out
    assert os.path.getsize(out) > 10000
    marked = [float(ln.split()[1].rstrip(","))
              for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("plotHighs:Marked:")]
    for mhz in (91e6, 92e6, 93e6):
        assert any(abs(f - mhz) < 2.4e6 / 1024 for f in marked)
