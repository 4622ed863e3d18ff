"""Port parity of the scan path: the plan, ``band_spectra``,
``stitch_sweep``/``sweep_step``, ``sweep_steps`` and the gathered stitch
against ``kspecanal_tpu.models.scan``, the session and CLI against
``kspecanal_tpu.session.run_scan`` on the same seeded sources, the K1
predicate up to fmScan's fft 16384, and that the port never loads JAX.

Curves are dB: ``torch_parity.assert_db_close`` (1e-3 dB within 100 dB of
the peak; 30 dB for the noiseless synth, whose other bins sit on the float32
rounding floor).  Where the port compares two of its own routes, they must
agree bit for bit."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu import session as jsess
from kspecanal_tpu.cli import RunOptions, make_source, parse_args
from kspecanal_tpu.config import MODE_SCAN, WINDOW_HANNING, SpecConfig
from kspecanal_tpu.io.replay import load_sig_lvls
from kspecanal_tpu.io.sources import FlakySource, SynthIQSource
from kspecanal_tpu.models import scan as js
from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu_torch import cli as tcli
from kspecanal_tpu_torch import session as tsess
from kspecanal_tpu_torch.models import scan as ts
from kspecanal_tpu_torch.models.convert import (scan_state_from_numpy,
                                                scan_state_to_numpy)
from kspecanal_tpu_torch.ops import cuda_curscan, cuda_packed
from torch_parity import assert_db_close, write_capture, zs_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN_ARGS = ["scan", "startFreq", "88e6", "endFreq", "96e6", "samplingRate",
             "2e6", "fftSize", "128", "xRes", "128", "window", "hanning",
             "curScanNonOverlap", "0.5", "tpuLogIter", "false"]


def scan_cfg(**kw):
    base = dict(prg_mode=MODE_SCAN, start_freq=88e6, end_freq=96e6,
                sampling_rate=2e6, fft_size=128, x_res=128,
                window=WINDOW_HANNING, cur_scan_non_overlap=0.5,
                scan_range_non_overlap=0.5)
    base.update(kw)
    return SpecConfig(**base).finalize()


def plans(cfg):
    return js.make_scan_plan(cfg), ts.make_scan_plan(cfg)


def sweep_inputs(cfg, plan, s, seed):
    """(S, B, full) float32 planes, retune flags with one failure, and a
    baseline."""
    rng = np.random.default_rng(seed)
    b = plan.num_bands
    re, im = (rng.standard_normal((s, b, cfg.full_size)).astype(np.float32)
              for _ in range(2))
    oks = np.ones((s, b), bool)
    oks[min(1, s - 1), min(2, b - 1)] = False
    adj = rng.standard_normal(plan.total_entries).astype(np.float32)
    return re, im, oks, adj


def assert_states_close(tstate, jstate, span_db=100.0):
    """Every curve within ``span_db`` of the state's peak (the Max curve's;
    Min starts at -gain dB and may never reach the tones)."""
    got = scan_state_to_numpy(tstate)
    for k in ("hm_index", "sweep"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jstate, k)))
    peak = np.max(np.asarray(jstate.fft_max))
    for k in ("fft_max", "fft_min", "fft_avg", "fft_cur", "heatmap"):
        assert got[k].dtype == np.float32
        assert_db_close(got[k], np.asarray(getattr(jstate, k)), span_db,
                        peak=peak)


def assert_states_equal(a, b):
    for k, x, y in zip(ts.ScanState._fields, a, b):
        assert torch.equal(x, y), k


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("preset", ["fmScan", "quickFullScan", "small"])
def test_make_scan_plan_equals_jax(preset):
    cfg = scan_cfg() if preset == "small" else parse_args([preset])[0]
    jp, tp = plans(cfg)
    assert [dataclasses.astuple(b) for b in tp.bands] == \
        [dataclasses.astuple(b) for b in jp.bands]
    assert (tp.total_entries, tp.num_groups, tp.freqs_all) == \
        (jp.total_entries, jp.num_groups, jp.freqs_all)
    want = js._gather_stitch_plan(cfg, jp)
    got = ts._gather_stitch_plan(cfg, tp)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    if preset != "small":
        geometry = {"fmScan": (16384, 131072, 71, 18, 147456),
                    "quickFullScan": (64, 512, 71, 1226, 39232)}[preset]
        assert (cfg.fft_size, cfg.full_size, cfg.num_windows, tp.num_bands,
                tp.total_entries) == geometry


@pytest.mark.parametrize("case", ["curscan", "u8", "psd", "histlowclip"])
def test_band_spectra_matches_jax(case):
    kw = {"psd": dict(b_use_psd=True),
          "histlowclip": dict(scan_clip_proc="HistLowClip")}.get(case, {})
    cfg = scan_cfg(**kw)
    jp, tp = plans(cfg)
    re, im, oks, _ = sweep_inputs(cfg, tp, 2, seed=31)
    re, im, oks = re[1], im[1], oks[1]
    if case == "u8":
        rng = np.random.default_rng(32)
        re, im = (rng.integers(0, 256, re.shape, dtype=np.uint8)
                  for _ in range(2))
    want = np.asarray(js.band_spectra(jnp.asarray(re), jnp.asarray(im),
                                      jnp.asarray(oks), cfg))
    got = ts.band_spectra(t(re), t(im), t(oks), cfg).numpy()
    assert got.dtype == np.float32
    assert_db_close(got[oks], want[oks])
    # Failed retune: the all-ones sentinel band, LogNoGain(1) = -gain dB.
    np.testing.assert_array_equal(got[~oks], want[~oks])
    np.testing.assert_allclose(got[~oks], -cfg.gain, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(scan_range_non_overlap=0.25),
                                dict(scan_range_non_overlap=0.75),
                                dict(b_scan_range_base_data_is_raw=True),
                                dict(b_use_psd=True)],
                         ids=["ovl0.5", "ovl0.25", "ovl0.75", "rawbase",
                              "psd"])
def test_sweep_step_and_sweep_steps_match_jax(kw):
    """Three sweeps, a failed retune in the second, a baseline: the serial
    ``sweep_step`` fold and the batched ``sweep_steps`` (gathered where the
    plan admits it) against the JAX functions."""
    cfg = scan_cfg(**kw)
    jp, tp = plans(cfg)
    re, im, oks, adj = sweep_inputs(cfg, tp, 3, seed=33)
    jstate, tstate = js.init_state(cfg, jp), ts.init_state(cfg, tp, "cpu")
    assert_states_close(tstate, jstate)
    for i in range(3):
        jstate = js.sweep_step_jit(jstate, jnp.asarray(re[i]),
                                   jnp.asarray(im[i]), jnp.asarray(oks[i]),
                                   cfg, jp, jnp.asarray(adj))
        tstate = ts.sweep_step(tstate, t(re[i]), t(im[i]), t(oks[i]), cfg, tp,
                               t(adj))
        assert_states_close(tstate, jstate)
    jbat = js.sweep_steps_jit(js.init_state(cfg, jp), jnp.asarray(re),
                              jnp.asarray(im), jnp.asarray(oks), cfg, jp,
                              jnp.asarray(adj))
    tbat = ts.sweep_steps(ts.init_state(cfg, tp, "cpu"), t(re), t(im), t(oks),
                          cfg, tp, t(adj))
    assert_states_close(tbat, jbat)
    assert (ts._gather_stitch_plan(cfg, tp) is not None) == \
        (kw.get("scan_range_non_overlap", 0.5) >= 0.5
         and not kw.get("b_scan_range_base_data_is_raw", False))


@pytest.mark.parametrize("preset", ["fmScan", "quickFullScan"])
def test_gathered_stitch_equals_sequential_fold_bitwise(preset):
    """On both presets' plans, the gathered stitch at S=1 gives the
    sequential band fold's numbers bit for bit, on the first sweep (Avg
    copies) and on a continuing one, with and without a baseline."""
    cfg = parse_args([preset])[0]
    plan = ts.make_scan_plan(cfg)
    tbl = ts._gather_tables(cfg, plan, torch.device("cpu"))
    assert tbl is not None
    rng = np.random.default_rng(34)
    adj = t(rng.standard_normal(plan.total_entries).astype(np.float32))
    for a in (None, adj):
        seq = gat = ts.init_state(cfg, plan, "cpu")
        for sweep in range(2):
            spectra = t((rng.standard_normal((plan.num_bands, cfg.fft_size))
                         * 10 - 60).astype(np.float32))
            seq = ts.stitch_sweep(seq, spectra, cfg, plan, a)
            gat = ts._stitch_sweeps_gathered(gat, spectra[None], cfg, tbl, a)
            assert_states_equal(gat, seq)


def test_sweep_steps_u8_equals_decoded_planes():
    cfg = scan_cfg()
    plan = ts.make_scan_plan(cfg)
    rng = np.random.default_rng(35)
    raw = rng.integers(0, 256, (2, plan.num_bands, 2 * cfg.full_size),
                       dtype=np.uint8)
    oks = torch.ones((2, plan.num_bands), dtype=torch.bool)
    st0 = ts.init_state(cfg, plan, "cpu")
    got = ts.sweep_steps_u8(st0, t(raw), oks, cfg, plan)
    dec = raw.astype(np.float32) - np.float32(127.0)
    want = ts.sweep_steps(st0, t(dec[..., 0::2]), t(dec[..., 1::2]), oks, cfg,
                          plan)
    assert_states_equal(got, want)


def test_scan_state_converts_both_ways_with_jax():
    """A JAX state (as numpy) starts the port; one more sweep in both
    packages agrees, and the port's state converts back."""
    cfg = scan_cfg()
    jp, tp = plans(cfg)
    re, im, oks, _ = sweep_inputs(cfg, tp, 2, seed=36)
    jstate = js.sweep_step_jit(js.init_state(cfg, jp), jnp.asarray(re[0]),
                               jnp.asarray(im[0]), jnp.asarray(oks[0]), cfg,
                               jp)
    d = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    tstate = scan_state_from_numpy(d, "cpu")
    back = scan_state_to_numpy(tstate)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    jstate = js.sweep_step_jit(jstate, jnp.asarray(re[1]), jnp.asarray(im[1]),
                               jnp.asarray(oks[1]), cfg, jp)
    tstate = ts.sweep_step(tstate, t(re[1]), t(im[1]), t(oks[1]), cfg, tp)
    assert_states_close(tstate, jstate)


def run_both(cfg, make_src, span_db=100.0, **kw):
    """Both packages' ``run_scan`` on fresh sources from ``make_src``."""
    js_ = jsess.Session(cfg, make_src(), **kw)
    ts_ = tsess.Session(cfg, make_src(), device="cpu", **kw)
    jstate, tstate = jsess.run_scan(js_), tsess.run_scan(ts_)
    assert_states_close(tstate, jstate, span_db)
    assert_db_close(ts_.final_avg, js_.final_avg, span_db,
                    peak=np.max(np.asarray(jstate.fft_max)))
    assert ts_.final_avg.dtype == np.float64
    return ts_, tstate


@pytest.mark.parametrize("kw", [dict(), dict(catch_up=3),
                                dict(sweep_prefetch=True),
                                dict(catch_up=2, sweep_prefetch=True)],
                         ids=["serial", "catchup3", "prefetch",
                              "catchup2-prefetch"])
def test_run_scan_synth_matches_jax(kw):
    cfg = scan_cfg(prg_loop_cnt=4)
    ts_, tstate = run_both(cfg, lambda: SynthIQSource(
        sample_rate=cfg.sampling_rate, seed=41), span_db=30.0, **kw)
    assert int(tstate.sweep) == 4
    # one acquire a step: a sweep, or a batch of catch-up sweeps
    assert ts_.timer.count("acquire") == {0: 4, 2: 2, 3: 2}[
        kw.get("catch_up", 0)]


@pytest.mark.parametrize("kw", [dict(), dict(catch_up=2),
                                dict(sweep_prefetch=True)],
                         ids=["serial", "catchup2", "prefetch"])
def test_run_scan_u8_file_matches_jax(tmp_path, kw):
    """A file source ships raw u8 planes into the kernels' wrappers."""
    cfg = scan_cfg(prg_loop_cnt=3)
    path = str(tmp_path / "cap.iq")
    write_capture(path, cfg, 3 * 8 * cfg.full_size, seed=42)
    run = RunOptions(source=f"file:{path}")
    ts_, _ = run_both(cfg, lambda: make_source(cfg, run), **kw)
    assert hasattr(ts_.source, "read_raw")


def test_run_scan_failed_retunes_match_jax():
    """Every third retune fails: sentinel bands in both packages; when every
    retune fails the stitched Cur is exactly -gain dB."""
    cfg = scan_cfg(prg_loop_cnt=2)
    run_both(cfg, lambda: FlakySource(SynthIQSource(
        sample_rate=cfg.sampling_rate, seed=43), fail_every=3), span_db=30.0)
    sess = tsess.Session(cfg, FlakySource(SynthIQSource(
        sample_rate=cfg.sampling_rate, seed=3), fail_every=1), device="cpu")
    state = tsess.run_scan(sess, max_sweeps=1)
    np.testing.assert_allclose(state.fft_cur.numpy(), -cfg.gain, atol=1e-4)


def test_render_every_band_emits_per_band_and_ends_equal():
    """tpuRenderEvery band: one interim view per band plus one per sweep,
    and the same final state as the per-sweep cadence, bit for bit."""
    cfg = scan_cfg(end_freq=92e6)
    plan = ts.make_scan_plan(cfg)

    def run(render_every):
        views = []
        sess = tsess.Session(
            cfg, SynthIQSource(sample_rate=cfg.sampling_rate, seed=44),
            renderer=lambda s, v, p, i, ts_: views.append((v, p)),
            device="cpu", render_every=render_every)
        return tsess.run_scan(sess, max_sweeps=2), views

    st_band, views_band = run("band")
    st_sweep, views_sweep = run("sweep")
    assert len(views_sweep) == 2
    assert len(views_band) == 2 * (plan.num_bands + 1)
    assert_states_equal(st_band, st_sweep)
    assert isinstance(views_band[0][0], ts.ScanView)
    assert isinstance(views_band[0][0].cur_lvls, np.ndarray)
    assert views_band[0][1] == [] and views_band[plan.num_bands][1]
    np.testing.assert_array_equal(views_band[plan.num_bands - 1][0].cur_lvls,
                                  views_band[plan.num_bands][0].cur_lvls)


@pytest.mark.parametrize("extra,kw", [
    ([], {}), (["tpuCatchUp", "3"], dict(catch_up=3)),
    (["tpuPrefetch", "true"], dict(sweep_prefetch=True))],
    ids=["serial", "catchup3", "prefetch"])
def test_cli_scan_matches_jax_and_peaks_on_integer_mhz(tmp_path, monkeypatch,
                                                       extra, kw):
    """Through the entry point with a seeded synth source: the saved final
    average equals the JAX session's on the same source (serial, catch-up,
    sweep read-ahead), and its strongest peaks lie on integer MHz
    (SynthIQSource puts a tone at every integer MHz of each band), within
    one display cell."""
    cfg, _ = parse_args(SCAN_ARGS + ["prgLoopCnt", "3"])

    def seeded(cfg, run):
        return SynthIQSource(center_freq=cfg.center_freq,
                             sample_rate=cfg.sampling_rate, gain=0.5, seed=45)

    monkeypatch.setattr(tcli, "make_source", seeded)
    lvls = str(tmp_path / "lvls.bin")
    rc = tcli.main(SCAN_ARGS + ["prgLoopCnt", "3", "tpuSource", "synth",
                                "tpuHeadless", "true", "saveSigLvls", lvls]
                   + extra, device="cpu")
    assert rc == 0
    start, end, avg = load_sig_lvls(lvls)
    assert (start, end) == (88e6, 96e6) and avg.shape == (512,)
    js_ = jsess.Session(cfg, seeded(cfg, None), **kw)
    jstate = jsess.run_scan(js_)
    assert_db_close(avg, js_.final_avg, span_db=30.0,
                    peak=np.max(np.asarray(jstate.fft_max)))
    freqs = np.asarray(ts.make_scan_plan(cfg).freqs_all)
    top = freqs[np.argsort(avg)[::-1][:6]]
    cell = (freqs[-1] - freqs[0]) / cfg.x_res
    assert np.all(np.abs(top - np.round(top / 1e6) * 1e6) <= cell), top


def test_cli_scan_prefetch_and_term_renderer(tmp_path, capsys):
    """tpuPrefetch in scan mode reads whole sweeps ahead (no block
    read-ahead wrapper on the source); the term renderer draws the stitched
    range."""
    path = str(tmp_path / "cap.iq")
    cfg, _ = parse_args(SCAN_ARGS)
    write_capture(path, cfg, 2 * 8 * cfg.full_size, seed=46)
    args = SCAN_ARGS + ["tpuSource", f"file:{path}", "prgLoopCnt", "2",
                        "tpuPrefetch", "true", "tpuRenderer", "term"]
    assert tcli.main(args, device="cpu") == 0
    out = capsys.readouterr().out
    assert "[88.000 - 96.000 MHz]" in out and "plotHighs:Marked:" in out
    assert "iter 1" in out


def test_sublane_predicate_equals_jax_up_to_fft_16384():
    """fmScan runs fft 16384 at 90% overlap: the JAX sublane kernel takes
    it, and so must the port's (and so every power of two from 256, up to
    131072 through the FFT kernel's clusters)."""
    for fft in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536,
                131072):
        for nono in (0.5, 0.1):
            cfg = zs_cfg(fft, nono, x_res=512)
            assert cuda_curscan.supports_fused_sublane(cfg) \
                == jpk.supports_fused_sublane(cfg) is True, (fft, nono)
    fm = parse_args(["fmScan"])[0]
    qfs = parse_args(["quickFullScan"])[0]
    assert cuda_curscan.supports_fused_sublane(fm)
    assert cuda_packed.supports_fused_packed(qfs)
    assert not cuda_curscan.supports_fused_sublane(qfs)


def test_port_never_imports_jax_with_jax_blocked():
    """With JAX and the JAX package made unimportable, the port's package,
    its scan model, session and CLI import, and a scan runs through the
    entry point (catch-up with sweep read-ahead)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'kspecanal_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import kspecanal_tpu_torch\n"
        "import kspecanal_tpu_torch.models.scan, kspecanal_tpu_torch.session\n"
        "import kspecanal_tpu_torch.io.prefetch\n"
        "import kspecanal_tpu_torch.ops.cuda_packed\n"
        "import kspecanal_tpu_torch.cli as cli\n"
        "assert cli.main(%r, device='cpu') == 0\n"
        "print('nojax ok')\n" % (SCAN_ARGS + [
            "prgLoopCnt", "2", "tpuCatchUp", "2", "tpuPrefetch", "true",
            "tpuSource", "synth", "tpuHeadless", "true"]))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "nojax ok" in proc.stdout
