"""Command-line entry point of the port: the reference's spelling of
``KEY value`` token pairs, run on a CUDA device through
``kspecanal_tpu_torch.session``.  The parser (:func:`parse_args`,
:class:`RunOptions`, :class:`CliError`), :func:`print_info` and the host
sources' :func:`make_source` are copies of ``kspecanal_tpu.cli``'s: the same
tokens, defaults, validation and messages (tests/test_torch_standalone.py
holds them equal).

    python -m kspecanal_tpu_torch zeroSpan centerFreq 92e6 fftSize 2048 \
        window kaiser curScanNonOverlap 0.5 tpuSource synth tpuHeadless true
    python -m kspecanal_tpu_torch fmScan tpuSource synth tpuHeadless true
    python -m kspecanal_tpu_torch quickFullScan tpuSource synth \
        tpuCatchUp 16 tpuPrefetch true tpuHeadless true
    python -m kspecanal_tpu_torch zeroSpanSave zeroSpanSaveFile rec.save \
        fftSize 3000 prgLoopCnt 64 tpuSource synth
    python -m kspecanal_tpu_torch zeroSpanPlay zeroSpanPlayFile rec.save \
        tpuHeadless true
    python -m kspecanal_tpu_torch zeroSpan tpuSource synth prgLoopCnt 8 \
        tpuStateFile state.npz tpuHeadless true      # resumes on a rerun
    torchrun --nproc-per-node 2 -m kspecanal_tpu_torch zeroSpan \
        fftSize 16384 curScanNonOverlap 0.1 tpuMeshTime 2 tpuHeadless true
    torchrun --nproc-per-node 2 -m kspecanal_tpu_torch fmScan \
        tpuMeshBand 2 tpuHeadless true

``tpuMeshTime N`` / ``tpuMeshBand N`` run one process a rank, launched by
torchrun (``parallel/mesh.py``); rank 0 reads the source, prints and
renders.  ``tpuRenderer gui`` (the default without ``tpuHeadless true``)
opens the matplotlib window (``gui.py``) where a display is available, else
runs headless; ``tpuRenderer png:<dir>`` writes one PNG a rendered frame
into ``<dir>`` and needs matplotlib; ``tpuRenderer term`` draws text.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import signal
import sys
from typing import List, Optional, Tuple

import torch

from kspecanal_tpu_torch import session as sess_mod
from kspecanal_tpu_torch.config import (MODE_ALIAS_FMSCAN,
                                        MODE_ALIAS_QUICKFULLSCAN, MODE_SCAN,
                                        MODE_ZEROSPAN, MODE_ZEROSPANPLAY,
                                        MODE_ZEROSPANSAVE, SpecConfig)
from kspecanal_tpu_torch.io import sources
from kspecanal_tpu_torch.parallel import mesh as mesh_mod
from kspecanal_tpu_torch.utils.logging import log_info, set_iter_logging
from kspecanal_tpu_torch.utils.profiling import trace

_MODES = (MODE_ZEROSPAN, MODE_ZEROSPANSAVE, MODE_ZEROSPANPLAY, MODE_SCAN,
          MODE_ALIAS_FMSCAN, MODE_ALIAS_QUICKFULLSCAN)


def _boolean(v: str) -> bool:
    """kspecanal.py:771-775: only 'TRUE' (case-insensitive) is true."""
    return v.upper() == "TRUE"


@dataclasses.dataclass
class RunOptions:
    """Host-side options that are not part of the DSP config."""
    source: str = "synth"
    headless: bool = False
    mesh_time: int = 1
    mesh_band: int = 1
    prefetch: bool = False   # background read-ahead pipeline (io/prefetch)
    profile_dir: str = ""    # torch.profiler Chrome trace directory
    renderer: str = "gui"    # gui | term | none
    state_file: str = ""     # checkpoint/resume .npz (io/state)
    catch_up: int = 0        # zero-span blocks per dispatch (0/1 = serial)
    render_every: str = "sweep"  # scan render cadence: sweep | band
    decimate: int = 1        # time-domain decimation preprocessor factor
    log_iter: bool = True    # per-iteration timing prints (tpuLogIter)


class CliError(ValueError):
    pass


# (upper-cased CLI key) -> (config field, converter)
_KEYMAP = {
    "CENTERFREQ": ("center_freq", float),
    "STARTFREQ": ("start_freq", float),
    "ENDFREQ": ("end_freq", float),
    "SAMPLINGRATE": ("sampling_rate", float),
    "GAIN": ("gain", float),
    "MINAMP4CLIP": ("min_amp4clip", float),
    "CURSCANNONOVERLAP": ("cur_scan_non_overlap", float),
    "CURSCANCUMUMODE": ("cur_scan_cumu_mode", lambda v: v.upper()),
    "SCANRANGENONOVERLAP": ("scan_range_non_overlap", float),
    "FFTSIZE": ("fft_size", int),
    "XRES": ("x_res", int),
    "BDATAMIN": ("b_data_min", _boolean),
    "BDATAMAX": ("b_data_max", _boolean),
    "BDATAAVG": ("b_data_avg", _boolean),
    "BDATACUR": ("b_data_cur", _boolean),
    "PLTCOMPRESS": ("plt_compress", lambda v: v.upper()),
    "WINDOW": ("window", lambda v: "WIN.{}".format(v.upper())),
    "BPLTHEATMAP": ("b_plt_heatmap", _boolean),
    "BPLTLEVELS": ("b_plt_levels", _boolean),
    "PRGLOOPCNT": ("prg_loop_cnt", int),
    "PLTHIGHSNUMMARKERS": ("plt_highs_num_markers", int),
    "PLTHIGHSDELTA4MARKING": ("plt_highs_delta4marking", float),
    "PLTHIGHSPAUSE": ("plt_highs_pause", _boolean),
    "SAVESIGLVLS": ("save_sig_lvls", str),
    "ADJSIGLVLS": ("adj_sig_lvls", str),
    "BGRID": ("b_grid", _boolean),
    "BUSEPSD": ("b_use_psd", _boolean),
    "BSCANRANGEBASEDATAISRAW": ("b_scan_range_base_data_is_raw", _boolean),
    "ZEROSPANSAVEFILE": ("zero_span_save_file", str),
    "ZEROSPANPLAYFILE": ("zero_span_play_file", str),
    # New (no reference analog): MXU matmul precision for the DFT paths.
    "TPUPRECISION": ("tpu_precision", lambda v: _precision_name(v)),
    # The reference's own TODO (README.rst:608-611): bypass the outer K
    # bins of each displayed curscan (Nyquist-edge leakage).
    "TPUEDGESKIPBINS": ("tpu_edge_skip_bins", int),
}


def _precision_name(v: str) -> str:
    """Validate at parse time — a bad value would otherwise only surface
    at first kernel build on the TPU."""
    up = v.upper()
    if up not in ("DEFAULT", "HIGH", "HIGHEST"):
        raise CliError(f"tpuPrecision [{v}] not one of default|high|highest")
    return up

_RUNOPT_KEYMAP = {
    "TPUSOURCE": ("source", str),
    "TPUHEADLESS": ("headless", _boolean),
    "TPUMESHTIME": ("mesh_time", int),
    "TPUMESHBAND": ("mesh_band", int),
    "TPUPREFETCH": ("prefetch", _boolean),
    "TPUPROFILE": ("profile_dir", str),
    # Lowercase only the scheme: the png:<dir> form embeds a case-sensitive
    # directory path that must pass through untouched.
    "TPURENDERER": ("renderer", lambda v: (
        v[:4].lower() + v[4:] if v[:4].lower() == "png:" else v.lower())),
    # Checkpoint/resume: snapshot curves + waterfall on exit, resume on
    # start when the file matches the config (io/state.py).
    "TPUSTATEFILE": ("state_file", str),
    # Batched catch-up: K zero-span blocks per device dispatch (file/synth
    # sources; 0/1 keeps the serial one-block cadence).
    "TPUCATCHUP": ("catch_up", int),
    # Scan-mode render cadence: "sweep" (default, batched) or "band"
    # (reference behavior, kspecanal.py:670-688: redraw per retune band).
    "TPURENDEREVERY": ("render_every", lambda v: _render_every(v)),
    # Time-domain decimation preprocessor (the reference's TODO,
    # README.rst:612-622): capture at N*samplingRate, merge N adjacent
    # samples into one (+1 amplitude bit, effective band = samplingRate).
    "TPUDECIMATE": ("decimate", int),
    # Per-iteration wall-time prints (ZeroSpan:{i}:{dt} etc.).  Default
    # true matches the reference's unconditional prints
    # (kspecanal.py:462,519-522,722-724).
    "TPULOGITER": ("log_iter", _boolean),
}


def _render_every(v: str) -> str:
    lo = v.lower()
    if lo not in ("sweep", "band"):
        raise CliError(f"tpuRenderEvery [{v}] not one of sweep|band")
    return lo


def parse_args(argv: List[str]) -> Tuple[SpecConfig, RunOptions]:
    """Token-pair scan (kspecanal.py:813-911) -> finalized SpecConfig."""
    overrides = {}
    run = RunOptions()
    i = 0
    while i < len(argv):
        cur = argv[i].upper()
        if cur in _MODES:
            overrides["prg_mode"] = cur
        elif cur in _KEYMAP:
            i += 1
            if i >= len(argv):
                raise CliError(f"missing value for [{argv[i-1]}]")
            field, conv = _KEYMAP[cur]
            overrides[field] = conv(argv[i])
        elif cur in _RUNOPT_KEYMAP:
            i += 1
            if i >= len(argv):
                raise CliError(f"missing value for [{argv[i-1]}]")
            field, conv = _RUNOPT_KEYMAP[cur]
            setattr(run, field, conv(argv[i]))
        else:
            raise CliError(f"handle_args: Unknown argument [{cur}]")
        i += 1
    cfg = SpecConfig(**overrides).finalize()
    return cfg, run


def print_info(cfg: SpecConfig) -> None:
    """Effective-config echo (kspecanal.py:953-963)."""
    log_info(f" startFreq[{cfg.start_freq}] centerFreq[{cfg.center_freq}] "
             f"endFreq[{cfg.end_freq}]")
    log_info(f" samplingRate[{cfg.sampling_rate}], gain[{cfg.gain}], "
             f"bUsePSD[{cfg.b_use_psd}]")
    log_info(f" fullSize[{cfg.full_size}], fftSize[{cfg.fft_size}], "
             f"curScanCumuMode[{cfg.cur_scan_cumu_mode}], "
             f"window[{cfg.window}]")
    log_info(f" minAmp4Clip[{cfg.min_amp4clip}], "
             f"curScanNonOverlap[{cfg.cur_scan_non_overlap}], "
             f"scanRangeNonOverlap[{cfg.scan_range_non_overlap}], "
             f"bScanRangeBaseDataIsRaw[{cfg.b_scan_range_base_data_is_raw}]")
    log_info(f" prgMode [{cfg.prg_mode}], prgLoopCnt[{cfg.prg_loop_cnt}], "
             f"bPltLevels[{cfg.b_plt_levels}], "
             f"bPltHeatMap[{cfg.b_plt_heatmap}]")
    log_info(f" pltHighsNumMarkers[{cfg.plt_highs_num_markers}], "
             f"pltHighsDelta4Marking[{cfg.plt_highs_delta4marking}], "
             f"pltHighsPause[{cfg.plt_highs_pause}]")
    log_info(f" xRes [{cfg.x_res}], bGrid [{cfg.b_grid}], "
             f"pltCompress [{cfg.plt_compress}], "
             f"pltCompressHM [{cfg.plt_compress_hm}]")
    log_info(f" SaveSigLvls [{cfg.save_sig_lvls}], "
             f"AdjSigLvls [{cfg.adj_sig_lvls}]; "
             f"zeroSpanSaveFile[{cfg.zero_span_save_file}], "
             f"zeroSpanPlayFile[{cfg.zero_span_play_file}]")
    log_info(f" bDataMax [{cfg.b_data_max}], bDataMin [{cfg.b_data_min}], "
             f"bDataAvg[{cfg.b_data_avg}], bDataCur [{cfg.b_data_cur}]")


def make_source(cfg: SpecConfig, run: RunOptions):
    """The host source of ``run.source``; the on-device sources are
    :func:`make_device_source`'s."""
    from kspecanal_tpu_torch.io import sources
    if run.source == "synth":
        return sources.SynthIQSource(center_freq=cfg.center_freq,
                                     sample_rate=cfg.sampling_rate,
                                     gain=0.5, seed=None)
    if run.source.startswith("file:"):
        src, fallback = sources.make_file_source(
            run.source[5:], center_freq=cfg.center_freq,
            sample_rate=cfg.sampling_rate, gain=cfg.gain)
        if fallback is not None:
            log_info(f"native IQ stream unavailable ({fallback}); "
                     "buffered reader")
        return src
    if run.source == "rtlsdr":
        return sources.RtlSdrSource(center_freq=cfg.center_freq,
                                    sample_rate=cfg.sampling_rate,
                                    gain=cfg.gain)
    raise CliError(f"unknown tpuSource [{run.source}]")



def make_device_source(cfg, run: RunOptions, device):
    """The port's on-device source for ``tpuSource devicesynth`` (tone
    simulator) or ``devicenoise`` (u8 noise for soaking the session
    machinery), on ``device``; None for every other source, which
    :func:`make_source` builds."""
    if run.source == "devicesynth":
        return sources.DeviceSynthIQSource(center_freq=cfg.center_freq,
                                           sample_rate=cfg.sampling_rate,
                                           gain=0.5, device=device)
    if run.source == "devicenoise":
        return sources.DeviceNoiseIQSource(center_freq=cfg.center_freq,
                                           sample_rate=cfg.sampling_rate,
                                           gain=0.5, device=device)
    return None


def _mesh_of(run: RunOptions, device, mesh):
    """The session's mesh: ``mesh`` as given (its shape must be the run's
    ``tpuMeshTime`` x ``tpuMeshBand``), else one over the launched world
    where either is above 1, else None.  Returns ``(mesh, whether this
    call joined the world)``."""
    if mesh is not None:
        shape = tuple(mesh_mod.axis_size(mesh, a) for a in mesh_mod.AXES)
        if shape != (run.mesh_time, run.mesh_band):
            raise CliError(f"mesh {shape} is not tpuMeshTime x tpuMeshBand "
                           f"({run.mesh_time}, {run.mesh_band})")
        return mesh, False
    if run.mesh_time == 1 and run.mesh_band == 1:
        return None, False
    mesh_mod.init_distributed()
    return mesh_mod.make_mesh(run.mesh_time, run.mesh_band,
                              device_type=torch.device(device).type), True


def main(argv: Optional[List[str]] = None, device=None, mesh=None) -> int:
    """Run the CLI on ``device`` (default ``"cuda"``, which must exist;
    the CPU runs the kernels' plain versions only when asked for by
    ``device="cpu"``).  ``tpuMeshTime``/``tpuMeshBand`` above 1 join the
    world that torchrun launched, or run on ``mesh`` where the caller
    built one (a ``parallel.mesh.make_mesh`` DeviceMesh); each rank then
    runs on its mesh device, and only rank 0 prints, renders and writes."""
    cfg, run = parse_args(sys.argv[1:] if argv is None else argv)
    if device is None and mesh is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: kspecanal_tpu_torch runs on "
                               "the card (pass device='cpu' to run its "
                               "plain PyTorch path)")
        device = "cuda"
    try:
        mesh, joined = _mesh_of(run, device or "cuda", mesh)
    except mesh_mod.NoWorldError as e:
        log_info(f"ERROR: {e}")
        return 2
    done = None
    if mesh is not None:
        device = mesh_mod.rank_device(mesh)
        # the end-of-session barrier's own gloo group, with no practical
        # time limit: ranks a mode leaves idle (a mesh axis it does not
        # split) wait there as long as rank 0's session runs
        done = torch.distributed.new_group(
            backend="gloo", timeout=datetime.timedelta(days=365))
    root = mesh_mod.is_root(mesh)
    set_iter_logging(run.log_iter)
    if root:
        print_info(cfg)
    # The renderer first: a png: run without matplotlib fails before any
    # source is opened.
    renderer = None
    if root and run.renderer == "term":
        from kspecanal_tpu_torch.render_term import TerminalRenderer
        renderer = TerminalRenderer(cfg)
    elif root and run.renderer.startswith("png:"):
        # headless frame dumps: one PNG per iteration into the given dir
        # (matplotlib's ImportError propagates where it is missing)
        from kspecanal_tpu_torch.gui import MatplotlibRenderer
        renderer = MatplotlibRenderer(cfg, interactive=False,
                                      save_dir=run.renderer[4:])
    elif root and not run.headless and run.renderer == "gui":
        try:
            from kspecanal_tpu_torch.gui import MatplotlibRenderer
            renderer = MatplotlibRenderer(cfg)
        except Exception as e:  # no display / no matplotlib backend
            log_info(f"GUI unavailable ({e}); running headless")

    source = None
    sweep_prefetch = False
    if root and cfg.prg_mode != MODE_ZEROSPANPLAY:     # replay reads no IQ
        source = make_device_source(cfg, run, device)
        if source is None:
            source = make_source(cfg, run)
        if run.decimate > 1:
            source = sources.DecimatingSource(source, run.decimate)
            log_info(f"tpuDecimate: capturing at "
                     f"{cfg.sampling_rate * run.decimate:g} sps, merging "
                     f"{run.decimate} adjacent samples per output sample")
        if run.prefetch:
            if cfg.prg_mode == MODE_SCAN:
                # Every per-band retune would flush a block read-ahead; scan
                # mode reads whole sweeps ahead instead (SweepPrefetcher).
                sweep_prefetch = True
            elif hasattr(source, "read_device_batch"):
                # A device source makes its planes on the card: a host
                # read-ahead wrapper would only hide that path.
                log_info("tpuPrefetch: ignored for on-device sources")
            else:
                from kspecanal_tpu_torch.io.prefetch import PrefetchingSource
                source = PrefetchingSource(source, block_size=cfg.full_size)

    sess = sess_mod.Session(cfg, source, renderer, device=device, mesh=mesh,
                            state_file=run.state_file,
                            catch_up=run.catch_up,
                            sweep_prefetch=sweep_prefetch,
                            render_every=run.render_every)

    def _sigint(signum, stack):  # kspecanal.py:1118-1123
        log_info("sigint: quiting on user request...")
        sess.stop = True

    signal.signal(signal.SIGINT, _sigint)
    rc = 0
    try:
        with trace(run.profile_dir or None):
            sess_mod.do_run(sess)
    except FileNotFoundError as e:
        log_info(f"ERROR: {e}")
        rc = 1
    except pickle.UnpicklingError as e:
        log_info(f"ERROR: {cfg.zero_span_play_file} is not a kspecanal "
                 f"save stream ({e})")
        rc = 1
    finally:
        if source is not None:
            source.close()
        if root:
            sess.save_baseline()
            # Interactive-GUI contract: hold the final figure until a
            # keypress (kspecanal.py:1152-1155); only for a live window, so
            # headless, term and png runs never block scripted use.
            if renderer is not None and getattr(renderer, "interactive",
                                                False):
                renderer.hold_until_key()
            sess.timer.log_report()
    if mesh is not None:
        # rank 0's files are written before any rank leaves the world
        torch.distributed.barrier(group=done)
        if joined:
            torch.distributed.destroy_process_group()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
