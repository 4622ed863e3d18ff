"""Command-line entry point of the port: the reference's spelling of
``KEY value`` token pairs, parsed by ``kspecanal_tpu.cli.parse_args`` (no new
token), run on a CUDA device through ``kspecanal_tpu_torch.session``.

    python -m kspecanal_tpu_torch zeroSpan centerFreq 92e6 fftSize 2048 \
        window kaiser curScanNonOverlap 0.5 tpuSource synth tpuHeadless true
    python -m kspecanal_tpu_torch fmScan tpuSource synth tpuHeadless true
    python -m kspecanal_tpu_torch quickFullScan tpuSource synth \
        tpuCatchUp 16 tpuPrefetch true tpuHeadless true
"""
from __future__ import annotations

import signal
import sys
from typing import List, Optional

import torch

from kspecanal_tpu.cli import RunOptions, make_source, parse_args, print_info
from kspecanal_tpu.config import MODE_SCAN
from kspecanal_tpu.utils.logging import log_info, set_iter_logging
from kspecanal_tpu_torch import session as sess_mod
from kspecanal_tpu_torch.io import sources
from kspecanal_tpu_torch.utils.profiling import trace


def make_device_source(cfg, run: RunOptions, device):
    """The port's on-device source for ``tpuSource devicesynth`` (tone
    simulator) or ``devicenoise`` (u8 noise for soaking the session
    machinery), on ``device``; None for every other source, which
    ``kspecanal_tpu.cli.make_source`` builds."""
    if run.source == "devicesynth":
        return sources.DeviceSynthIQSource(center_freq=cfg.center_freq,
                                           sample_rate=cfg.sampling_rate,
                                           gain=0.5, device=device)
    if run.source == "devicenoise":
        return sources.DeviceNoiseIQSource(center_freq=cfg.center_freq,
                                           sample_rate=cfg.sampling_rate,
                                           gain=0.5, device=device)
    return None


def _check_ported(run: RunOptions) -> None:
    """Refuse run options whose machinery is not ported yet, before any
    source is built."""
    if run.state_file:
        raise sess_mod.not_ported("tpuStateFile", sess_mod.TODO_STATE)
    if run.mesh_time > 1 or run.mesh_band > 1:
        raise sess_mod.not_ported("tpuMeshTime / tpuMeshBand",
                                  sess_mod.TODO_MULTI_GPU)
    if run.renderer.startswith("png:"):
        raise sess_mod.not_ported("tpuRenderer png:", sess_mod.TODO_GUI)


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run the CLI on ``device`` (default ``"cuda"``, which must exist;
    the CPU runs the kernels' plain versions only when asked for by
    ``device="cpu"``)."""
    cfg, run = parse_args(sys.argv[1:] if argv is None else argv)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: kspecanal_tpu_torch runs on "
                               "the card (pass device='cpu' to run its "
                               "plain PyTorch path)")
        device = "cuda"
    _check_ported(run)
    set_iter_logging(run.log_iter)
    print_info(cfg)
    source = make_device_source(cfg, run, device)
    if source is None:
        source = make_source(cfg, run)
    if run.decimate > 1:
        from kspecanal_tpu.io.sources import DecimatingSource
        source = DecimatingSource(source, run.decimate)
        log_info(f"tpuDecimate: capturing at "
                 f"{cfg.sampling_rate * run.decimate:g} sps, merging "
                 f"{run.decimate} adjacent samples per output sample")
    sweep_prefetch = False
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
            from kspecanal_tpu.io.prefetch import PrefetchingSource
            source = PrefetchingSource(source, block_size=cfg.full_size)

    renderer = None
    if run.renderer == "term":
        from kspecanal_tpu_torch.render_term import TerminalRenderer
        renderer = TerminalRenderer(cfg)
    elif not run.headless and run.renderer == "gui":
        log_info("GUI renderer not ported (ROADMAP.md 'Still to port' item "
                 f"{sess_mod.TODO_GUI}); running headless")

    sess = sess_mod.Session(cfg, source, renderer, device=device,
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
    finally:
        source.close()
        sess.save_baseline()
        sess.timer.log_report()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
