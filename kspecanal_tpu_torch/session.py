"""Session loops of the port — the zero-span and scan parts of
``kspecanal_tpu.session`` (``do_run``, kspecanal.py:1126-1136) as a host
shell around the tensor pipeline.

A session loop pumps an IQ source into the mode's step functions on
``Session.device`` and hands numpy views to an optional renderer callback.
Cooperative stop mirrors the reference's ``cmd.stop`` flag checked at loop
tops (kspecanal.py:465); SIGINT wiring lives in cli.py.  ``zeroSpanSave``
records the spectra, ``zeroSpanPlay`` replays a recording through the
display fold, and ``tpuStateFile`` checkpoints the state a zero-span or
scan session leaves behind (``io/state.py``).  A renderer with
``apply_toggles`` (``gui.MatplotlibRenderer``) has its curve toggles folded
into the config at each step or sweep boundary of the unsharded loops.

With a mesh (``parallel/mesh.py``, one process a rank) the zero-span loop
splits each capture over the ``time`` ranks and the scan loop splits each
sweep's bands over the ``band`` ranks; rank 0 alone reads the source,
keeps the state, renders and writes the files, and the other ranks lend
their devices to the sharded curscans.  A mode whose axis is not split
runs on rank 0 alone.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from kspecanal_tpu_torch.config import (MODE_SCAN, MODE_ZEROSPAN,
                                        MODE_ZEROSPANPLAY, MODE_ZEROSPANSAVE,
                                        SpecConfig)
from kspecanal_tpu_torch.io.replay import (ZeroSpanPlayer, ZeroSpanRecorder,
                                           load_sig_lvls, save_sig_lvls)
from kspecanal_tpu_torch.io.sources import IQSource, split_u8_planes
from kspecanal_tpu_torch.utils.logging import log_info, log_iter, log_warn
from kspecanal_tpu_torch.utils.profiling import StageTimer, installed
from kspecanal_tpu_torch.io.prefetch import SweepPrefetcher
from kspecanal_tpu_torch.models import scan as scan_mod
from kspecanal_tpu_torch.models import zerospan as zs
from kspecanal_tpu_torch.ops.peaks import find_peaks
from kspecanal_tpu_torch.parallel import mesh as mesh_mod


class Session:
    """Run state of a mode: config, source, device, baseline, stop flag,
    timing."""

    def __init__(self, cfg: SpecConfig, source: Optional[IQSource] = None,
                 renderer: Optional[Callable] = None, *, device, mesh=None,
                 state_file: str = "", catch_up: int = 0,
                 sweep_prefetch: bool = False, render_every: str = "sweep"):
        self.cfg = cfg
        self.source = source
        self.renderer = renderer
        self.device = torch.device(device)
        # optional (time, band) DeviceMesh; rank 0 owns source and state
        self.mesh = mesh
        self.is_root = mesh_mod.is_root(mesh)
        # Batched catch-up: blocks per step in run_zero_span (tpuCatchUp K);
        # host staging is bounded per path by _catchup_block_cap.
        self.catch_up = max(0, min(int(catch_up), 65536))
        # Scan mode: acquire sweep k+1 on a worker thread while sweep k
        # computes (io/prefetch.SweepPrefetcher).
        self.sweep_prefetch = bool(sweep_prefetch)
        # Scan render cadence: "sweep" (one view per completed sweep) or
        # "band" (the reference's redraw after every band,
        # kspecanal.py:670-688).
        self.render_every = render_every
        self.stop = False            # cmd.stop analog (kspecanal.py:970)
        self.adj: Optional[np.ndarray] = None   # Fft.Adj baseline
        self.final_avg: Optional[np.ndarray] = None
        self.timer = StageTimer()    # host time by stage and wait site
        self.state_file = state_file  # checkpoint/resume (io/state)
        if cfg.adj_sig_lvls:
            self._load_baseline()

    # -- checkpoint / resume (io/state.py) --------------------------------
    def _resume_state(self, cfg: SpecConfig, kind: str):
        """The mode state restored from the checkpoint file onto
        ``self.device``, or None.  ``kind`` ('zerospan' | 'scan') keeps a
        session from resuming the other mode's state where the frequency
        fingerprints coincide (zero-span 92e6/2.4e6 == scan 90.8-93.2e6)."""
        import os
        from kspecanal_tpu_torch.io.state import load_state, state_path
        if not self.state_file or not os.path.exists(
                state_path(self.state_file)):
            return None
        try:
            st = load_state(self.state_file, cfg, kind=kind,
                            device=self.device)
        except Exception as e:  # corrupt/foreign file: start fresh
            log_warn(f"resume: unreadable checkpoint {self.state_file} "
                     f"({e}); starting fresh")
            return None
        if st is not None:
            log_info(f"resume: restored state from "
                     f"{state_path(self.state_file)}")
        return st

    def _checkpoint_state(self, state, cfg: SpecConfig):
        if self.state_file and state is not None:
            from kspecanal_tpu_torch.io.state import save_state, state_path
            save_state(self.state_file, state, cfg)
            log_info(f"checkpoint: saved state to "
                     f"{state_path(self.state_file)}")

    # -- baseline handling (kspecanal.py:736-768, :400-411) --------------
    def _load_baseline(self):
        cfg = self.cfg
        try:
            start, end, avg = load_sig_lvls(cfg.adj_sig_lvls)
        except Exception:
            log_warn(f"_load_siglvls: Failed... {cfg.adj_sig_lvls}")
            self.cfg = dataclasses.replace(cfg, adj_sig_lvls="")
            return
        if (start == cfg.start_freq) and (end == cfg.end_freq):
            log_info(f"_load_siglvls: success... {cfg.adj_sig_lvls}")
            self.adj = np.asarray(avg, np.float32)
        else:
            log_warn(f"_load_siglvls: savedRange[{start}-{end}] != "
                     f"curFreqRange[{cfg.start_freq}-{cfg.end_freq}]; disabled")

    def axis(self, name: str) -> int:
        """The mesh's size on axis ``name`` (1 without a mesh)."""
        return 1 if self.mesh is None else mesh_mod.axis_size(self.mesh, name)

    def save_baseline(self):
        if self.cfg.save_sig_lvls and self.final_avg is not None:
            save_sig_lvls(self.cfg.save_sig_lvls, self.cfg.start_freq,
                          self.cfg.end_freq, self.final_avg)
            log_info(f"_save_siglvls: success... {self.cfg.save_sig_lvls}")

    def _apply_pending_toggles(self, cfg: SpecConfig) -> SpecConfig:
        """Fold the renderer's pending toggles into the active config at a
        step or sweep boundary (the reference's buttons mutate shared state
        mid-loop, kspecanal.py:994-1053; here the config stays frozen for a
        step, and the next step runs with the new one).  Toggles touch only
        display and cumulate booleans, never the plan's geometry, so the
        scan drivers keep their ScanPlan and read-ahead."""
        if self.renderer is not None and hasattr(self.renderer,
                                                 "apply_toggles"):
            new_cfg = self.renderer.apply_toggles(cfg)
            if new_cfg != cfg:
                cfg = self.cfg = new_cfg
        return cfg

    def _emit(self, view, iteration: int, timestamp_str: Optional[str] = None,
              with_peaks: bool = True):
        """Hand the renderer a view of host numpy arrays (a ``ZeroSpanView``
        or ``ScanView``), with the peaks of the curve drawn last (cur, else
        avg, min, max; kspecanal.py:485-504) printed as the reference
        prints them (:250,:260).  The per-band scan redraw passes
        ``with_peaks=False``: the reference marks peaks once a sweep
        (:694-695)."""
        if self.renderer is None:
            return
        cfg = self.cfg
        with self.timer.wait("emit"):
            view = type(view)(*(v.cpu().numpy() for v in view))
        peaks = []
        if with_peaks and cfg.b_plt_levels:
            lvls = None
            for key, arr in (("b_data_max", view.max_lvls),
                             ("b_data_min", view.min_lvls),
                             ("b_data_avg", view.avg_lvls),
                             ("b_data_cur", view.cur_lvls)):
                if getattr(cfg, key):
                    lvls = arr
            if lvls is not None:
                freqs = view.x_freqs
                peaks = find_peaks(freqs, lvls, cfg.plt_highs_num_markers,
                                   cfg.plt_highs_delta4marking)
                delta = cfg.plt_highs_delta4marking * (freqs[-1] - freqs[0])
                print("PlotHighs: Freqs {} to {} : delta4Marking {} : "
                      "min {} max {}".format(freqs[0], freqs[-1], delta,
                                             np.min(lvls), np.max(lvls)))
                for p in peaks:
                    print("plotHighs:Marked: {}, {}".format(p.freq, p.level))
        self.renderer(self, view, peaks, iteration, timestamp_str)

    def _drain(self, state) -> None:
        """Read the final average back, which waits for every queued
        step."""
        with self.timer.wait("drain"):
            self.final_avg = state.fft_avg.cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# Zero-span (kspecanal.py:426-506)
# ---------------------------------------------------------------------------

def _to_device(sess: Session, re: np.ndarray, im: np.ndarray):
    """Host planes to ``sess.device``: pageable copies, which the host
    waits for."""
    with sess.timer.wait("upload"):
        return (torch.from_numpy(re).to(sess.device),
                torch.from_numpy(im).to(sess.device))


def run_zero_span(sess: Session, max_iters: Optional[int] = None
                  ) -> zs.ZeroSpanState:
    """The zero-span loop: one block per step at the reference's cadence,
    or ``catch_up`` blocks per step.  Sources with ``read_raw`` ship
    undecoded u8 planes (2 B/sample), which the curscan kernel decodes.
    A mesh with ``time > 1`` splits each block over the ``time`` ranks
    (:func:`_run_zero_span_sharded`); the other ranks return None."""
    cfg = sess.cfg
    sharded = sess.axis("time") > 1
    n = cfg.prg_loop_cnt if max_iters is None else max_iters
    if not sess.is_root:
        return _run_zero_span_sharded(sess, None, None, n) if sharded else None
    if sess.source is None:
        raise ValueError("zero-span needs an IQ source")
    sess.source.retune(cfg.center_freq, cfg.sampling_rate, cfg.gain)
    state = (sess._resume_state(cfg, "zerospan")
             or zs.init_state(cfg, sess.device))
    adj = (None if sess.adj is None
           else torch.as_tensor(sess.adj).to(sess.device))
    if sharded:
        return _run_zero_span_sharded(sess, state, adj, n)
    if sess.catch_up > 1 and sess.mesh is None:
        return _run_zero_span_catchup(sess, state, adj, n)
    raw_read = getattr(sess.source, "read_raw", None)
    prev = time.time()
    for i in range(n):
        if sess.stop:
            break
        with sess.timer.stage("step"):
            cur = time.time()
            log_iter("ZeroSpan:%s:%s", i, cur - prev)  # kspecanal.py:462
            prev = cur
            with sess.timer.stage("acquire", cfg.full_size):
                if raw_read is not None:
                    re, im = split_u8_planes(raw_read(cfg.full_size))
                else:
                    re, im = sess.source.read(cfg.full_size)
                re, im = _to_device(sess, re, im)
            if getattr(sess.source, "exhausted", False):
                # A non-wrapping file ran dry: finish this (padded) block,
                # stop.
                log_warn("zeroSpan: source exhausted; stopping")
                sess.stop = True
            with sess.timer.stage("dsp", cfg.full_size):
                if raw_read is not None:   # u8: the batched step at K=1
                    state, view = zs.zero_span_steps(state, re[None],
                                                     im[None], cfg, adj)
                else:
                    state, view = zs.zero_span_step(state, re, im, cfg, adj)
            with sess.timer.stage("render"):
                sess._emit(view, i)
            cfg = sess._apply_pending_toggles(cfg)
    sess._drain(state)
    sess._checkpoint_state(state, cfg)
    return state


def _run_zero_span_sharded(sess: Session, state, adj, n: int):
    """The serial loop with each block's sample axis split over the mesh's
    ``time`` ranks (``parallel/timeshard``, halo exchange inside); rank 0
    runs the display half on the replicated spectrum.  The block ships as
    float32 planes (the sharded body takes no u8), and rank 0's stop flag
    reaches every rank at the top of each iteration."""
    from kspecanal_tpu_torch.parallel.timeshard import curscan_time_sharded
    cfg, root = sess.cfg, sess.is_root
    prev = time.time()
    for i in range(n):
        if not mesh_mod.agree(not sess.stop, sess.mesh):
            break
        re = im = None
        if root:
            cur = time.time()
            log_iter("ZeroSpan:%s:%s", i, cur - prev)
            prev = cur
            with sess.timer.stage("acquire", cfg.full_size):
                re, im = _to_device(sess, *sess.source.read(cfg.full_size))
            if getattr(sess.source, "exhausted", False):
                log_warn("zeroSpan: source exhausted; stopping")
                sess.stop = True
        with sess.timer.stage("dsp", cfg.full_size):
            spec = curscan_time_sharded(re, im, cfg, sess.mesh)
            if root:
                state, view = zs.display_update(state, spec, cfg, adj)
        if root:
            with sess.timer.stage("render"):
                sess._emit(view, i)
    if root:
        sess._drain(state)
        sess._checkpoint_state(state, cfg)
    return state


# Host staging bound for ONE copy of one catch-up batch (bytes of IQ
# payload): raw u8 ships 2 B/sample, float32 planes 8 B/sample.  An
# on-device source stages nothing on the host and is bounded by the
# nominal catch_up cap alone.
_CATCHUP_STAGING_BYTES = 1 << 29


def _catchup_block_cap(sess: Session, cfg: SpecConfig) -> int:
    if getattr(sess.source, "read_device_batch", None) is not None:
        return sess.catch_up
    bps = 2 if getattr(sess.source, "read_raw", None) is not None else 8
    return max(1, min(sess.catch_up,
                      _CATCHUP_STAGING_BYTES // (bps * cfg.full_size)))


def _upload(sess: Session, copy_stream, re: np.ndarray, im: np.ndarray):
    """Host planes to ``sess.device`` from the acquisition thread.  On a
    CUDA device the planes are staged in pinned memory and copied with
    ``non_blocking=True`` on ``copy_stream``, so the copy overlaps the
    compute of the previous batch; the thread waits for its own copy
    before the pinned buffers are released.  The consumer must call
    :func:`_adopt` before it uses the tensors."""
    if copy_stream is None:
        return _to_device(sess, re, im)
    pinned = [torch.from_numpy(a).pin_memory() for a in (re, im)]
    with torch.cuda.stream(copy_stream):
        out = tuple(p.to(sess.device, non_blocking=True) for p in pinned)
        done = torch.cuda.Event()
        done.record(copy_stream)
    with sess.timer.wait("upload"):
        done.synchronize()
    return out


def _adopt(planes, copy_stream):
    """Mark tensors made on ``copy_stream`` as used by the current stream,
    so the allocator does not hand their memory back to the copy stream
    while this stream's kernels still read them."""
    if copy_stream is not None:
        for p in planes:
            p.record_stream(torch.cuda.current_stream(p.device))
    return planes


def _run_zero_span_catchup(sess: Session, state: zs.ZeroSpanState, adj,
                           n: int) -> zs.ZeroSpanState:
    """K blocks per step (``tpuCatchUp K``), emitting the last view of each
    batch; curve and ring math is exactly the serial fold.

    An on-device source (``read_device_batch``) makes each batch on the
    device, in the order of the compute: no worker thread.  Devicenoise's
    u8 planes reach the curscan kernel undecoded.  Host sources are
    double-buffered: batch k+1 is read, split and copied to the device
    (pinned, asynchronous, :func:`_upload`) on a worker thread while batch
    k computes."""
    from concurrent.futures import ThreadPoolExecutor

    cfg = sess.cfg
    dev_batch = getattr(sess.source, "read_device_batch", None)
    raw_read = getattr(sess.source, "read_raw", None)
    want_view = sess.renderer is not None
    copy_stream = (torch.cuda.Stream(sess.device)
                   if sess.device.type == "cuda" and dev_batch is None
                   else None)

    def acquire(k):
        if dev_batch is not None:
            return dev_batch(k, cfg.full_size)
        if raw_read is not None:
            with sess.timer.stage("acquire.read", k * cfg.full_size):
                raw = np.stack([raw_read(cfg.full_size) for _ in range(k)])
            with sess.timer.stage("acquire.split", k * cfg.full_size):
                re, im = split_u8_planes(raw)
        else:
            with sess.timer.stage("acquire.read", k * cfg.full_size):
                blocks = [sess.source.read(cfg.full_size) for _ in range(k)]
                re = np.stack([b[0] for b in blocks])
                im = np.stack([b[1] for b in blocks])
        with sess.timer.stage("acquire.xfer", k * cfg.full_size):
            return _upload(sess, copy_stream, re, im)

    ex = (None if dev_batch is not None
          else ThreadPoolExecutor(1, thread_name_prefix="catchup-acquire"))
    cap = _catchup_block_cap(sess, cfg)
    done = 0
    pending = None       # (future, k) staged ahead by the worker
    prev = time.time()
    try:
        while done < n and not sess.stop:
            with sess.timer.stage("step"):
                k = min(cap, n - done)
                cur = time.time()
                log_iter("ZeroSpan:%s:%s", done, cur - prev)
                prev = cur
                with sess.timer.stage("acquire", k * cfg.full_size):
                    if pending is not None:
                        with sess.timer.wait("acquire_worker"):
                            payload = pending[0].result()
                        k, pending = pending[1], None
                    else:
                        payload = acquire(k)
                    payload = _adopt(payload, copy_stream)
                if getattr(sess.source, "exhausted", False):
                    log_warn("zeroSpan: source exhausted; stopping")
                    sess.stop = True
                nxt = min(cap, n - done - k)
                if ex is not None and nxt > 0 and not sess.stop:
                    pending = (ex.submit(acquire, nxt), nxt)
                with sess.timer.stage("dsp", k * cfg.full_size):
                    state, view = zs.zero_span_steps(state, payload[0],
                                                     payload[1], cfg, adj,
                                                     want_view)
                done += k
                with sess.timer.stage("render"):
                    sess._emit(view, done - 1)
                new_cfg = sess._apply_pending_toggles(cfg)
                if new_cfg is not cfg:
                    cfg = new_cfg
                    want_view = sess.renderer is not None
    finally:
        if pending is not None:
            pending[0].cancel()
        if ex is not None:
            ex.shutdown(wait=True)
    # The final read waits for every queued step: its own wait site, so
    # the tail shows in the accounting.
    sess._drain(state)
    sess._checkpoint_state(state, cfg)
    return state


def run_zero_span_save(sess: Session, max_iters: Optional[int] = None) -> int:
    """Record mode (kspecanal.py:509-526): no display work; the spectra of
    ``tpuCatchUp`` blocks (8 without it, staging-bounded like the catch-up
    loop) go through one ``curscan_auto_batched`` call a chunk, and each
    frame is written with its own capture time.  Sources with ``read_raw``
    ship u8 planes, which the curscan kernel decodes.  Returns the frames
    written."""
    from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched

    cfg = sess.cfg
    if sess.source is None:
        raise ValueError("zeroSpanSave needs an IQ source")
    sess.source.retune(cfg.center_freq, cfg.sampling_rate, cfg.gain)
    n = cfg.prg_loop_cnt if max_iters is None else max_iters
    chunk = _catchup_block_cap(sess, cfg) if sess.catch_up > 1 else 8
    raw_read = getattr(sess.source, "read_raw", None)
    copy_stream = (torch.cuda.Stream(sess.device)
                   if sess.device.type == "cuda" else None)
    written = 0
    prev = time.time()
    with ZeroSpanRecorder(cfg.zero_span_save_file, cfg.center_freq,
                          cfg.sampling_rate, cfg.gain) as rec:
        while written < n and not sess.stop:
            k = min(chunk, n - written)
            cur = time.time()
            # One line a chunk, the counterpart of the reference's line a
            # frame (kspecanal.py:519-522).
            log_iter("ZeroSpanSave:%s:%s", written, cur - prev)
            prev = cur
            with sess.timer.stage("acquire", k * cfg.full_size):
                # Each frame keeps its own capture time (kspecanal.py:516-
                # 525), so a replay's time axis does not step by chunks.
                blocks, stamps = [], []
                for _ in range(k):
                    blocks.append(raw_read(cfg.full_size)
                                  if raw_read is not None
                                  else sess.source.read(cfg.full_size))
                    stamps.append(time.time())
                    if getattr(sess.source, "exhausted", False):
                        log_warn("zeroSpanSave: source exhausted; stopping")
                        sess.stop = True
                        k = len(blocks)
                        break
                if raw_read is not None:
                    re, im = split_u8_planes(np.stack(blocks))
                else:
                    re = np.stack([b[0] for b in blocks])
                    im = np.stack([b[1] for b in blocks])
                planes = _adopt(_upload(sess, copy_stream, re, im),
                                copy_stream)
            with sess.timer.stage("dsp", k * cfg.full_size):
                spectra = curscan_auto_batched(planes[0], planes[1], cfg)
            with sess.timer.stage("persist"):
                for ts, spec in zip(stamps, spectra.cpu().numpy().astype(
                        np.float64)):
                    rec.append(spec, timestamp=ts)
            written += k
    return written


def run_zero_span_play(sess: Session, max_iters: Optional[int] = None
                       ) -> Optional[zs.ZeroSpanState]:
    """Replay mode (kspecanal.py:530-564): the frames are recorded linear
    spectra, so only the display half of the step runs
    (``zs.display_updates``), ``tpuCatchUp`` frames a batch (1 without
    it), rendered at each batch's last frame with its timestamp.  The file
    header overrides fC/fS/gain with a warning (kspecanal.py:536-542), and
    the recorded frame length overrides ``fftSize`` before the staging cap
    is derived."""
    cfg = sess.cfg
    player = ZeroSpanPlayer(cfg.zero_span_play_file)
    h = player.header
    if (h.center_freq != cfg.center_freq
            or h.sampling_rate != cfg.sampling_rate or h.gain != cfg.gain):
        log_warn(f"zeroSpanPlay:updating: fC[{h.center_freq}] "
                 f"fS[{h.sampling_rate}] gain[{h.gain}]")
    cfg = sess.cfg = dataclasses.replace(
        cfg, prg_mode=MODE_ZEROSPAN, center_freq=h.center_freq,
        sampling_rate=h.sampling_rate, gain=h.gain,
        start_freq=None, end_freq=None).finalize()
    state = None
    adj = (None if sess.adj is None
           else torch.as_tensor(sess.adj).to(sess.device))
    n = cfg.prg_loop_cnt if max_iters is None else max_iters
    chunk = max(1, sess.catch_up)
    want_view = sess.renderer is not None
    i = 0
    with player:
        frames = player.frames()
        while i < n and not sess.stop:
            batch = []
            if state is None:
                # The header carries fC/fS/gain but not fftSize
                # (kspecanal.py:512-514): the first frame's length sets it.
                first = next(frames, None)
                if first is None:
                    break
                f0 = np.asarray(first[1], np.float32)
                if len(f0) != cfg.fft_size:
                    log_warn(f"zeroSpanPlay: fftSize[{cfg.fft_size}] -> "
                             f"recorded frame length [{len(f0)}]")
                    cfg = sess.cfg = dataclasses.replace(
                        cfg, fft_size=len(f0),
                        x_res=min(cfg.x_res, len(f0))).finalize()
                state = zs.init_state(cfg, sess.device)
                batch.append((first[0], f0))
            cap = max(1, min(chunk,
                             _CATCHUP_STAGING_BYTES // (4 * cfg.fft_size)))
            while len(batch) < min(cap, n - i):
                nxt = next(frames, None)
                if nxt is None:
                    break
                batch.append((nxt[0], np.asarray(nxt[1], np.float32)))
            if not batch:
                break
            k = len(batch)
            with sess.timer.stage("dsp", k * cfg.fft_size):
                spec = torch.from_numpy(np.stack([f for _, f in batch]))
                state, view = zs.display_updates(
                    state, spec.to(sess.device), cfg, adj, want_view)
            i += k
            with sess.timer.stage("render"):
                sess._emit(view, i - 1,
                           ZeroSpanPlayer.format_timestamp(batch[-1][0]))
            new_cfg = sess._apply_pending_toggles(cfg)
            if new_cfg is not cfg:
                cfg = new_cfg
                want_view = sess.renderer is not None
    if state is not None:
        sess._drain(state)
    return state


# ---------------------------------------------------------------------------
# Scan (kspecanal.py:568-732)
# ---------------------------------------------------------------------------

# Sweeps per step in scan catch-up (see _run_scan_catchup).
_SCAN_BATCH_CAP = 128


def _acquire_sweep_walk(source: IQSource, cfg: SpecConfig,
                        plan: scan_mod.ScanPlan, read_band, dummy_band):
    """The per-band retune/read walk (sentinel semantics,
    kspecanal.py:630-639): retune each band, read with ``read_band`` on
    success or substitute ``dummy_band()`` on a failed retune.  Returns
    ``(per-band payloads, oks (B,), exhausted)``."""
    out, oks = [], []
    for b in plan.bands:
        ok = source.retune(b.center_freq, cfg.sampling_rate, cfg.gain)
        if ok:
            payload = read_band()
        else:
            log_warn(f"_scanRange: Dummy data for "
                     f"{b.center_freq - cfg.sampling_rate/2} to "
                     f"{b.center_freq + cfg.sampling_rate/2}")
            payload = dummy_band()
        out.append(payload)
        oks.append(ok)
    return out, np.asarray(oks), bool(getattr(source, "exhausted", False))


def acquire_sweep(source: IQSource, cfg: SpecConfig,
                  plan: scan_mod.ScanPlan):
    """One sweep's IQ on the host: ``(re (B, full) f32, im, oks (B,),
    exhausted)`` as numpy, so a read-ahead thread can produce it."""
    pairs, oks, exhausted = _acquire_sweep_walk(
        source, cfg, plan,
        read_band=lambda: source.read(cfg.full_size),
        dummy_band=lambda: (np.zeros(cfg.full_size, np.float32),
                            np.zeros(cfg.full_size, np.float32)))
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
            oks, exhausted)


def acquire_sweep_raw(source: IQSource, cfg: SpecConfig,
                      plan: scan_mod.ScanPlan):
    """The u8 variant of :func:`acquire_sweep` for sources with
    ``read_raw``: undecoded u8 planes ``(re (B, full) u8, im, oks,
    exhausted)``, split on the host; the kernels decode in their loads.  A
    failed retune fills 127 bytes (decodes to zero; the sentinel keys off
    ``oks``, kspecanal.py:637-639)."""
    raws, oks, exhausted = _acquire_sweep_walk(
        source, cfg, plan,
        read_band=lambda: source.read_raw(cfg.full_size),
        dummy_band=lambda: np.full(2 * cfg.full_size, 127, np.uint8))
    re, im = split_u8_planes(np.stack(raws))
    return re, im, oks, exhausted


def _sweep_acquirer(source: IQSource):
    """``acquire_sweep_raw`` for sources with ``read_raw``, else
    ``acquire_sweep``."""
    if getattr(source, "read_raw", None) is not None:
        return acquire_sweep_raw
    return acquire_sweep


_plan_cache: dict = {}


def make_plan_cached(cfg: SpecConfig) -> scan_mod.ScanPlan:
    plan = _plan_cache.get(cfg)
    if plan is None:
        plan = _plan_cache[cfg] = scan_mod.make_scan_plan(cfg)
    return plan


def run_scan(sess: Session, max_sweeps: Optional[int] = None
             ) -> scan_mod.ScanState:
    """The scan loop: one sweep per step at the reference's cadence (per
    band with ``render_every == "band"``), or ``catch_up`` sweeps per step.
    Sources with ``read_raw`` ship u8 planes; ``sweep_prefetch`` reads
    whole sweeps ahead on a worker thread.  A mesh with ``band > 1``
    splits each sweep's bands over the ``band`` ranks
    (:func:`_run_scan_sharded`); the other ranks return None."""
    cfg = sess.cfg
    sharded = sess.axis("band") > 1
    plan = make_plan_cached(cfg)
    n = cfg.prg_loop_cnt if max_sweeps is None else max_sweeps
    if not sess.is_root:
        return (_run_scan_sharded(sess, None, None, plan, n) if sharded
                else None)
    if sess.source is None:
        raise ValueError("scan needs an IQ source")
    state = (sess._resume_state(cfg, "scan")
             or scan_mod.init_state(cfg, plan, sess.device))
    adj = (None if sess.adj is None
           else torch.as_tensor(sess.adj).to(sess.device))
    band_cadence = sess.render_every == "band" and sess.renderer is not None
    if sharded:
        if band_cadence:
            log_warn("tpuRenderEvery band is not available with a "
                     "band-sharded mesh (the sweep is one collective step); "
                     "rendering per sweep")
        return _run_scan_sharded(sess, state, adj, plan, n)
    if sess.catch_up > 1:
        if not band_cadence:
            return _run_scan_catchup(sess, state, adj, plan, n)
        log_warn("tpuRenderEvery band: ignoring tpuCatchUp "
                 f"{sess.catch_up} (per-band redraw needs the serial "
                 "sweep loop)")
    acquire = _sweep_acquirer(sess.source)
    pf = None
    if sess.sweep_prefetch:
        pf = SweepPrefetcher(sess.source, cfg, plan, acquire, limit=n)
    try:
        return _run_scan_loop(sess, state, adj, plan, n,
                              pf.get if pf is not None
                              else lambda: acquire(sess.source, cfg, plan))
    finally:
        if pf is not None:
            pf.close()


def _run_scan_loop(sess: Session, state: scan_mod.ScanState, adj,
                   plan: scan_mod.ScanPlan, n: int,
                   next_sweep: Callable) -> scan_mod.ScanState:
    cfg = sess.cfg
    samples = plan.num_bands * cfg.full_size
    prev = time.time()
    for i in range(n):
        if sess.stop:
            break
        cur = time.time()
        log_iter("scanRange:%s:%s", i, cur - prev)  # kspecanal.py:723
        prev = cur
        with sess.timer.stage("acquire", samples):
            sweep = next_sweep()
            re, im = _to_device(sess, sweep[0], sweep[1])
            oks = torch.from_numpy(sweep[2]).to(sess.device)
        if sweep[-1]:
            log_warn("scanRange: source exhausted; stopping after this sweep")
            sess.stop = True
        if sess.render_every == "band" and sess.renderer is not None:
            # The reference's cadence: redraw the curves after every band
            # (kspecanal.py:670-688).  The band curscans still run as one
            # batched call; only the stitch steps band by band.
            with sess.timer.stage("dsp", samples):
                spectra = scan_mod.band_spectra(re, im, oks, cfg)
            curves = (state.fft_cur, state.fft_max, state.fft_min,
                      state.fft_avg)
            first_sweep = state.sweep == 0
            for b, pr in zip(plan.bands, spectra):
                with sess.timer.stage("dsp"):
                    curves = scan_mod.band_stitch(curves, pr, b, cfg,
                                                  first_sweep)
                    view = scan_mod.curves_view(curves, state.heatmap, adj,
                                                cfg, plan)
                with sess.timer.stage("render"):
                    sess._emit(view, i, with_peaks=False)
            state = scan_mod.finish_sweep(state, curves, cfg, adj)
        else:
            with sess.timer.stage("dsp", samples):
                state = scan_mod.sweep_step(state, re, im, oks, cfg, plan,
                                            adj)
        if sess.renderer is not None:
            with sess.timer.stage("render"):
                sess._emit(scan_mod.scan_view(state, cfg, plan, adj), i)
        # The Max/Min toggles reach the sweep fold itself (the reference
        # reads bDataMax/bDataMin per band, kspecanal.py:651-662).
        cfg = sess._apply_pending_toggles(cfg)
    sess._drain(state)
    sess._checkpoint_state(state, cfg)
    return state


def _run_scan_sharded(sess: Session, state, adj, plan: scan_mod.ScanPlan,
                      n: int):
    """The serial sweep loop with the bands split over the mesh's ``band``
    ranks (``parallel/bandshard``); rank 0 acquires (float32 planes: the
    sharded body takes no u8; with ``sweep_prefetch`` on its read-ahead
    thread), stitches and renders, and its stop flag reaches every rank at
    the top of each sweep."""
    from kspecanal_tpu_torch.parallel.bandshard import band_spectra_sharded
    cfg, root = sess.cfg, sess.is_root
    samples = plan.num_bands * cfg.full_size
    pf = (SweepPrefetcher(sess.source, cfg, plan, acquire_sweep, limit=n)
          if root and sess.sweep_prefetch else None)
    prev = time.time()
    try:
        for i in range(n):
            if not mesh_mod.agree(not sess.stop, sess.mesh):
                break
            re = im = oks = None
            if root:
                cur = time.time()
                log_iter("scanRange:%s:%s", i, cur - prev)
                prev = cur
                with sess.timer.stage("acquire", samples):
                    sweep = (pf.get() if pf is not None
                             else acquire_sweep(sess.source, cfg, plan))
                    re, im = _to_device(sess, sweep[0], sweep[1])
                    oks = torch.from_numpy(sweep[2]).to(sess.device)
                if sweep[-1]:
                    log_warn("scanRange: source exhausted; stopping after "
                             "this sweep")
                    sess.stop = True
            with sess.timer.stage("dsp", samples):
                spectra = band_spectra_sharded(re, im, oks, cfg, plan,
                                               sess.mesh)
                if root:
                    state = scan_mod.stitch(state, spectra, cfg, plan, adj)
            if root and sess.renderer is not None:
                with sess.timer.stage("render"):
                    sess._emit(scan_mod.scan_view(state, cfg, plan, adj), i)
    finally:
        if pf is not None:
            pf.close()
    if root:
        sess._drain(state)
        sess._checkpoint_state(state, cfg)
    return state


def _run_scan_catchup(sess: Session, state: scan_mod.ScanState, adj,
                      plan: scan_mod.ScanPlan, n: int) -> scan_mod.ScanState:
    """S sweeps per step (``tpuCatchUp S``, at most ``_SCAN_BATCH_CAP``:
    one sweep stages B bands, and S <= 128 keeps the gathered stitch),
    rendering once per batch; the math equals the serial sweep fold.  With
    ``sweep_prefetch`` the sweeps of batch k+1 are acquired on the
    read-ahead thread while batch k computes."""
    cfg = sess.cfg
    if sess.catch_up > _SCAN_BATCH_CAP:
        log_warn(f"scan mode batches at most {_SCAN_BATCH_CAP} sweeps per "
                 f"step (tpuCatchUp {sess.catch_up} requested)")
    acquire = _sweep_acquirer(sess.source)
    pf = None
    if sess.sweep_prefetch:
        pf = SweepPrefetcher(sess.source, cfg, plan, acquire,
                             depth=max(2, sess.catch_up), limit=n)
    done = 0
    prev = time.time()
    try:
        while done < n and not sess.stop:
            s = min(sess.catch_up, _SCAN_BATCH_CAP, n - done)
            samples = s * plan.num_bands * cfg.full_size
            cur = time.time()
            log_iter("scanRange:%s:%s", done, cur - prev)
            prev = cur
            with sess.timer.stage("acquire", samples):
                if pf is not None:
                    sweeps = [pf.get() for _ in range(s)]
                else:
                    sweeps = [acquire(sess.source, cfg, plan)
                              for _ in range(s)]
                re, im = _to_device(sess, np.stack([x[0] for x in sweeps]),
                                    np.stack([x[1] for x in sweeps]))
                oks = torch.from_numpy(
                    np.stack([x[2] for x in sweeps])).to(sess.device)
            if any(x[-1] for x in sweeps):
                log_warn("scanRange: source exhausted; stopping after "
                         "this batch")
                sess.stop = True
            with sess.timer.stage("dsp", samples):
                state = scan_mod.sweep_steps(state, re, im, oks, cfg, plan,
                                             adj)
            done += s
            if sess.renderer is not None:
                with sess.timer.stage("render"):
                    sess._emit(scan_mod.scan_view(state, cfg, plan, adj),
                               done - 1)
            cfg = sess._apply_pending_toggles(cfg)
    finally:
        if pf is not None:
            pf.close()
    sess._drain(state)
    sess._checkpoint_state(state, cfg)
    return state


# ---------------------------------------------------------------------------
# Dispatch (do_run, kspecanal.py:1126-1136)
# ---------------------------------------------------------------------------

def do_run(sess: Session, max_iters: Optional[int] = None):
    """Run the session's mode.  Record and replay split nothing: with a
    mesh they run on rank 0 alone."""
    mode = sess.cfg.prg_mode
    if mode in (MODE_ZEROSPANSAVE, MODE_ZEROSPANPLAY) and not sess.is_root:
        return None
    run = {MODE_SCAN: run_scan, MODE_ZEROSPANSAVE: run_zero_span_save,
           MODE_ZEROSPANPLAY: run_zero_span_play}.get(mode, run_zero_span)
    # Wait sites without a session handle record into this session's timer.
    with installed(sess.timer):
        return run(sess, max_iters)
