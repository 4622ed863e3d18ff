"""Runner of the zero-span catch-up session over a capture on the device.

The timed entry is ``kspecanal_tpu_torch.session.do_run`` on
``Session(cfg, source, renderer=None, device, catch_up=K)``, which runs
``_run_zero_span_catchup``: each step takes the next K capture blocks
from the source undecoded, ``models/zerospan.zero_span_steps`` computes
their spectra (``ops/spectrum.curscan_auto_batched``) and folds them into
the display state (``display_updates``).  The session's own drain reads
the final average back and so closes the window on all queued work.

What the comparison holds against the plain reference (``reference.py``):
the spectra of the window's last step and of a few early steps drawn from
the seed, which the program computed in the window and which a thin
wrapper keeps; and the final state: the max, min, average and current
curves, the heatmap ring and its index, and the count of blocks folded
against the count handed out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import reference
from portbench.capture import CaptureSource, deadline_hook, make_capture

_ZS = "kspecanal_tpu_torch.models.zerospan"


@dataclasses.dataclass
class Run:
    cfg: object                 # the program's SpecConfig
    geometry: reference.Geometry
    device: torch.device
    re: torch.Tensor
    im: torch.Tensor
    batch: int                  # blocks a step (tpuCatchUp)
    first: int                  # capture block of the window's first step
    kept_steps: Tuple[int, ...]
    limits: Dict[str, float]
    state: object = None
    handed: int = 0
    kept: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0


def prepare(cell, seed: int, device, precision: Optional[str] = None,
            traffic: Optional[Dict] = None,
            limits: Optional[Dict[str, float]] = None) -> Run:
    """Make the capture from ``seed`` on ``device`` and warm up a short
    session of the cell's shapes.  ``precision`` runs the configuration at
    another ``tpuPrecision`` (a control); ``traffic`` replaces the cell's
    mix and ``limits`` the configuration's (tests on the CPU)."""
    from kspecanal_tpu_torch import session
    from kspecanal_tpu_torch.config import SpecConfig
    from kspecanal_tpu_torch.utils.logging import set_iter_logging

    traffic = traffic or cell.traffic
    set_iter_logging(bool(traffic.get("log_iter", False)))
    spec = dict(cell.config["spec"])
    if precision is not None:
        spec["tpu_precision"] = precision
    cfg = SpecConfig(**spec).finalize()
    g = reference.geometry(spec)
    if (g.full_size, g.starts, g.x_res) != (cfg.full_size,
                                            cfg.window_starts, cfg.x_res):
        raise ValueError("the reference and the program derive different "
                         "sizes from the configuration")
    device = torch.device(device)
    batch = int(traffic["step_samples"]) // g.full_size
    re, im = make_capture(spec, traffic, g, seed, device)
    rng = random.Random(seed)
    first = rng.randrange(re.shape[0] // batch) * batch
    kept = tuple(sorted(rng.sample(range(1, int(traffic["kept_from"])),
                                   int(traffic["kept_steps"]))))
    run = Run(cfg, g, device, re, im, batch, first, kept,
              dict(limits or cell.config["guarantee"]["limits"]))
    warm = session.Session(cfg, CaptureSource(re, im), device=device,
                           catch_up=batch)
    session.do_run(warm, max_iters=int(traffic["warm_steps"]) * batch)
    return run


class _Keeper:
    """Keeps the spectra that ``curscan_auto_batched`` returns at the
    window's steps ``steps`` and its last step."""

    def __init__(self, steps):
        self.steps = set(steps)
        self.calls = 0
        self.kept: Dict[int, torch.Tensor] = {}
        self.last: Optional[Tuple[int, torch.Tensor]] = None

    @contextlib.contextmanager
    def installed(self):
        import importlib
        zs = importlib.import_module(_ZS)
        orig = zs.curscan_auto_batched

        def keep(iq_re, iq_im, cfg):
            out = orig(iq_re, iq_im, cfg)
            if self.calls in self.steps:
                self.kept[self.calls] = out
            self.last = (self.calls, out)
            self.calls += 1
            return out
        zs.curscan_auto_batched = keep
        try:
            yield
        finally:
            zs.curscan_auto_batched = orig


def window(run: Run, seconds: float, profiler=None,
           spans: Optional[Dict[str, str]] = None) -> Dict[str, float]:
    """The timed session: from its start until the drain after the first
    step asked for ``seconds`` or more in; returns the end-to-end values
    it measures.  ``profiler`` (a source hook) and ``spans`` trace it."""
    from kspecanal_tpu_torch import session
    from portbench import tracing

    source = CaptureSource(run.re, run.im, run.first)
    sess = session.Session(run.cfg, source, device=run.device,
                           catch_up=run.batch)
    keeper = _Keeper(run.kept_steps)
    traced = (tracing.spans(spans) if spans
              else contextlib.nullcontext())
    with keeper.installed(), traced:
        t0 = time.perf_counter()
        source.hooks.append(deadline_hook(
            t0 + seconds, lambda: setattr(sess, "stop", True)))
        if profiler is not None:
            source.hooks.append(profiler)
        state = session.do_run(sess, max_iters=1 << 60)
        run.seconds = time.perf_counter() - t0
    run.state, run.handed = state, source.handed
    run.kept = dict(keeper.kept)
    if keeper.last is not None:
        run.kept[keeper.last[0]] = keeper.last[1]
    return {"capture_msamp_s":
            run.handed * run.geometry.full_size / run.seconds / 1e6}


def trace_cell(run: Run) -> Dict:
    """The cell's numbers that the per-layer readers use."""
    g = run.geometry
    return {"fft_size": g.fft_size, "num_windows": g.num_windows,
            "full_size": g.full_size, "batch": run.batch,
            "plane_bytes": run.re.element_size()}


def counts(run: Run) -> Tuple[int, int]:
    """Blocks handed to the session in the window, and how many of them
    its state does not count as folded."""
    return run.handed, abs(run.handed - int(run.state.iteration))


def check(run: Run) -> Dict[str, Tuple[float, float]]:
    """Each number compared, with its limit, once the window has closed."""
    st, g = run.state, run.geometry
    blocks = run.re.shape[0]
    kept: List[Tuple[np.ndarray, torch.Tensor]] = [
        ((run.first + step * run.batch + np.arange(run.batch)) % blocks, out)
        for step, out in sorted(run.kept.items())]
    run.kept = {}
    want, worst = reference.session_state(run.re, run.im, g, run.first,
                                          run.handed, kept)
    curves = [(st.fft_cur, want.fft_cur), (st.heatmap, want.heatmap)]
    curves += [(got, ref) for got, ref in ((st.fft_max, want.fft_max),
                                           (st.fft_min, want.fft_min),
                                           (st.fft_avg, want.fft_avg))
               if ref is not None]
    lim = run.limits
    return {
        "spectra_rel_err": (worst, lim["spectra_rel_err"]),
        "display_db_err": (max(reference.db_err(a, b) for a, b in curves),
                           lim["display_db_err"]),
        "hm_index_err": (float(abs(int(st.hm_index) - want.hm_index)), 0.0),
        "blocks_err": (float(abs(run.handed - int(st.iteration))), 0.0),
    }
