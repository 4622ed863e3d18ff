"""Terminal renderer: levels sparkline + waterfall as ANSI blocks.

The reference is matplotlib-only; headless/SSH use means running blind (or
record-then-replay).  This renderer draws the same display products —
level curves, top-K peaks, waterfall history — as text, so live monitoring
works anywhere.  Selected with ``tpuRenderer term`` on the CLI.

A copy of ``kspecanal_tpu/render_term.py`` with ``Peak`` taken from the
port: the original imports ``kspecanal_tpu.ops.peaks``, whose package
imports JAX.  Views reach it as numpy arrays (``session.Session._emit``).
"""
from __future__ import annotations

import shutil
import sys
from typing import List, Optional

import numpy as np

from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.ops.peaks import Peak

_BLOCKS = " ▁▂▃▄▅▆▇█"
_SHADES = " .:-=+*#%@"


def _resample(vals: np.ndarray, width: int) -> np.ndarray:
    if len(vals) <= width:
        return vals
    cols = len(vals) // width
    return vals[: width * cols].reshape(width, cols).max(axis=1)


def _char_row(vals: np.ndarray, width: int, lo: float, hi: float,
              charset: str) -> str:
    """Map values to charset indices; -inf/NaN (LogNoGain of a zero bin)
    and lo==hi (flat first-iteration curves) render as the lowest glyph
    instead of poisoning the cast."""
    v = _resample(np.asarray(vals, np.float64), width)
    if not np.isfinite(lo) or not np.isfinite(hi):
        finite = v[np.isfinite(v)]
        lo = float(finite.min()) if finite.size else 0.0
        hi = float(finite.max()) if finite.size else 1.0
    span = max(hi - lo, 1e-9)
    scaled = np.nan_to_num((v - lo) / span, nan=0.0,
                           posinf=1.0, neginf=0.0)
    idx = np.clip(scaled * (len(charset) - 1), 0,
                  len(charset) - 1).astype(int)
    return "".join(charset[i] for i in idx)


def sparkline(vals: np.ndarray, width: int, lo: float, hi: float) -> str:
    return _char_row(vals, width, lo, hi, _BLOCKS)


def shade_row(vals: np.ndarray, width: int, lo: float, hi: float) -> str:
    return _char_row(vals, width, lo, hi, _SHADES)


class TerminalRenderer:
    """Session renderer callback: redraws a compact text dashboard."""

    def __init__(self, cfg: SpecConfig, width: Optional[int] = None,
                 waterfall_rows: int = 12, stream=None):
        self.cfg = cfg
        self.width = width or max(40, shutil.get_terminal_size().columns - 12)
        self.wf_rows = waterfall_rows
        self.out = stream or sys.stdout

    def __call__(self, sess, view, peaks: List[Peak], iteration: int,
                 timestamp_str: Optional[str]):
        cfg = self.cfg
        w = self.width
        cur = np.asarray(view.cur_lvls, np.float64)
        finite = cur[np.isfinite(cur)]
        lo = (float(np.min(finite)) if finite.size else 0.0) - 1.0
        hi = (float(np.max(finite)) if finite.size else 1.0) + 1.0
        lines = []
        hdr = (f"iter {iteration}  [{cfg.start_freq/1e6:.3f} - "
               f"{cfg.end_freq/1e6:.3f} MHz]  "
               f"{lo + 1:.1f}..{hi - 1:.1f} dB")
        if timestamp_str:
            hdr += f"  t={timestamp_str}"
        lines.append(hdr)
        for name in ("max", "avg", "cur"):
            y = np.asarray(getattr(view, f"{name}_lvls"), np.float64)
            lines.append(f"{name:>3} |{sparkline(y, w, lo, hi)}|")
        if peaks:
            lines.append("peaks: " + "  ".join(
                f"{p.freq/1e6:.4f}MHz:{p.level:.1f}dB" for p in peaks[:5]))
        hm = np.asarray(view.heatmap, np.float64)
        n_rows = min(self.wf_rows, hm.shape[0])
        # newest rows last (ring order by iteration index)
        start = max(0, iteration - n_rows + 1)
        for r in range(start, iteration + 1):
            row = hm[r % hm.shape[0]]
            lines.append("wf  |" + shade_row(row, w, lo, hi) + "|")
        self.out.write("\n".join(lines) + "\n\n")
        self.out.flush()
