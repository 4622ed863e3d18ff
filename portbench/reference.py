"""The plain reference of a zero-span session, in float64.

It follows the reference analyzer's own description (kspecanal.py:351-397
for the spectrum of one capture block, :426-506 for the display chain)
and nothing of the program under test: it imports neither the port nor
the JAX package, and takes only the configuration's fields and the
capture that the benchmark made.

Per block of ``full_size`` samples: overlapped windows starting at
``int(i * fftSize * curScanNonOverlap)`` (dropped where they would run
past the block), each multiplied by the window table, transformed,
scaled by ``2 * winAdj / fftSize`` with ``winAdj = len(win) / sum(win)``,
folded over the windows by the cumulate mode (AVG is the decay
``f = (f + x) / 2`` with the first window copied), and fftshifted.  The
display chain turns each spectrum into dB less the tuner gain
(``LogNoGain``), folds max, min and the decaying average over the
session's blocks, keeps the last block as the current curve, and writes
the heatmap ring one row a block: the dB row compressed to ``xRes``
points by the maximum of each group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

KAISER_BETA = 64.0
HEATMAP_ROWS = 128
# Blocks of the decaying average that the reference replays: an older
# block weighs 2**-64 or less.
AVG_DEPTH = 64


@dataclasses.dataclass(frozen=True)
class Geometry:
    """What the reference derives from a configuration's fields."""
    fft_size: int
    full_size: int
    starts: Tuple[int, ...]
    window: str
    cumu_mode: str
    gain: float
    disp_proc: str
    x_res: int
    compress_hm: str
    curves: Tuple[bool, bool, bool]     # max, min, avg

    @property
    def num_windows(self) -> int:
        return len(self.starts)

    @property
    def hm_width(self) -> int:
        if self.compress_hm in ("MAX", "MIN", "AVG"):
            return min(self.fft_size, self.x_res)
        return self.fft_size


def geometry(spec: Dict) -> Geometry:
    """The sizes of a zero-span configuration (kspecanal.py:368,385-390,
    :926-949) from its fields as the configuration file states them."""
    n = int(spec["fft_size"])
    fs = float(spec.get("sampling_rate", 2.4e6))
    if n < fs // 8:
        full = n * int(spec.get("fft2full_mult4less", 8))
    else:
        full = n * int(spec.get("fft2full_mult4more", 2))
    hop = n * float(spec["cur_scan_non_overlap"])
    starts = []
    for i in range(int(full / hop)):
        s = int(i * hop)
        if s + n > full:
            break
        starts.append(s)
    x_res = int(spec.get("x_res", 512))
    if x_res > n:
        x_res = n
    elif n % x_res:
        for i in range(int(n / 300), 0, -1):
            if n % i == 0:
                x_res = n // i
                break
    return Geometry(
        fft_size=n, full_size=full, starts=tuple(starts),
        window=spec.get("window", "WIN.ONES"),
        cumu_mode=spec.get("cur_scan_cumu_mode", "AVG"),
        gain=float(spec.get("gain", 19.1)),
        disp_proc=spec.get("zero_span_disp_proc", "LogNoGain"),
        x_res=x_res, compress_hm=spec.get("plt_compress_hm", "MAX"),
        curves=(bool(spec.get("b_data_max", True)),
                bool(spec.get("b_data_min", True)),
                bool(spec.get("b_data_avg", True))))


def window_table(kind: str, n: int) -> np.ndarray:
    """numpy's symmetric window of ``n`` points (kspecanal.py:932-936)."""
    return {"WIN.ONES": np.ones, "WIN.HAMMING": np.hamming,
            "WIN.HANNING": np.hanning,
            "WIN.KAISER": lambda m: np.kaiser(m, KAISER_BETA)}[kind](n)


def window_weights(mode: str, w: int) -> Optional[np.ndarray]:
    """Weights of the serial fold over ``w`` windows: AVG's decay with the
    first window copied, RAW's last window; None for MAX and MIN."""
    if mode == "AVG":
        out = np.array([0.5 ** (w - i) for i in range(w)])
        out[0] = 0.5 ** (w - 1)
        return out
    if mode == "RAW":
        out = np.zeros(w)
        out[-1] = 1.0
        return out
    return None


def decode(plane: torch.Tensor,
           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """A capture plane in ``dtype``: rtl_sdr bytes less 127
    (octave/load_rtlsdr.m), float planes as they are."""
    if plane.dtype == torch.uint8:
        return plane.to(dtype) - 127.0
    return plane.to(dtype)


def spectra(re: torch.Tensor, im: torch.Tensor, g: Geometry,
            dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Linear fftshifted spectra ``(rows, fft_size)`` of capture blocks
    ``(rows, full_size)``, computed throughout in ``dtype`` (float64; the
    control computes in float32)."""
    n = g.fft_size
    idx = (torch.as_tensor(g.starts, device=re.device)[:, None]
           + torch.arange(n, device=re.device)[None, :])
    win = torch.as_tensor(window_table(g.window, n), dtype=dtype,
                          device=re.device)
    frames = torch.complex(decode(re, dtype)[:, idx],
                           decode(im, dtype)[:, idx]) * win
    win_adj = n / float(win.sum().item())
    mags = torch.fft.fft(frames, dim=-1).abs() * (2.0 * win_adj / n)
    w = window_weights(g.cumu_mode, g.num_windows)
    if w is None:
        folded = (mags.amax(dim=1) if g.cumu_mode == "MAX"
                  else mags.amin(dim=1))
    else:
        folded = torch.einsum("w,rwf->rf", torch.as_tensor(
            w, dtype=dtype, device=re.device), mags)
    return torch.fft.fftshift(folded, dim=-1)


def to_db(spec: torch.Tensor, g: Geometry) -> torch.Tensor:
    """The display transform of the configuration: ``LogNoGain`` is dB
    less the tuner gain (kspecanal.py:106-112), ``Raw`` leaves the value."""
    out = spec
    for mode in g.disp_proc.split("."):
        if mode == "LogNoGain":
            out = 10.0 * torch.log10(out) - g.gain
        elif mode != "Raw":
            raise ValueError(f"the reference has no display transform "
                             f"{mode!r}")
    return out


def heat_row(db: torch.Tensor, g: Geometry) -> torch.Tensor:
    """A heatmap row: ``xRes`` groups of the dB row reduced by the
    configuration's heatmap compression."""
    mode = g.compress_hm
    if mode == "RAW":
        return db
    cols = db.shape[-1] // g.x_res
    t = db[..., :g.x_res * cols].reshape(*db.shape[:-1], g.x_res, cols)
    if mode == "MAX":
        return t.amax(dim=-1)
    if mode == "MIN":
        return t.amin(dim=-1)
    if mode == "AVG":
        return t.mean(dim=-1)
    raise ValueError(f"the reference has no heatmap compression {mode!r}")


@dataclasses.dataclass
class SessionState:
    """What a zero-span session leaves after ``done`` blocks, as the
    reference computes it (float64; a curve that is off stays None)."""
    fft_max: Optional[torch.Tensor]
    fft_min: Optional[torch.Tensor]
    fft_avg: Optional[torch.Tensor]
    fft_cur: torch.Tensor
    heatmap: torch.Tensor
    hm_index: int


def chunk_rows(g: Geometry, budget_bytes: int = 1 << 30) -> int:
    """Capture blocks a reference chunk takes: its complex128 frames fit
    in ``budget_bytes``."""
    return max(1, budget_bytes // (16 * g.num_windows * g.fft_size))


def session_state(re: torch.Tensor, im: torch.Tensor, g: Geometry,
                  first: int, done: int,
                  kept: Sequence[Tuple[np.ndarray, torch.Tensor]] = ()
                  ) -> Tuple[SessionState, float]:
    """The state after a session that took ``done`` blocks of the capture
    ``(blocks, full_size)`` in order from block ``first``, wrapping; and
    the worst :func:`rel_err` of the program's spectra ``kept``, each a
    pair of capture blocks ``(rows,)`` and the spectra ``(rows,
    fft_size)`` that the program made of them (0.0 where none are kept).
    Each capture block's spectrum is computed once, :func:`chunk_rows`
    blocks at a time."""
    blocks = re.shape[0]
    depth = max(HEATMAP_ROWS, AVG_DEPTH)
    tail = {j: (first + j) % blocks for j in range(max(0, done - depth),
                                                   done)}
    taken = np.zeros(blocks, bool)
    taken[(first + np.arange(min(done, blocks))) % blocks] = True
    wanted = np.zeros(blocks, bool)
    for rows, _ in kept:
        wanted[rows] = True
    rows_all = np.flatnonzero(taken | wanted)
    need_db = set(tail.values())
    fmax = fmin = None
    dbs: Dict[int, torch.Tensor] = {}
    worst = 0.0
    step = chunk_rows(g)
    for s in range(0, len(rows_all), step):
        part = rows_all[s:s + step]
        idx = torch.as_tensor(part, device=re.device)
        sp = spectra(re[idx], im[idx], g)
        db = to_db(sp, g)
        used = torch.as_tensor(taken[part], device=re.device)
        if bool(used.any()):
            cmax, cmin = db[used].amax(dim=0), db[used].amin(dim=0)
            fmax = cmax if fmax is None else torch.maximum(fmax, cmax)
            fmin = cmin if fmin is None else torch.minimum(fmin, cmin)
        pos = np.full(blocks, -1)
        pos[part] = np.arange(len(part))
        for rows, got in kept:
            at = pos[rows]
            hit = np.flatnonzero(at >= 0)
            if len(hit):
                worst = max(worst, rel_err(
                    got[torch.as_tensor(hit, device=got.device)],
                    sp[torch.as_tensor(at[hit], device=sp.device)]))
        for j, r in enumerate(part.tolist()):
            if r in need_db:
                dbs[r] = db[j].clone()
    avg = None
    for j in range(max(0, done - AVG_DEPTH), done):
        avg = dbs[tail[j]] if avg is None else (avg + dbs[tail[j]]) / 2.0
    heatmap = torch.zeros((HEATMAP_ROWS, g.hm_width), dtype=torch.float64,
                          device=re.device)
    for j in range(max(0, done - HEATMAP_ROWS), done):
        heatmap[j % HEATMAP_ROWS] = heat_row(dbs[tail[j]], g)
    want_max, want_min, want_avg = g.curves
    return SessionState(
        fft_max=fmax if want_max else None,
        fft_min=fmin if want_min else None,
        fft_avg=avg if want_avg else None,
        fft_cur=dbs[tail[done - 1]], heatmap=heatmap,
        hm_index=done % HEATMAP_ROWS), worst


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst bin of ``|got - want|`` over ``|want|``, each row's bins
    floored at a millionth of the row's largest (a bin that small is
    below the float32 resolution of the row's peak)."""
    want = want.to(torch.float64)
    floor = 1e-6 * want.abs().amax(dim=-1, keepdim=True)
    err = (got.to(torch.float64) - want).abs() / torch.maximum(
        want.abs(), floor)
    return float(err.max().item())


def db_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst ``|got - want|`` in dB; bins equal on both sides (also both
    infinite) read 0."""
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    same = got == want
    diff = (got - want).abs().masked_fill(same, 0.0)
    diff = torch.nan_to_num(diff, nan=math.inf)
    return float(diff.max().item())
