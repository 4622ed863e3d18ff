"""The benchmark's capture: a recording made from the seed, held on the
device, and the source that hands it to a session.

A capture is what an ``rtl_sdr`` recording of the tuned band holds: a
tone at every integer multiple of the traffic's tone spacing inside
``[fC - fS/2, fC + fS/2]``, placed at offset ``fC - f`` with the
``A sin + j A cos`` convention of the reference's simulator (testfft.py),
each with a random start phase, plus Gaussian noise on both planes.  The
``u8`` format stores each plane as rtl_sdr does, the value plus 127
rounded and clipped to 0-255 (octave/load_rtlsdr.m); ``cf32`` keeps
float32 planes.  Both planes are ``(blocks, full_size)``, so the source
hands out the next K blocks of a session step as a view.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Tuple

import torch

from portbench.reference import Geometry

# Samples made in one pass of the generator: its float64 temporaries
# stay near a GiB.
_GEN_CHUNK = 1 << 25


def tone_offsets(center_freq: float, sample_rate: float,
                 spacing: float) -> List[float]:
    """One tone at every integer multiple of ``spacing`` inside the tuned
    band, as the offset ``fC - f`` (testfft.py:36-55)."""
    start = center_freq - sample_rate / 2
    end = center_freq + sample_rate / 2
    first = int(math.ceil(start / spacing) * spacing)
    last = int((end // spacing) * spacing)
    return [center_freq - f for f in range(first, last + 1, int(spacing))]


def make_capture(spec: Dict, traffic: Dict, g: Geometry, seed: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capture of ``traffic`` for the configuration ``spec``: planes
    ``(blocks, full_size)`` on ``device``, the same for the same seed."""
    samples = int(traffic["capture_samples"])
    if samples % g.full_size:
        raise ValueError(f"capture_samples {samples} is not a whole number "
                         f"of blocks of {g.full_size}")
    sig = traffic["signal"]
    fs = float(spec["sampling_rate"])
    offs = tone_offsets(float(spec["center_freq"]), fs,
                        float(sig["tone_spacing_hz"]))
    amp, sigma = float(sig["tone_amplitude"]), float(sig["noise_sigma"])
    fmt = traffic["format"]
    dtype = {"u8": torch.uint8, "cf32": torch.float32}[fmt]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    phases = (torch.rand(len(offs), generator=gen, dtype=torch.float64,
                         device=device) * (2 * math.pi)).tolist()
    re = torch.empty(samples, dtype=dtype, device=device)
    im = torch.empty(samples, dtype=dtype, device=device)
    for s in range(0, samples, _GEN_CHUNK):
        m = min(_GEN_CHUNK, samples - s)
        t = torch.arange(s, s + m, dtype=torch.float64, device=device)
        xr = sigma * torch.randn(m, generator=gen, device=device)
        xi = sigma * torch.randn(m, generator=gen, device=device)
        for f, ph in zip(offs, phases):
            ang = (torch.remainder(t * (f / fs), 1.0) * (2 * math.pi)
                   + ph).to(torch.float32)
            xr += amp * torch.sin(ang)
            xi += amp * torch.cos(ang)
        for out, x in ((re, xr), (im, xi)):
            if fmt == "u8":
                x = (torch.round(x) + 127.0).clamp_(0.0, 255.0)
            out[s:s + m] = x.to(dtype)
    return re.view(-1, g.full_size), im.view(-1, g.full_size)


class CaptureSource:
    """A session's source over a capture on the device: each
    ``read_device_batch(k, n)`` returns the next ``k`` blocks as views,
    in order from block ``first``, wrapping at the end.  ``hooks`` run at
    each batch, before it is handed out."""

    def __init__(self, re: torch.Tensor, im: torch.Tensor, first: int = 0):
        self.re, self.im = re, im
        self.blocks = re.shape[0]
        self.pos = first % self.blocks
        self.center_freq = self.sample_rate = self.gain = 0.0
        self.handed = 0
        self.hooks: List[Callable[["CaptureSource"], None]] = []

    def read_device_batch(self, k: int, n: int):
        if n != self.re.shape[1]:
            raise ValueError(f"blocks of {n} asked of a capture of "
                             f"{self.re.shape[1]}")
        if self.blocks % k:
            raise ValueError(f"a batch of {k} does not divide the "
                             f"capture's {self.blocks} blocks")
        for hook in self.hooks:
            hook(self)
        p = self.pos
        self.pos = (p + k) % self.blocks
        self.handed += k
        return self.re[p:p + k], self.im[p:p + k]

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq, self.sample_rate, self.gain = (
            center_freq, sample_rate, gain)
        return True

    def close(self):
        pass


def deadline_hook(end: float, stop: Callable[[], None]):
    """A source hook that calls ``stop`` at the first batch asked for at
    ``time.perf_counter()`` ``end`` or later."""
    def hook(_source):
        if time.perf_counter() >= end:
            stop()
    return hook
