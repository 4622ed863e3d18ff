"""On-device IQ sources of the port — ``tpuSource devicesynth|devicenoise``,
the counterparts of ``kspecanal_tpu.io.sources.DeviceSynthIQSource`` and
``DeviceNoiseIQSource``.  The host sources (synth, file, rtlsdr) are the JAX
package's own, which import no JAX.

Both make their planes on an explicit ``device`` from a ``torch.Generator``
seeded with ``seed``; ``read_device_batch(k, n)`` returns ``(k, n)``
tensors on that device for the batched catch-up driver, and ``read(n)``
keeps the host protocol (float32 numpy planes).  The random numbers are
torch's, not ``jax.random``'s: the synthesis itself is the plain function
:func:`synth_batch` of the per-block start times, so a test hands both
packages the same start times.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from kspecanal_tpu.io.sources import _grid_tone_offsets

_U32 = 0xFFFFFFFF
_TWO_PI_OVER_2_32 = float(2.0 * np.pi / 2.0 ** 32)
# int64 elements of one (rows, n) phase chunk of one tone: 128 MiB.
_PHASE_CHUNK = 1 << 24


def source_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist: a device
    source never falls back to the CPU unless asked for by ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the on-device source (pass "
                           "device='cpu' to make its planes on the CPU)")
    return dev


def _mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for an int64 tensor and an int, both in
    [0, 2**32), exact: ``b`` is split into 16-bit halves so no product
    leaves int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def sincos_from_phase_u32(phase: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of ``2*pi * phase / 2**32`` for an int64 tensor of
    fixed-point cycle fractions in [0, 2**32): the port of
    ``_sincos_from_phase_u32``.  The top two bits pick the nearest quadrant
    and the wrapped remainder is a signed offset in [-pi/4, pi/4], where
    the same Horner polynomials (sin through x^9, cos through x^8) run in
    float32.  The uint32 wrap and the int32 bitcast are exact int64
    operations (``& 0xFFFFFFFF``, and ``- 2**32`` where the top bit is
    set)."""
    q = ((phase + 0x20000000) & _U32) >> 30                 # nearest quadrant
    delta = (phase - (q << 30)) & _U32                      # wraps exactly
    delta = torch.where(delta >= 1 << 31, delta - (1 << 32), delta)
    x = delta.to(torch.float32) * _TWO_PI_OVER_2_32
    x2 = x * x
    # sin(x) = x(1 - x^2/6 + x^4/120 - x^6/5040 + x^8/362880)
    s = x * (1.0 + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0 + x2 * (
        -1.0 / 5040.0 + x2 * (1.0 / 362880.0)))))
    # cos(x) = 1 - x^2/2 + x^4/24 - x^6/720 + x^8/40320
    c = 1.0 + x2 * (-0.5 + x2 * (1.0 / 24.0 + x2 * (
        -1.0 / 720.0 + x2 * (1.0 / 40320.0))))
    odd = (q & 1).bool()
    s_sign = torch.where((q & 2).bool(), -1.0, 1.0)
    c_sign = torch.where(((q + 1) & 2).bool(), -1.0, 1.0)
    return (torch.where(odd, c, s) * s_sign, torch.where(odd, s, c) * c_sign)


def synth_batch(t0_u32: torch.Tensor, tones: Sequence[float],
                sample_rate: float, gain: float, n: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(k, n)`` float32 planes of the tone bank of
    ``_build_device_synth``: block ``j`` starts at ``t0_u32[j] / 2**32``
    seconds; each tone at offset ``f`` adds ``g*sin + j*g*cos`` of its phase
    with ``g = 10**(gain/10)``.  Phase is a fixed-point cycle fraction,
    ``f*t0 + i*frac(f*step)`` in units of 2^-32 cycles wrapping mod 2^32,
    with the host source's time step ``(n/fs)/(n-1)``.  Works tone by tone
    and in row chunks, so no ``(tones, k, n)`` int64 tensor is built."""
    dev = torch.device(device)
    f = np.asarray(tones, np.float64)
    gain_mult = float(10 ** (gain / 10))
    step_s = (n / sample_rate) / max(n - 1, 1)
    p_int = np.round(((f * step_s) % 1.0) * 2.0 ** 32).astype(np.int64) \
        % 2 ** 32
    f_int = np.round(f).astype(np.int64) % 2 ** 32
    t0 = t0_u32.to(device=dev, dtype=torch.int64)
    k = t0.shape[0]
    re = torch.zeros((k, n), dtype=torch.float32, device=dev)
    im = torch.zeros((k, n), dtype=torch.float32, device=dev)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    rows = max(1, _PHASE_CHUNK // max(n, 1))
    for fi, pi in zip(f_int.tolist(), p_int.tolist()):
        ramp = _mul_u32(i, pi)                              # (n,)
        for r0 in range(0, k, rows):
            phase0 = _mul_u32(t0[r0:r0 + rows], fi)
            s, c = sincos_from_phase_u32((phase0[:, None] + ramp) & _U32)
            re[r0:r0 + rows] += s
            im[r0:r0 + rows] += c
    return gain_mult * re, gain_mult * im


class DeviceSynthIQSource:
    """Tone simulator on the device (``tpuSource devicesynth``): the tone
    math of ``SynthIQSource`` (testfft.py:36-77: a tone per integer MHz in
    band at offset ``fC - cur``, ``g*sin + j*g*cos``, a random start time
    per block) made as float32 planes on ``device``."""

    def __init__(self, center_freq: float = 92e6, sample_rate: float = 2.4e6,
                 gain: float = 0.5, seed: Optional[int] = 0,
                 tone_spacing_hz: float = 1e6, *, device="cuda"):
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self._spacing = tone_spacing_hz
        self.device = source_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0 if seed is None else seed)

    def tones(self) -> Tuple[float, ...]:
        return tuple(_grid_tone_offsets(self.center_freq, self.sample_rate,
                                        self._spacing))

    def read_device_batch(self, k: int, n: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        t0 = torch.randint(0, 1 << 32, (k,), generator=self._gen,
                           dtype=torch.int64, device=self.device)
        return synth_batch(t0, self.tones(), float(self.sample_rate),
                           float(self.gain), n, self.device)

    def read(self, n: int):
        re, im = self.read_device_batch(1, n)
        return re[0].cpu().numpy(), im[0].cpu().numpy()

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        pass


class DeviceNoiseIQSource:
    """Uniform noise on the device (``tpuSource devicenoise``): raw uint8
    planes in [0, 255] with the rtl_sdr value-127 offset
    (octave/load_rtlsdr.m), which the curscan kernel decodes in its loads.
    ``read()`` decodes to float32 for the host protocol; ``gain`` is kept
    for the protocol only.  ``reuse=True`` makes each ``(k, n)`` batch once
    and returns that buffer on every later read, so a session over it
    measures the session machinery without acquisition."""

    def __init__(self, center_freq: float = 92e6, sample_rate: float = 2.4e6,
                 gain: float = 0.5, seed: Optional[int] = 0,
                 reuse: bool = False, *, device="cuda"):
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self.reuse = bool(reuse)
        self._cache: dict = {}
        self.device = source_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0 if seed is None else seed)

    def read_device_batch(self, k: int, n: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.reuse and (k, n) in self._cache:
            return self._cache[(k, n)]
        u8 = torch.randint(0, 256, (2, k, n), generator=self._gen,
                           dtype=torch.uint8, device=self.device)
        out = (u8[0], u8[1])
        if self.reuse:
            self._cache[(k, n)] = out
        return out

    def read(self, n: int):
        re, im = self.read_device_batch(1, n)
        return tuple(p[0].cpu().numpy().astype(np.float32) - np.float32(127.0)
                     for p in (re, im))

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        pass
