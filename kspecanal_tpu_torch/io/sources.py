"""IQ sources of the port.

The host sources (``read(n) -> (re, im)`` float32 planes, ``retune``,
``close``) are the port's own copies of ``kspecanal_tpu.io.sources``: raw
rtl_sdr captures (whole-file and the native streaming reader), the synth
tone simulator, the decimating wrapper and the live-SDR adapter, with the
JAX package's reference comments (octave/load_rtlsdr.m, testfft.py,
kspecanal.py).  tests/test_torch_standalone.py holds them to the
originals.

The on-device sources ``tpuSource devicesynth|devicenoise`` are the
counterparts of ``DeviceSynthIQSource`` and ``DeviceNoiseIQSource``: both
make their planes on an explicit ``device`` from a ``torch.Generator``
seeded with ``seed``; ``read_device_batch(k, n)`` returns ``(k, n)``
tensors on that device for the batched catch-up driver, and ``read(n)``
keeps the host protocol (float32 numpy planes).  The random numbers are
torch's, not ``jax.random``'s: the synthesis itself is the plain function
:func:`synth_batch` of the per-block start times, so a test hands both
packages the same start times.
"""
from __future__ import annotations

import math
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from kspecanal_tpu_torch.utils.profiling import wait

Planes = Tuple[np.ndarray, np.ndarray]

# Chunked-read unit mirroring gSdrReadUnit = 2**18 (kspecanal.py:311).
SDR_READ_UNIT = 2 ** 18


def split_u8_planes(raw: np.ndarray) -> Planes:
    """Interleaved raw u8 I/Q (last axis 2n bytes) -> UNDECODED u8 planes
    (last axis n), on the HOST: native C++ split when built, NumPy
    strided copy otherwise.  The device kernels decode the planes in
    VMEM; splitting host-side removes the on-device strided deinterleave
    (~1 ms/dispatch measured r4) from every raw ship path."""
    try:
        from kspecanal_tpu_torch.io import native_iq
        return native_iq.split_u8_iq(raw)
    except (ImportError, OSError):
        return (np.ascontiguousarray(raw[..., 0::2]),
                np.ascontiguousarray(raw[..., 1::2]))


class IQSource(Protocol):
    center_freq: float
    sample_rate: float
    gain: float

    def read(self, n: int) -> Planes: ...
    def retune(self, center_freq: float, sample_rate: float,
               gain: float) -> bool: ...
    def close(self) -> None: ...


def load_rtlsdr_capture(path: str, count: Optional[int] = None,
                        offset: int = 0) -> Planes:
    """Decode an ``rtl_sdr`` capture file into float32 IQ planes.

    Format per octave/load_rtlsdr.m: uint8 bytes, value-127 offset,
    interleaved I then Q.  ``offset``/``count`` are in complex samples.

    Uses the native C++ decoder when built (see native/iqdecode.cpp);
    falls back to vectorized NumPy.
    """
    with open(path, "rb") as f:
        f.seek(offset * 2)
        raw = np.fromfile(f, dtype=np.uint8,
                          count=-1 if count is None else count * 2)
    if len(raw) % 2:
        raw = raw[:-1]
    try:
        from kspecanal_tpu_torch.io import native_iq
        return native_iq.decode_u8_iq(raw)
    except (ImportError, OSError):
        x = raw.astype(np.float32) - np.float32(127.0)
        return np.ascontiguousarray(x[0::2]), np.ascontiguousarray(x[1::2])


class FileIQSource:
    """Streams IQ from a raw rtl_sdr capture file, wrapping around at EOF
    so arbitrarily long sessions can replay a finite capture.

    Holds the capture as RAW bytes (2 B/sample) and decodes per read;
    :meth:`read_raw` exposes the undecoded u8 stream so the session can
    ship bytes to the device and decode in-jit
    (``parallel.stream.decode_u8_on_device``) — 4x less host->device
    traffic than float32 planes."""

    def __init__(self, path: str, center_freq: float = 92e6,
                 sample_rate: float = 2.4e6, gain: float = 19.1,
                 wrap: bool = True):
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        with open(path, "rb") as f:
            raw = np.fromfile(f, dtype=np.uint8)
        if len(raw) % 2:
            raw = raw[:-1]
        self._raw = raw
        if len(raw) == 0:
            raise ValueError(f"empty IQ capture: {path}")
        self._pos = 0            # complex-sample position
        self._wrap = wrap
        self.exhausted = False

    def _n_samples(self) -> int:
        return len(self._raw) // 2

    def read_raw(self, n: int) -> np.ndarray:
        """``2*n`` u8 interleaved IQ bytes (127-fill past EOF when
        non-wrapping, decoding to the same zeros as :meth:`read`)."""
        out = np.empty(2 * n, np.uint8)
        total = self._n_samples()
        got = 0
        while got < n:
            take = min(n - got, total - self._pos)
            out[2 * got:2 * (got + take)] = \
                self._raw[2 * self._pos:2 * (self._pos + take)]
            self._pos += take
            got += take
            if self._pos == total:
                if not self._wrap:
                    self.exhausted = True
                    out[2 * got:] = 127
                    return out
                self._pos = 0
        return out

    # Recorded data does not change under retune: a prefetch wrapper may
    # keep read-ahead blocks across retunes (io/prefetch.py).
    retune_invalidates = False

    def read(self, n: int) -> Planes:
        raw = self.read_raw(n)
        try:
            from kspecanal_tpu_torch.io import native_iq
            return native_iq.decode_u8_iq(raw)
        except (ImportError, OSError):
            x = raw.astype(np.float32) - np.float32(127.0)
            return (np.ascontiguousarray(x[0::2]),
                    np.ascontiguousarray(x[1::2]))

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        pass


def make_file_source(path: str, center_freq: float, sample_rate: float,
                     gain: float):
    """The production file-source ladder (shared by cli.make_source and
    bench.py so the bench measures what the CLI runs): prefer the native
    streaming reader (C++ producer thread, O(block) memory, raw-u8 ring);
    fall back to the whole-file NumPy decode without the toolchain.
    Returns ``(source, fallback_reason_or_None)``."""
    try:
        return StreamingFileIQSource(path, center_freq=center_freq,
                                     sample_rate=sample_rate,
                                     gain=gain), None
    except (OSError, ImportError) as e:
        return FileIQSource(path, center_freq=center_freq,
                            sample_rate=sample_rate, gain=gain), str(e)


def _grid_tone_offsets(center_freq: float, sample_rate: float,
                       spacing: float) -> np.ndarray:
    """testfft.py:36-55 ``abs_freqs`` grid: one tone per integer multiple
    of ``spacing`` inside [fC - fS/2, fC + fS/2], as offsets ``fC - cur``
    (shared by the host and on-device synth sources)."""
    start = center_freq - sample_rate / 2
    end = center_freq + sample_rate / 2
    s = int(math.ceil(start / spacing) * spacing)
    e = int((end // spacing) * spacing) + 1
    return np.array([center_freq - cur for cur in range(s, e, int(spacing))])


class SynthIQSource:
    """Deterministic multi-tone simulator — the testfft.py fixture rebuilt
    as a seedable source.

    Tone placement follows testfft.py:36-55 ``abs_freqs``: one tone per
    integer MHz inside the tuned band, synthesized at offset ``fC - cur``
    with the reference's ``g*sin(2pi f t) + j*g*cos(2pi f t)`` convention
    (= j*e^{-j 2pi f t}: parameter +f lands at spectral -f), amplitude
    ``10**(gain/10)`` each, random start phase (testfft.py:63-77).
    ``seed=None`` reproduces the reference's nondeterministic start time;
    an int seed gives deterministic streams for tests.
    """

    def __init__(self, center_freq: float = 92e6, sample_rate: float = 2.4e6,
                 gain: float = 0.5, seed: Optional[int] = 0,
                 tones_hz: Optional[Sequence[float]] = None,
                 tone_spacing_hz: float = 1e6):
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self._rng = np.random.default_rng(seed)
        self._tones = tones_hz  # explicit relative offsets, or None -> grid
        self._spacing = tone_spacing_hz

    def grid_tones(self) -> np.ndarray:
        """testfft.py:36-55: a tone at every integer multiple of the grid
        spacing within [fC - fS/2, fC + fS/2], at offset fC - cur."""
        return _grid_tone_offsets(self.center_freq, self.sample_rate,
                                  self._spacing)

    def read(self, n: int) -> Planes:
        f = (np.asarray(self._tones, np.float64) if self._tones is not None
             else self.grid_tones())
        gain_mult = 10 ** (self.gain / 10)
        dur = n / self.sample_rate
        t_start = float(self._rng.random())
        t = np.linspace(t_start, t_start + dur, n)
        ang = 2 * np.pi * f[:, None] * t[None, :]
        re = gain_mult * np.sin(ang).sum(axis=0)
        im = gain_mult * np.cos(ang).sum(axis=0)
        return re.astype(np.float32), im.astype(np.float32)

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        pass



class DecimatingSource:
    """Time-domain decimation preprocessor — the reference's own TODO
    (README.rst:612-622): treat the capture as oversampled, merge each
    group of ``factor`` adjacent samples into one, "gaining 1 additional
    bit resolution wrt samples, while reducing the effective freq band".

    The wrapper keeps the CONFIG in post-decimation terms: ``retune``
    drives the inner source at ``factor * samplingRate`` and ``read(n)``
    consumes ``factor * n`` raw samples, so frequency axes, fullSize
    derivation and scan band stepping all see the effective (decimated)
    rate unchanged.  Each group is summed and divided by ``factor/2``,
    generalizing the TODO's "decimate 4 adjacent samples into 1 and then
    divide by 2" (net one extra amplitude bit).
    """

    def __init__(self, inner: IQSource, factor: int):
        if factor < 2:
            raise ValueError(f"decimation factor must be >= 2: {factor}")
        self._inner = inner
        self._f = int(factor)

    @property
    def center_freq(self):
        return self._inner.center_freq

    @property
    def sample_rate(self):
        return self._inner.sample_rate / self._f

    @property
    def gain(self):
        return self._inner.gain

    @property
    def exhausted(self):
        return bool(getattr(self._inner, "exhausted", False))

    def read(self, n: int) -> Planes:
        re, im = self._inner.read(n * self._f)
        scale = np.float32(2.0 / self._f)     # sum / (factor/2)
        return (
            (re.reshape(n, self._f).sum(axis=1) * scale).astype(np.float32),
            (im.reshape(n, self._f).sum(axis=1) * scale).astype(np.float32))

    def retune(self, center_freq, sample_rate, gain) -> bool:
        return self._inner.retune(center_freq, sample_rate * self._f, gain)

    def close(self):
        self._inner.close()



class RtlSdrSource:
    """Live hardware adapter (optional): wraps pyrtlsdr with the reference's
    HAL semantics — settle-flush of 16*1024 samples after retune
    (kspecanal.py:301), chunked reads of SDR_READ_UNIT with pow2 rounding of
    the tail (kspecanal.py:312-347), and failure -> recreate + False
    (kspecanal.py:296-308).  Gated: importing rtlsdr is deferred so the
    framework runs without the dependency.
    """

    def __init__(self, center_freq: float = 92e6, sample_rate: float = 2.4e6,
                 gain: float = 19.1):
        import rtlsdr  # deferred: optional hardware dependency
        self._rtlsdr = rtlsdr
        self._sdr = rtlsdr.RtlSdr()
        # Device-caps echo on open (sdr_info, kspecanal.py:281-284).
        print("INFO:Sdr:SupportedGains:", self._sdr.valid_gains_db)
        print("INFO:Sdr:Bandwidth:", self._sdr.bandwidth)
        print("INFO:Sdr:freqCorrection:", self._sdr.freq_correction)
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self.retune(center_freq, sample_rate, gain)

    def retune(self, center_freq, sample_rate, gain) -> bool:
        try:
            self._sdr.sample_rate = sample_rate
            self._sdr.center_freq = center_freq
            self._sdr.gain = gain
            self._sdr.read_samples(16 * 1024)  # settle flush
            ok = True
        except Exception:
            self._sdr.close()
            self._sdr = self._rtlsdr.RtlSdr()
            ok = False
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return ok

    def read(self, n: int) -> Planes:
        out = np.empty(n, np.complex128)
        pos = 0
        while pos < n:
            want = min(SDR_READ_UNIT, n - pos)
            rd = 2 ** int(math.ceil(math.log2(want)))
            out[pos:pos + want] = self._sdr.read_samples(rd)[:want]
            pos += want
        return (out.real.astype(np.float32), out.imag.astype(np.float32))

    def close(self):
        self._sdr.close()


class StreamingFileIQSource:
    """Raw-capture source backed by the NATIVE streaming reader
    (native/iqstream.cpp): a C++ producer thread reads + decodes fixed-size
    blocks into a ring ahead of the consumer, so file IO and uint8->f32
    decode overlap device compute and host memory stays O(block * depth)
    however long the capture is (``FileIQSource`` decodes the whole file
    up front).  Wraps at EOF.  Falls back to FileIQSource when the native
    toolchain is unavailable (see cli.make_source).
    """

    def __init__(self, path: str, center_freq: float = 92e6,
                 sample_rate: float = 2.4e6, gain: float = 19.1,
                 depth: int = 4):
        from kspecanal_tpu_torch.io.native_iq import IqStream  # may raise OSError
        self._IqStream = IqStream
        self._path = path
        self._depth = depth
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        self._stream = None
        self._block = 0
        self._raw = False
        self._consumed = 0       # complex samples popped by the consumer
        # open eagerly with a placeholder block to validate the path
        probe = IqStream(path, 1024, depth=1)
        if probe.file_samples == 0:
            probe.close()
            raise ValueError(f"empty IQ capture: {path}")
        self._file_samples = probe.file_samples
        probe.close()

    # Recorded data does not change under retune (see FileIQSource).
    retune_invalidates = False

    def _ensure_stream(self, n: int, raw: bool):
        if self._stream is None or self._block != n or self._raw != raw:
            if self._stream is not None:
                self._stream.close()
            # Reopen AT the consumer's logical position: the producer
            # thread read ahead of what was popped, so a plain reopen
            # would rewind to wherever its file cursor happened to be (or
            # worse, to 0) and replay data on a block-size or raw/decoded
            # mode switch.
            self._stream = self._IqStream(
                self._path, n, depth=self._depth, raw=raw,
                start_sample=self._consumed % self._file_samples)
            self._block = n
            self._raw = raw
        return self._stream

    def read(self, n: int) -> Planes:
        out = self._ensure_stream(n, raw=False).read_block()
        self._consumed += n
        return out

    def read_raw(self, n: int) -> np.ndarray:
        """Next block as RAW interleaved uint8 (2n bytes), read ahead by
        the native producer thread — the session's u8 ship path (in-jit
        decode, 2 B/sample over the host link) keeps native read-ahead."""
        out = self._ensure_stream(n, raw=True).read_block_raw()
        self._consumed += n
        return out

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        if self._stream is not None:
            self._stream.close()
            self._stream = None


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
        with wait("device_source"):
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
        with wait("device_source"):
            re, im = re[0].cpu().numpy(), im[0].cpu().numpy()
        return tuple(p.astype(np.float32) - np.float32(127.0)
                     for p in (re, im))

    def retune(self, center_freq, sample_rate, gain) -> bool:
        self.center_freq = center_freq
        self.sample_rate = sample_rate
        self.gain = gain
        return True

    def close(self):
        pass
