"""The port's own copy of ``kspecanal_tpu.io.replay``.

Session record/replay — byte-compatible with the reference's pickle
stream formats (the correctness oracle for the whole framework).

Formats (SURVEY.md §5 checkpoint):
  * zero-span session recording (kspecanal.py:510-526):
      pickle(centerFreq); pickle(samplingRate); pickle(gain);
      then per frame: pickle(timestamp_float); pickle(linear_magnitude_vec)
    Frames hold the *pre-log*, fftshifted, cumulated magnitude spectrum.
  * replay reads the header, overrides fC/fS/gain (kspecanal.py:533-542),
    then yields frames until EOF -> graceful stop (kspecanal.py:559-564).

The reference implements replay by monkey-patching the module-global
``sdr_curscan`` (kspecanal.py:531,543); here replay is just another
spectrum *source* behind a small iterator protocol — no global mutation.
"""
from __future__ import annotations

import dataclasses
import pickle
import time
from typing import IO, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ReplayHeader:
    center_freq: float
    sampling_rate: float
    gain: float


class ZeroSpanRecorder:
    """Writes the reference's zeroSpanSave stream (kspecanal.py:510-526)."""

    def __init__(self, path: str, center_freq: float, sampling_rate: float,
                 gain: float):
        self._f: Optional[IO[bytes]] = open(path, "wb+")
        pickle.dump(center_freq, self._f)
        pickle.dump(sampling_rate, self._f)
        pickle.dump(gain, self._f)

    def append(self, spectrum: np.ndarray, timestamp: Optional[float] = None):
        """One frame: (timestamp, linear fftshifted magnitude vector)."""
        assert self._f is not None
        ts = time.time() if timestamp is None else timestamp
        pickle.dump(float(ts), self._f)
        pickle.dump(np.asarray(spectrum, np.float64), self._f)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ZeroSpanPlayer:
    """Reads a zeroSpanSave stream; iterating yields (timestamp, spectrum)
    frames until EOF (kspecanal.py:530-564)."""

    def __init__(self, path: str):
        self._f: IO[bytes] = open(path, "rb")
        self.header = ReplayHeader(
            center_freq=float(pickle.load(self._f)),
            sampling_rate=float(pickle.load(self._f)),
            gain=float(pickle.load(self._f)),
        )

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        while True:
            try:
                ts = pickle.load(self._f)
                data = pickle.load(self._f)
            except (EOFError, pickle.UnpicklingError):
                return
            yield float(ts), np.asarray(data)

    @staticmethod
    def format_timestamp(ts: float) -> str:
        """Human timestamp exactly as the reference renders it for the
        xlabel: ``%Y%m%d%Z%H%M%S.mmm`` in gmtime (kspecanal.py:553-556)."""
        milli = int((ts - int(ts)) * 1000)
        return "{}.{:03}".format(
            time.strftime("%Y%m%d%Z%H%M%S", time.gmtime(ts)), milli)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_sig_lvls(path: str) -> Tuple[float, float, np.ndarray]:
    """Signal-level baseline file: (startFreq, endFreq, Fft.Avg)
    (kspecanal.py:736-768)."""
    with open(path, "rb") as f:
        start = float(pickle.load(f))
        end = float(pickle.load(f))
        avg = np.asarray(pickle.load(f))
    return start, end, avg


def save_sig_lvls(path: str, start_freq: float, end_freq: float,
                  fft_avg: np.ndarray) -> None:
    """Write a signal-level baseline (kspecanal.py:736-748)."""
    with open(path, "wb+") as f:
        pickle.dump(float(start_freq), f)
        pickle.dump(float(end_freq), f)
        pickle.dump(np.asarray(fft_avg, np.float64), f)
