"""Generate raw-IQ capture fixtures in the rtl_sdr uint8 format — the port
of ``scripts/make_fixture.py``, the equivalent of the reference's
octave/hkvc-dump_samples.sh (which captures 1024000 samples at 2 freqs x 4
gains via `rtl_sdr`).

Synthesizes deterministic multi-tone IQ (testfft.py grid semantics, the
port's ``io/sources.SynthIQSource``) and quantizes to the uint8 interleaved
value+127 format of octave/load_rtlsdr.m, so the whole ingest chain (decode
-> curscan -> waterfall, ``tools.analyze_capture``) is exercisable without
hardware.  For the same arguments the file is byte for byte the JAX
script's.  Host code only.

    python -m kspecanal_tpu_torch.scripts.make_fixture out.iq [numSamples] \\
        [centerFreq] [gain]
"""
from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from kspecanal_tpu_torch.io.sources import SynthIQSource


def make_capture(path: str, n: int = 1_024_000, center_freq: float = 92e6,
                 sample_rate: float = 2.4e6, gain: float = 8.7,
                 seed: int = 0) -> None:
    src = SynthIQSource(center_freq=center_freq, sample_rate=sample_rate,
                        gain=gain, seed=seed)
    re, im = src.read(n)
    # normalize into the uint8 dynamic range around 127
    peak = max(float(np.max(np.abs(re))), float(np.max(np.abs(im))), 1e-9)
    scale = 100.0 / peak
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(re * scale + 127), 0, 255).astype(np.uint8)
    raw[1::2] = np.clip(np.round(im * scale + 127), 0, 255).astype(np.uint8)
    raw.tofile(path)


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = argv[0] if len(argv) > 0 else "fixture.iq"
    n = int(float(argv[1])) if len(argv) > 1 else 1_024_000
    fc = float(argv[2]) if len(argv) > 2 else 92e6
    g = float(argv[3]) if len(argv) > 3 else 8.7
    make_capture(out, n, fc, gain=g)
    print(f"wrote {out}: {n} samples @ fC={fc} gain={g}")


if __name__ == "__main__":
    main()
