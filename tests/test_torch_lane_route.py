"""The port's route takes every config the JAX dispatcher sends to a Pallas
curscan kernel, off the 128 grid too.

JAX's ``_fused_choice`` (``kspecanal_tpu/ops/spectrum.py``) picks the lane
kernel K3 for every fft >= 2048 that is not prime and whose window starts
are multiples of n2 = ``_factorize(fft)[1]`` (fft 2500, 3000, 10000,
20000, 24000, ...), where the sublane predicate (multiples of 128) rejects
it.  ``cuda_curscan.kernel_route`` must be ``"fft"`` exactly there, so the
card runs the FFT kernel and never the ``torch.fft`` chain for them.  The
walk covers every fft from 2048 to 40000 at 50%, 75% and 90% overlap, u8
and float32 planes (the zero-span configuration at 2.4 Msps)."""
import pytest

from kspecanal_tpu.ops import spectrum as jspec
from kspecanal_tpu_torch.config import SpecConfig
from kspecanal_tpu_torch.ops import cuda_curscan


@pytest.mark.parametrize("nono", [0.5, 0.25, 0.1])
def test_route_is_fft_exactly_where_jax_picks_a_pallas_kernel(nono):
    missed, extra, lane = [], [], 0
    for fft in range(2048, 40001):
        cfg = SpecConfig(prg_mode="ZEROSPAN", fft_size=fft,
                         sampling_rate=2.4e6,
                         cur_scan_non_overlap=nono).finalize()
        port = cuda_curscan.kernel_route(cfg) == "fft"
        for u8 in (False, True):
            choice = jspec._fused_choice(cfg, u8)
            lane += choice == "lane" and fft % 128 != 0
            if choice is not None and not port:
                missed.append((fft, u8))
            if choice is None and port:
                extra.append((fft, u8))
    assert missed == [] and extra == []
    # The lane kernel's sizes off the 128 grid, each for u8 and f32 (the
    # count over this range: 4603 sizes at 50%, 1948 at 75%, 779 at 90%).
    assert lane == 2 * {0.5: 4603, 0.25: 1948, 0.1: 779}[nono]
