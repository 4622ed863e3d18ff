"""K3, the JAX package's lane curscan kernel (``pallas_curscan._kernel``,
entry ``curscan_fused``), and its counterpart in the port: the FFT kernel's
mixed-radix form, whose plain version is the ``torch.fft`` chain.

  * the port's copy of ``pallas_curscan.supports_fused`` equals the
    original, and the route equals the JAX choice, at sampled sizes up to
    2^20 (``_factorize``'s copy: test_torch_standalone.py);
  * the wrapper on CPU tensors (its plain version) against the JAX lane
    kernel run in interpret mode, at T=2: fft 2500 at 50% in all four
    cumulate modes and fft 3000 at 90% (AVG, MIN), bounds of
    ``torch_parity.assert_spectra_close``; u8 planes equal decoded float32
    exactly (the JAX package decodes u8 in XLA before K3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu import config as jcfg
from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu.ops import spectrum as jspec
from kspecanal_tpu_torch.ops import cuda_curscan
from torch_parity import assert_spectra_close, decoded, raw_planes, zs_cfg

# Sizes up to 2^20: every n from 2048 to 4095, then a stride, and the sizes
# the kernel's plans single out.
SAMPLED = sorted(set(range(2048, 4096)) | set(range(4096, (1 << 20) + 1, 997))
                 | {2500, 3000, 10000, 16256, 33250, 39800, 131100, 262144,
                    1 << 20})


@pytest.mark.parametrize("nono", [0.5, 0.25, 0.1])
def test_lane_predicate_and_route_equal_jax_up_to_2_20(nono):
    """``supports_fused`` equals the original, and the route is ``"fft"``
    exactly where ``_fused_choice`` picks a Pallas kernel, at every fifth
    sampled size from 2048 up (fft 2048 .. 2^20) and at every multiple of
    1000 up to 2^20."""
    sizes = (SAMPLED[::5]
             + list(range(2000, 1 << 20, 1000)) + [2500, 39800, 131100])
    taken = 0
    for fft in sizes:
        cfg = zs_cfg(fft, nono, x_res=min(fft, 512))
        assert cuda_curscan.supports_fused(cfg) == jpk.supports_fused(cfg)
        jax_takes = jspec._fused_choice(cfg, False) is not None
        assert (cuda_curscan.kernel_route(cfg) == "fft") == jax_takes, fft
        taken += jax_takes
    assert taken > 100, taken


def _lane_refs(fft, nono, mode):
    """Raw u8 noise planes (2, full_size) and the JAX lane kernel's output
    on them decoded to float32 (Pallas interpret mode on the CPU)."""
    kw = dict(prg_mode="ZEROSPAN", fft_size=fft, sampling_rate=2.4e6,
              window=jcfg.WINDOW_KAISER, cur_scan_non_overlap=nono,
              cur_scan_cumu_mode=mode)
    cfg = jcfg.SpecConfig(**kw).finalize()
    assert jspec._fused_choice(cfg, False) == "lane"
    re, im = raw_planes(cfg, 2, seed=fft + int(nono * 10) + len(mode))
    kern = np.asarray(jpk.curscan_fused(jnp.asarray(decoded(re)),
                                        jnp.asarray(decoded(im)), cfg))
    return re, im, kern


@pytest.mark.parametrize("fft,nono,mode", [
    (2500, 0.5, "AVG"), (2500, 0.5, "MAX"), (2500, 0.5, "MIN"),
    (2500, 0.5, "RAW"), (3000, 0.1, "AVG"), (3000, 0.1, "MIN")])
def test_plain_matches_jax_lane_kernel(fft, nono, mode):
    re, im, kern = _lane_refs(fft, nono, mode)
    cfg = zs_cfg(fft, nono, mode)
    assert cuda_curscan.kernel_route(cfg) == "fft"
    got = cuda_curscan.curscan_fused_sublane(
        torch.from_numpy(decoded(re)), torch.from_numpy(decoded(im)), cfg)
    assert got.shape == (2, fft) and got.dtype == torch.float32
    assert_spectra_close(got.numpy(), kern)
    u8 = cuda_curscan.curscan_fused_sublane(torch.from_numpy(re),
                                            torch.from_numpy(im), cfg)
    np.testing.assert_array_equal(u8.numpy(), got.numpy())
