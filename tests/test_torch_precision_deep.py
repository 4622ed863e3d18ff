"""K1's HIGH and DEFAULT classes at 90% overlap (misaligned window starts,
71 windows) against the JAX sublane kernel in interpret mode: the port's
plain version (``ops/cuda_tc.py``) on the CPU, tolerances as in
``test_torch_precision.py``.  A file of its own so that its JAX builds,
the slowest of the classes' tests, run beside the others."""
import jax.numpy as jnp
import numpy as np
import pytest

from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu_torch.ops import cuda_tc
from kspecanal_tpu_torch.ops import spectrum as tspec
from test_torch_precision import (CLASSES, assert_class_close, gauss, port,
                                  tc_in_jax_form, window_peak)
from torch_parity import MODES, decoded, raw_planes, zs_cfg

DEEP = [(fft, mode) for fft in (256, 2048) for mode in MODES]
DEEP += [(1280, "AVG"), (1280, "MIN")]


@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("fft,mode", DEEP)
def test_k1_deep_overlap_f32_matches_jax(fft, mode, prec):
    """Float32 planes at 90% overlap (misaligned starts but at fft 1280,
    whose hop is 128): 3M at both classes, JAX's gate, on both sides."""
    cfg = zs_cfg(fft, 0.1, mode, tpu_precision=prec)
    re, im = gauss(cfg, 2, seed=fft + 90)
    want = np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(re), jnp.asarray(im), cfg, t_tile=2))
    got = tc_in_jax_form(re, im, cfg)
    assert_class_close(got, want, prec, window_peak(re, im, cfg))


@pytest.mark.parametrize("fft", [256, 384, 2048])
def test_k1_deep_overlap_u8_default_matches_jax(fft):
    """Raw u8 planes at 90% overlap and DEFAULT, the one cell where the JAX
    gate picks 4M: the JAX kernel on u8 (4M, bf16-staged frames) against
    the port's u8 through the dispatcher (4M, as everywhere), which equals
    its decoded float32 under ``no3m``."""
    cfg = zs_cfg(fft, 0.1, tpu_precision="DEFAULT")
    re, im = raw_planes(cfg, 2, seed=fft + 91)
    assert not cuda_tc.three_mult()
    want = np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(re), jnp.asarray(im), cfg, t_tile=2))
    got = port(tspec.curscan_auto_batched, re, im, cfg)
    np.testing.assert_array_equal(
        got, port(cuda_tc.curscan_tc, decoded(re), decoded(im), cfg,
                  form="no3m"))
    assert_class_close(got, want, "DEFAULT",
                       window_peak(decoded(re), decoded(im), cfg))
