"""Port parity of the single-device streaming waterfall (``parallel/stream``)
against the JAX package at the main path's config (fft 2048, kaiser, 50%
overlap), T <= 8.  Tolerances as in ``torch_parity``: dB rows and curves
within 1e-3 dB wherever the reference is within 100 dB of its peak."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.parallel import stream as jst
from kspecanal_tpu_torch.parallel import stream as tst
from torch_parity import assert_db_close, blocks, zs_cfg

CFG = zs_cfg(2048)


def assert_result_close(got, want):
    for k in ("rows", "fft_max", "fft_min", "fft_avg", "fft_cur"):
        assert_db_close(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


@pytest.mark.parametrize("chain", ["LogNoGain", "LogNoGain.HistLowClip"])
def test_waterfall_stream_matches_jax(chain):
    """Also the per-row HistLowClip: the batch axis must not leak into its
    min/max."""
    cfg = dataclasses.replace(CFG, zero_span_disp_proc=chain)
    re, im = blocks(cfg, 6, seed=11)
    got = tst.waterfall_stream(torch.from_numpy(re), torch.from_numpy(im), cfg)
    want = jst.waterfall_stream(jnp.asarray(re), jnp.asarray(im), cfg)
    assert got.rows.shape == (6, cfg.x_res)
    assert_result_close(got, want)


def test_waterfall_stream_u8_matches_jax():
    raw = np.random.default_rng(12).integers(0, 256, (5, 2 * CFG.full_size),
                                             dtype=np.uint8)
    got = tst.waterfall_stream_u8(torch.from_numpy(raw), CFG)
    want = jst.waterfall_stream_u8(jnp.asarray(raw), CFG)
    assert_result_close(got, want)
    dec = tst.decode_u8_on_device(torch.from_numpy(raw))
    for g, w in zip(dec, jst.decode_u8_on_device(jnp.asarray(raw))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_run_stream_session_matches_jax(as_tensor):
    """Three chunks (3 + 3 + 2 blocks): the continuation weights of the
    exact affine AVG carry are exercised; inputs may be host numpy planes
    or tensors already on the device."""
    re, im = (p.reshape(-1) for p in blocks(CFG, 8, seed=13))
    want = jst.run_stream_session(re, im, CFG, chunk_blocks=3)
    src = (torch.from_numpy(re), torch.from_numpy(im)) if as_tensor \
        else (re, im)
    got = tst.run_stream_session(*src, CFG, "cpu", chunk_blocks=3)
    assert got.rows.shape == (8, CFG.x_res)
    assert_result_close(got, want)
    # ... and equals one unchunked batch of the same blocks
    whole = tst.waterfall_stream(torch.from_numpy(re.reshape(8, -1)),
                                 torch.from_numpy(im.reshape(8, -1)), CFG)
    assert_result_close(got, whole)


def test_stream_session_yields_rows_per_chunk():
    re, im = (p.reshape(-1) for p in blocks(CFG, 5, seed=14))
    gen = tst.stream_session(re, im, CFG, "cpu", chunk_blocks=2)
    sizes = []
    while True:
        try:
            ci, rows = next(gen)
            sizes.append((ci, rows.shape[0]))
        except StopIteration as stop:
            final = stop.value
            break
    assert sizes == [(0, 2), (1, 2), (2, 1)]
    assert final.rows is None and final.fft_avg.shape == (CFG.fft_size,)
