"""The port's CUDA kernels on the card, against their plain PyTorch versions
on the same inputs (bounds in ``torch_parity.assert_spectra_close``; u8 input
bit-identical to decoded float32).  Every test needs a CUDA card and skips
without one.  The file imports no JAX, so on the machine with the card it
runs without the JAX package's test configuration:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import pytest
import torch

from kspecanal_tpu.config import WINDOW_HANNING, WINDOW_KAISER, WINDOW_ONES
from kspecanal_tpu_torch.ops import cuda_curscan, cuda_packed
from kspecanal_tpu_torch.ops import spectrum as tspec
from kspecanal_tpu_torch.parallel import stream as tstream
from torch_parity import (MODES, assert_db_close, assert_spectra_close,
                          cuda, decoded, raw_planes, zs_cfg)  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("fft,nono,window", [
    (2048, 0.5, WINDOW_KAISER), (2048, 0.1, WINDOW_KAISER),
    (256, 0.5, WINDOW_HANNING), (384, 0.5, WINDOW_HANNING),
    (8192, 0.5, WINDOW_KAISER), (16384, 0.1, WINDOW_ONES),
    (16384, 0.5, WINDOW_KAISER), (5120, 0.5, WINDOW_KAISER)])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain(cuda, fft, nono, window, mode):
    cfg = zs_cfg(fft, nono, mode, window=window, x_res=min(fft, 512))
    re, im = (torch.from_numpy(decoded(p)).to(cuda)
              for p in raw_planes(cfg, 16, seed=8))
    before = cuda_curscan.launches
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg)
    want = cuda_curscan.curscan_fused_sublane_plain(re, im, cfg)
    torch.cuda.synchronize()
    assert cuda_curscan.launches == before + 1
    assert_spectra_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("nono", [0.5, 0.1])
def test_kernel_u8_bit_identical(cuda, nono):
    cfg = zs_cfg(2048, nono)
    re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 16, 9))
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg)
    want = cuda_curscan.curscan_fused_sublane(tspec.decode_u8(re),
                                              tspec.decode_u8(im), cfg)
    assert torch.equal(got, want)


def test_wrapper_refuses_non_contiguous_on_card(cuda):
    cfg = zs_cfg(2048)
    wide = torch.zeros((2, 2 * cfg.full_size), device=cuda)
    with pytest.raises(ValueError):
        cuda_curscan.curscan_fused_sublane(wide[:, ::2], wide[:, 1::2], cfg)


def test_auto_dispatch_on_card(cuda):
    """fft 2048 and fmScan's 16384 launch the sublane kernel, quickFullScan's
    64 the packed kernel; fft 1000 takes the torch.fft chain, visibly
    without a launch."""
    for fft, nono, window, sub, packed in (
            (2048, 0.5, WINDOW_KAISER, 1, 0), (16384, 0.1, WINDOW_ONES, 1, 0),
            (64, 0.1, WINDOW_ONES, 0, 1), (1000, 0.5, WINDOW_HANNING, 0, 0)):
        cfg = zs_cfg(fft, nono, window=window, x_res=min(fft, 500))
        re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 2, 10))
        before = (cuda_curscan.launches, cuda_packed.launches)
        out = tspec.curscan_auto_batched(re, im, cfg)
        assert out.shape == (2, fft) and out.device.type == "cuda"
        assert (cuda_curscan.launches - before[0],
                cuda_packed.launches - before[1]) == (sub, packed)


@pytest.mark.parametrize("fft,nono,window", [
    (64, 0.1, WINDOW_ONES), (64, 0.5, WINDOW_KAISER),
    (128, 0.5, WINDOW_KAISER), (32, 0.25, WINDOW_KAISER)])
@pytest.mark.parametrize("mode", MODES)
def test_packed_kernel_matches_plain(cuda, fft, nono, window, mode):
    """fft 64 at 90% overlap with ones is quickFullScan's geometry; 1226
    blocks are one quickFullScan sweep."""
    cfg = zs_cfg(fft, nono, mode, window=window, x_res=fft)
    re, im = (torch.from_numpy(decoded(p)).to(cuda)
              for p in raw_planes(cfg, 1226, seed=12))
    before = cuda_packed.launches
    got = cuda_packed.curscan_fused_packed(re, im, cfg)
    want = cuda_packed.curscan_fused_packed_plain(re, im, cfg)
    torch.cuda.synchronize()
    assert cuda_packed.launches == before + 1
    assert_spectra_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("fft,nono", [(64, 0.1), (128, 0.5)])
def test_packed_kernel_u8_bit_identical(cuda, fft, nono):
    cfg = zs_cfg(fft, nono, x_res=fft)
    re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 37, 13))
    got = cuda_packed.curscan_fused_packed(re, im, cfg)
    want = cuda_packed.curscan_fused_packed(tspec.decode_u8(re),
                                            tspec.decode_u8(im), cfg)
    assert torch.equal(got, want)


def test_direct_dft_matches_chain_on_card(cuda):
    """fft 200 (no kernel takes it) runs the direct DFT matmul on the card."""
    cfg = zs_cfg(200, 0.5, window=WINDOW_HANNING, x_res=200)
    re, im = (torch.from_numpy(decoded(p)).to(cuda)
              for p in raw_planes(cfg, 8, 14))
    got = tspec.curscan_auto_batched(re, im, cfg)
    assert_spectra_close(got.cpu().numpy(),
                         tspec.curscan_batched(re, im, cfg).cpu().numpy())


def test_waterfall_stream_u8_on_card(cuda):
    cfg = zs_cfg(2048)
    re, im = raw_planes(cfg, 8, seed=11)
    raw = torch.stack([torch.from_numpy(re), torch.from_numpy(im)],
                      dim=-1).reshape(8, -1)
    got = tstream.waterfall_stream_u8(raw.to(cuda), cfg)
    want = tstream.waterfall_stream_u8(raw, cfg)
    for k in ("rows", "fft_max", "fft_min", "fft_avg", "fft_cur"):
        assert_db_close(getattr(got, k).cpu().numpy(),
                        getattr(want, k).numpy())
