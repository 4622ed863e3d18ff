"""The port's CUDA kernel on the card, against its plain PyTorch version on
the same inputs (bounds in ``torch_parity.assert_spectra_close``; u8 input
bit-identical to decoded float32).  Every test needs a CUDA card and skips
without one.  The file imports no JAX, so on the machine with the card it
runs without the JAX package's test configuration:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import pytest
import torch

from kspecanal_tpu.config import WINDOW_HANNING, WINDOW_KAISER
from kspecanal_tpu_torch.ops import cuda_curscan
from kspecanal_tpu_torch.ops import spectrum as tspec
from kspecanal_tpu_torch.parallel import stream as tstream
from torch_parity import (MODES, assert_db_close, assert_spectra_close,
                          cuda, decoded, raw_planes, zs_cfg)  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("fft,nono,window", [
    (2048, 0.5, WINDOW_KAISER), (2048, 0.1, WINDOW_KAISER),
    (256, 0.5, WINDOW_HANNING), (384, 0.5, WINDOW_HANNING),
    (8192, 0.5, WINDOW_KAISER)])
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
    """Supported configs launch the kernel; fft 16384 takes the torch.fft
    chain (beyond the kernel's shared memory), visibly without a launch."""
    for fft, launched in ((2048, 1), (16384, 0)):
        cfg = zs_cfg(fft)
        re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 2, 10))
        before = cuda_curscan.launches
        out = tspec.curscan_auto_batched(re, im, cfg)
        assert out.shape == (2, fft) and out.device.type == "cuda"
        assert cuda_curscan.launches == before + launched


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
