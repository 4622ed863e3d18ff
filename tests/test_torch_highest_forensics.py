"""The forensic forms at HIGHEST on the tensor cores: K1's ``ablate`` keys
(``pallas_curscan.curscan_fused_sublane(..., ablate=keys)``) at every fft of
the sublane predicate, the six-pass class of the forensic builds against the
float64 oracle, and Kernel C's shared-memory limit at that class.

On the CPU ``cuda_curscan.curscan_fused_sublane(..., ablate)`` runs the plain
version of the HIGHEST builds (``cuda_tc.six_pass_matmul``: three bf16 parts
an operand, six products, float32 sums); the JAX side runs its kernel in
interpret mode at HIGHEST.  Above fft 16384 the keys used to raise
(``ablate cuts the direct-DFT kernel, which takes fft <= 16384``) where
JAX's kernel takes them: ROADMAP C5."""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu_torch.ops import cuda_curscan as cc
from kspecanal_tpu_torch.ops import cuda_tc, mxu_fft
from oracle import oracle_curscan
from torch_parity import assert_spectra_close, zs_cfg
from kspecanal_tpu_torch.config import window_lut

C5_KEYS = [("stage2",), ("stage1",), ("win",), ("sqrt",), ("cumulate",),
           ("concat",)]


def planes(cfg, t, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((t, cfg.full_size)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("keys", C5_KEYS, ids=[k[0] for k in C5_KEYS])
@pytest.mark.parametrize("fft", [32768, 16512])
def test_ablate_keys_above_16384_match_jax_fault_c5(fft, keys):
    """Fault C5: at HIGHEST above fft 16384 (32768, and 16512 = 129 x 128
    off the powers of two) every key, and the empty mask ('concat'), runs
    Kernel C's six-pass plain version on (fft / 128, 128), within the
    HIGHEST bound of JAX's kernel in interpret mode; kaiser, 50%, AVG."""
    cfg = zs_cfg(fft, tpu_precision="HIGHEST")
    re, im = planes(cfg, 1 if fft == 32768 else 2, fft + len(keys[0]))
    want = np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(re), jnp.asarray(im), cfg, ablate=keys))
    got = cc.curscan_fused_sublane(torch.from_numpy(re), torch.from_numpy(im),
                                   cfg, ablate=keys)
    assert got.shape == want.shape == (re.shape[0], fft)
    assert_spectra_close(got.numpy(), want)
    assert torch.equal(got, cuda_tc.curscan_tc_split(
        torch.from_numpy(re), torch.from_numpy(im), cfg,
        split=(fft // 128, 128), ablate=keys))


def oracle_error(got, re, im, cfg):
    """Worst bin over the blocks of |got - oracle| / (|oracle| + 1e-6)."""
    win = window_lut(cfg.window, cfg.fft_size)
    worst = 0.0
    for b in range(got.shape[0]):
        x = re[b].astype(np.float64) + 1j * im[b].astype(np.float64)
        want = oracle_curscan(x, cfg.fft_size, cfg.cur_scan_non_overlap, win,
                              cfg.cur_scan_cumu_mode)
        worst = max(worst, float(np.max(np.abs(got[b] - want)
                                        / (np.abs(want) + 1e-6))))
    return worst


@pytest.mark.parametrize("fft,t", [(2048, 4), (32768, 1)])
def test_six_passes_meet_the_bound_no_worse_than_high(fft, t):
    """Against the float64 oracle (kaiser, 50%, AVG, Gaussian planes) the
    HIGHEST builds' plain version with no stage removed is no worse than
    HIGH's (the bf16x3 class) at the same cell, and within 5e-5."""
    cfg = zs_cfg(fft, tpu_precision="HIGHEST")
    high = zs_cfg(fft, tpu_precision="HIGH")
    re, im = planes(cfg, t, 7)
    split = (fft // 128, 128)
    six = cc.curscan_fused_sublane(torch.from_numpy(re), torch.from_numpy(im),
                                   cfg, ablate=("concat",)).numpy()
    three = cuda_tc.curscan_tc_split_plain(
        torch.from_numpy(re), torch.from_numpy(im), high, None, split).numpy()
    err6 = oracle_error(six.astype(np.float64), re, im, cfg)
    err3 = oracle_error(three.astype(np.float64), re, im, high)
    assert err6 <= err3 and err6 <= 5e-5, (err6, err3)


def test_split3_and_the_six_pass_product():
    """``mxu_fft.split3_bf16``: three bf16 values whose sum is x within a
    float32 rounding; ``cuda_tc.six_pass_matmul`` within float32's rounding
    of the float64 product, where HIGH's split (``class_matmul``) is not;
    the kernels' tables hold the three parts' bits (``bf16_halves``)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, mid, lo = mxu_fft.split3_bf16(x)
    for part in (hi, mid, lo):
        assert torch.equal(part, mxu_fft.round_bf16(part))
    assert torch.all((hi + mid + lo - x).abs() <= 2.0 ** -23 * x.abs())
    a, b = (torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32)) for _ in range(2))
    exact = a.double() @ b.double().T
    scale = (a.double().abs() @ b.double().abs().T).max()
    six = (cuda_tc.six_pass_matmul(a, b.T).double() - exact).abs().max()
    bf3 = (mxu_fft.class_matmul(a, b.T, "HIGH").double()
           - exact).abs().max()
    assert six <= 2e-7 * scale < bf3
    bits = cuda_tc.bf16_halves(x.numpy(), 3)
    for part, bit in zip((hi, mid, lo), bits):
        assert np.array_equal(part.to(torch.bfloat16).view(torch.int16)
                              .numpy().view(np.uint16), bit)


def test_kernel_c_shared_memory_limit_at_highest():
    """Kernel C's widest n2 (16 rows of C in a block's 232,448 bytes) at
    each class and form: HIGHEST's third part a form lowers HIGH's 1808 to
    1200 (4M) and 1200 to 784 (3M); the sublane split's n2 = 128 fits at
    every class, so the ablate keys at HIGHEST take every fft above 16384
    (2^20 and 2^20 + 128 here)."""
    want = {("DEFAULT", False): 3616, ("DEFAULT", True): 2400,
            ("HIGH", False): 1808, ("HIGH", True): 1200,
            ("HIGHEST", False): 1200, ("HIGHEST", True): 784}
    for (prec, tm), n2 in want.items():
        assert cuda_tc.tc_split_max_n2(prec, tm) == n2
        planes_ = (3 if tm else 2) * (cuda_tc.PREC_CODE[prec] + 1)
        assert planes_ * 16 * (n2 + 8) * 2 <= 232448
        assert planes_ * 16 * (n2 + 16 + 8) * 2 > 232448
        assert 128 <= n2
    for fft in (1 << 20, (1 << 20) + 128):
        cfg = zs_cfg(fft, tpu_precision="HIGHEST")
        assert cuda_tc.supports_highest_forensics(cfg)
        assert cc.kernel_route(cfg) == "fft"


class _Lib:
    """A stand-in HIGHEST ablate build of Kernel C: records its launches;
    ``mt`` m-tiles a block (0: C does not fit)."""

    def __init__(self, mt):
        self.mt, self.calls = mt, []

    def kspec_curscan_tc_split_mt(self, *args):
        return self.mt

    def kspec_curscan_tc_split_occupancy(self, *args):
        return 1

    def kspec_curscan_tc_split_ablate(self, *args):
        self.calls.append(args)
        return 0

    def __hash__(self):
        return id(self)


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev=None: types.SimpleNamespace(multi_processor_count=132))

    def use(lib):
        monkeypatch.setattr(cuda_tc, "tc_split_ablate_library",
                            lambda highest=False: lib)
    return use


def test_card_dispatch_of_kernel_c_at_highest(fake_card):
    """On the card the HIGHEST keys above fft 16384 launch Kernel C's
    HIGHEST ablate build on (n / 128, 128) at precision 2, with the
    three-part tables (9 slots a table), counted in
    ``tc_split_ablate_launches``; where 16 rows of C do not fit (a split
    wider than the limit) the launch raises naming the limit."""
    lib = _Lib(4)
    fake_card(lib)
    cfg = zs_cfg(32768, tpu_precision="HIGHEST")
    p = torch.empty((2, cfg.full_size), device="meta")
    before = (cuda_tc.tc_split_ablate_launches, cc.launches,
              cc.direct_launches)
    out = cc.curscan_fused_sublane(p, p, cfg, ablate=("stage1", "no3m"))
    assert out.shape == (2, 32768)
    assert (cuda_tc.tc_split_ablate_launches, cc.launches,
            cc.direct_launches) == (before[0] + 1, before[1], before[2])
    [args] = lib.calls
    assert args[14:16] == (256, 128)
    assert args[-4] == 2 and args[-3] == 0
    assert args[-2] == cc.ablate_mask(("stage1",))
    f1, f2, _ = cuda_tc.tc_split_tables(256, 128, torch.device("cpu"), 3)
    assert f1.shape[0] == f2.shape[0] == 9
    wide = zs_cfg(16384 * 3, tpu_precision="HIGHEST")
    q = torch.empty((1, wide.full_size), device="meta")
    fake_card(_Lib(0))
    with pytest.raises(ValueError, match="n2 <= 1200 fits"):
        cuda_tc.curscan_tc_split(q, q, wide, split=(16, 3072),
                                 ablate=("win",))
