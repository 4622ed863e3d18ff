"""The port's CUDA kernels on the card, against their plain PyTorch versions
on the same inputs (bounds in ``torch_parity.assert_spectra_close``; u8 input
bit-identical to decoded float32).  K1's FFT kernel and K2 are held to
their plain versions run in float64 on the same planes: the float32
``torch.fft`` chain itself misses the per-bin bound against float64 on MIN
folds at 90% overlap above fft 16384 (up to 1.5 times the bound) and over
the 951 windows of fft 64 with fft2FullMult 96 (1.19 times), while the
kernels, whose butterflies run in float64, stay well inside it.  Every test needs a
CUDA card and skips without one.  The file imports no JAX, so on the machine
with the card it runs without the JAX package's test configuration:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import pytest
import torch

from kspecanal_tpu_torch.config import (WINDOW_HANNING, WINDOW_KAISER,
                                        WINDOW_ONES)
from kspecanal_tpu_torch.io import sources as tsrc
from kspecanal_tpu_torch.ops import cuda_curscan, cuda_packed, cuda_tc
from kspecanal_tpu_torch.ops import spectrum as tspec
from kspecanal_tpu_torch.parallel import stream as tstream
from kspecanal_tpu_torch.scripts import kernel_ablate
from torch_parity import (MODES, assert_db_close, assert_spectra_close,
                          assert_tc_close, cuda, decoded, raw_planes,
                          zs_cfg)  # noqa: F401

pytestmark = pytest.mark.gpu

POW2 = [1 << e for e in range(8, 18)]          # 256 .. 131072
# The mixed-radix kernel: one block, clusters of 2 and 8, the scratch route.
MIXED = [384, 1280, 3072, 16256, 20480, 98304, 130944, 262144]
# The lane kernel's (K3's) sizes off the 128 grid, with the overlaps at
# which the JAX dispatcher sends them to it: one block (2500, 3000; 10000
# with 16 points a thread; 2050 = 2 * 5^2 * 41 and 11110 = 2 * 5 * 11 * 101
# with a prime >= 17), a cluster of 4 (39800 = 200 * 199), the scratch
# route (33250 = 2 * odd, c = 5; 131100, c = 10).
LANE = [(2500, 0.5), (2500, 0.1), (3000, 0.5), (3000, 0.1), (10000, 0.5),
        (10000, 0.1), (39800, 0.5), (39800, 0.1), (33250, 0.5),
        (131100, 0.5), (131100, 0.1), (2050, 0.5), (2050, 0.1),
        (11110, 0.5), (11110, 0.1)]


def planes_on(cuda, cfg, t, seed):
    return tuple(torch.from_numpy(decoded(p)).to(cuda)
                 for p in raw_planes(cfg, t, seed))


def plain64(re, im, cfg):
    """The plain version in float64 on the same planes, as float32."""
    return cuda_curscan.curscan_fused_sublane_plain(
        re.double(), im.double(), cfg).float()


def counts():
    return cuda_curscan.launches, cuda_curscan.direct_launches


KERNEL_CASES = [
    (256, 0.5, WINDOW_HANNING), (384, 0.5, WINDOW_HANNING),
    (16384, 0.1, WINDOW_ONES), (5120, 0.5, WINDOW_KAISER)] + [
    (fft, nono, WINDOW_KAISER) for fft in POW2 for nono in (0.5, 0.1)]


@pytest.mark.parametrize("fft,nono,window", KERNEL_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain(cuda, fft, nono, window, mode):
    """K1's wrapper: every power of two it takes (a cluster above 16384) at
    50% and 90% overlap, and 384 and 5120, launch the FFT kernel; all four
    cumulate modes."""
    cfg = zs_cfg(fft, nono, mode, window=window, x_res=min(fft, 512))
    re, im = planes_on(cuda, cfg, 16 if fft <= 16384 else 3, seed=fft + 1)
    before = counts()
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg)
    want = plain64(re, im, cfg)
    torch.cuda.synchronize()
    fft_route = cuda_curscan.kernel_route(cfg) == "fft"
    assert counts() == (before[0] + fft_route, before[1] + (not fft_route))
    assert bool(got.isfinite().all())
    assert_spectra_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("fft", POW2)
def test_kernel_u8_bit_identical(cuda, fft, nono):
    cfg = zs_cfg(fft, nono, x_res=min(fft, 512))
    re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 4, 9))
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg)
    want = cuda_curscan.curscan_fused_sublane(tspec.decode_u8(re),
                                              tspec.decode_u8(im), cfg)
    assert torch.equal(got, want)


def bound_share(got, want):
    """The largest per-bin error as a share of the bound (5e-5 of the bin
    plus 1e-6 of the peak)."""
    err = (got.double() - want.double()).abs()
    ref = want.double().abs()
    return (err / (5e-5 * ref + 1e-6 * ref.max())).max().item()


@pytest.mark.parametrize("parent", [False, True], ids=["float64", "parent"])
@pytest.mark.parametrize("stage", cuda_curscan.FFT_STAGES)
@pytest.mark.parametrize("fft", POW2)
def test_fft_stage_matches_plain(cuda, fft, stage, parent):
    """The power-of-two kernel cut off after each stage (its forensic
    builds, both forms) against its plain version in float64, one launch
    counted in ``fft_stage_launches`` (``fft_parent_launches``): below
    'full' within 1e-6 of the peak, 'full' within the per-bin bound; the
    float64 form's 'full' is the production kernel, bit for bit."""
    cfg = zs_cfg(fft, 0.1, "MIN", x_res=min(fft, 512))
    re, im = planes_on(cuda, cfg, 4 if fft <= 16384 else 2, seed=fft + 5)
    before = (cuda_curscan.fft_stage_launches,
              cuda_curscan.fft_parent_launches)
    got = cuda_curscan.curscan_fft_stage(re, im, cfg, stage, parent)
    want = cuda_curscan.curscan_fft_stage_plain(re, im, cfg, stage, parent)
    torch.cuda.synchronize()
    assert (cuda_curscan.fft_stage_launches,
            cuda_curscan.fft_parent_launches) == (before[0] + (not parent),
                                                  before[1] + parent)
    if stage == "full":
        assert bound_share(got, want) <= 1.0
        if not parent:
            assert torch.equal(
                got, cuda_curscan.curscan_fused_sublane(re, im, cfg))
    else:
        err = (got.double() - want).abs().max().item()
        assert err <= 1e-6 * want.abs().max().item()


@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("fft", POW2)
def test_kernel_no_less_accurate_than_its_parent_form(cuda, fft, nono):
    """At every power of two the production kernel's worst share of the
    per-bin bound on a MIN fold stays within 1.1 times the parent form's
    (the float64 form rounds once, at |X|^2)."""
    cfg = zs_cfg(fft, nono, "MIN", x_res=min(fft, 512))
    re, im = planes_on(cuda, cfg, 4 if fft <= 16384 else 2, seed=fft + 6)
    want = plain64(re, im, cfg)
    share = bound_share(cuda_curscan.curscan_fused_sublane(re, im, cfg),
                        want)
    parent = bound_share(
        cuda_curscan.curscan_fft_stage(re, im, cfg, "full", True), want)
    assert share <= 1.1 * parent


def test_fft_kernel_registers_and_occupancy(cuda):
    """The production power-of-two kernel (``kspec_curscan_fft_attrs``),
    its float64 form at every power of two: at most 128 registers with 16
    resident warps an SM (fft 2048: 4 blocks of 128 threads; from 8192 one
    block of 512), its shared memory m double2 plus, at one block a window
    where the frame is at most 8 KB (fft 1024 on float32, 4096 on u8), the
    staged frame (2m samples)."""
    from kspecanal_tpu_torch.ops import _build
    lib = _build.load()
    for fft in POW2:
        for u8 in (False, True):
            a = cuda_curscan.fft_attrs(lib, fft, u8)
            c = cuda_curscan.fft_plan(fft)[0]
            m = fft // c
            frame = 2 * m * (1 if u8 else 4)
            stage = frame if c == 1 and frame <= 8192 else 0
            assert a["registers"] <= 128
            assert a["smem_bytes"] == 16 * m + stage
            assert a["blocks_per_sm"] * max(m // 16, 32) // 32 >= 16


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("fft", POW2[:6])
def test_frame_staging_changes_no_bit(cuda, fft, u8):
    """The builds that stage no frame and every frame of one block a
    window (``cuda_curscan.fft_staging_variant``, timed by
    ``scripts/fft_stages.py --staging``) give the production kernel's
    output bit for bit, at 50% overlap (aligned starts: staged) and 90%
    (not staged)."""
    for nono in (0.5, 0.1):
        cfg = zs_cfg(fft, nono, "MIN", x_res=min(fft, 512))
        raw = raw_planes(cfg, 3, seed=fft + 13)
        re, im = (torch.from_numpy(p if u8 else decoded(p)).to(cuda)
                  for p in raw)
        want = cuda_curscan.curscan_fused_sublane(re, im, cfg)
        for stage_bytes in (0, 1 << 17):
            got = cuda_curscan.curscan_fft_stage(re, im, cfg, "full",
                                                 stage_bytes=stage_bytes)
            assert torch.equal(got, want)


@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("mode", ["AVG", "MAX", "MIN"])
@pytest.mark.parametrize("fft", MIXED)
def test_mixed_kernel_matches_plain64(cuda, fft, mode, nono):
    """Multiples of 128 that are not powers of two, and fft 262144, run the
    FFT kernel's mixed-radix form through the dispatcher, counted in
    ``launches`` and not in ``direct_launches``, against the plain version
    in float64."""
    cfg = zs_cfg(fft, nono, mode, window=WINDOW_HANNING, x_res=min(fft, 512))
    re, im = planes_on(cuda, cfg, 4 if fft <= 16384 else 2, seed=fft)
    before = counts()
    got = tspec.curscan_auto_batched(re, im, cfg)
    want = plain64(re, im, cfg)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1])
    assert bool(got.isfinite().all())
    assert_spectra_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("fft", [1280, 20480, 262144])
def test_mixed_kernel_u8_bit_identical(cuda, fft):
    cfg = zs_cfg(fft, 0.1, x_res=512)
    re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 2, 19))
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg)
    want = cuda_curscan.curscan_fused_sublane(tspec.decode_u8(re),
                                              tspec.decode_u8(im), cfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fft,nono", LANE)
@pytest.mark.parametrize("mode", MODES)
def test_lane_sizes_match_plain64(cuda, fft, nono, mode):
    """K3's cells off the 128 grid run the FFT kernel's mixed-radix form
    through the dispatcher (the ragged plan where 16 does not divide a
    block's points), counted in ``launches``, against the plain version in
    float64."""
    cfg = zs_cfg(fft, nono, mode, x_res=500)
    assert cuda_curscan.kernel_route(cfg) == "fft"
    re, im = planes_on(cuda, cfg, 4 if fft <= 16384 else 2, seed=fft + 2)
    before = counts()
    got = tspec.curscan_auto_batched(re, im, cfg)
    want = plain64(re, im, cfg)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1])
    assert bool(got.isfinite().all())
    assert_spectra_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("fft", [3000, 33250, 131100])
def test_lane_sizes_u8_bit_identical(cuda, fft):
    cfg = zs_cfg(fft, 0.5, x_res=500)
    re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 2, 20))
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg)
    want = cuda_curscan.curscan_fused_sublane(tspec.decode_u8(re),
                                              tspec.decode_u8(im), cfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fft,nono", [(3000, 0.1), (16256, 0.1)])
def test_mixed_kernel_gives_identical_bits_twice(cuda, fft, nono):
    """No atomics: the window groups combine in group order."""
    cfg = zs_cfg(fft, nono, "MIN", x_res=500)
    re, im = planes_on(cuda, cfg, 4, seed=fft + 3)
    assert torch.equal(cuda_curscan.curscan_fused_sublane(re, im, cfg),
                       cuda_curscan.curscan_fused_sublane(re, im, cfg))


@pytest.mark.parametrize("stage", cuda_curscan.MIXED_STAGES)
@pytest.mark.parametrize("fft", [3000, 16256, 39800, 33250])
def test_mixed_stage_matches_plain(cuda, fft, stage):
    """The mixed kernel cut off after each stage (one block, a cluster of
    4, the scratch route) against its plain version in float64, counted in
    ``forensic_launches``; 'full' is the production kernel, bit for bit."""
    cfg = zs_cfg(fft, 0.5, x_res=500)
    re, im = planes_on(cuda, cfg, 2, seed=fft + 4)
    before = cuda_curscan.forensic_launches
    got = cuda_curscan.curscan_mixed_stage(re, im, cfg, stage)
    want = cuda_curscan.curscan_mixed_stage_plain(re, im, cfg, stage)
    torch.cuda.synchronize()
    assert cuda_curscan.forensic_launches == before + 1
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item()
    if stage == "full":
        assert torch.equal(got,
                           cuda_curscan.curscan_fused_sublane(re, im, cfg))


def test_wrapper_refuses_non_contiguous_on_card(cuda):
    cfg = zs_cfg(2048)
    wide = torch.zeros((2, 2 * cfg.full_size), device=cuda)
    with pytest.raises(ValueError):
        cuda_curscan.curscan_fused_sublane(wide[:, ::2], wide[:, 1::2], cfg)


def test_auto_dispatch_on_card(cuda):
    """fft 2048, fmScan's 16384, 65536 and 1280 launch K1's FFT kernel
    (no session launches the direct kernel), quickFullScan's 64 the packed
    kernel; fft 1000 takes the torch.fft chain, visibly without a
    launch."""
    for fft, nono, window, sub, direct, packed in (
            (2048, 0.5, WINDOW_KAISER, 1, 0, 0),
            (16384, 0.1, WINDOW_ONES, 1, 0, 0),
            (65536, 0.1, WINDOW_KAISER, 1, 0, 0),
            (1280, 0.5, WINDOW_HANNING, 1, 0, 0),
            (64, 0.1, WINDOW_ONES, 0, 0, 1),
            (1000, 0.5, WINDOW_HANNING, 0, 0, 0)):
        cfg = zs_cfg(fft, nono, window=window, x_res=min(fft, 500))
        re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 2, 10))
        before = (*counts(), cuda_packed.launches)
        out = tspec.curscan_auto_batched(re, im, cfg)
        assert out.shape == (2, fft) and out.device.type == "cuda"
        after = (*counts(), cuda_packed.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (
            sub, direct, packed)


PACKED_FFTS = [2, 4, 8, 16, 32, 64, 128]
# Fault C2, both directions: fft 128 mult 81 at 50% (JAX's kernel, the
# port's matmul before) and fft 64 mult 96 at 90% (the port's kernel, JAX's
# matmul); fft 128 x 399 walks its block in chunks.
PACKED_BIG = [(128, 0.5, 81), (64, 0.1, 96), (16, 0.1, 152),
              (128, 0.5, 399)]


def packed_case(cuda, cfg, t, seed):
    """K2 through the dispatcher against its plain version run in float64:
    one launch, no direct-DFT matmul."""
    re, im = (torch.from_numpy(decoded(p)).to(cuda)
              for p in raw_planes(cfg, t, seed))
    before = cuda_packed.launches
    real = tspec.curscan_direct_batched
    tspec.curscan_direct_batched = None       # any call would fail
    try:
        got = tspec.curscan_auto_batched(re, im, cfg)
    finally:
        tspec.curscan_direct_batched = real
    want = cuda_packed.curscan_fused_packed_plain(re.double(), im.double(),
                                                  cfg)
    torch.cuda.synchronize()
    assert cuda_packed.launches == before + 1
    assert bool(got.isfinite().all())
    assert_spectra_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("fft,nono,window", [
    (64, 0.1, WINDOW_ONES), (64, 0.5, WINDOW_KAISER),
    (128, 0.5, WINDOW_KAISER), (32, 0.25, WINDOW_KAISER)])
@pytest.mark.parametrize("mode", MODES)
def test_packed_kernel_matches_plain(cuda, fft, nono, window, mode):
    """fft 64 at 90% overlap with ones is quickFullScan's geometry; 1226
    blocks are one quickFullScan sweep, 19616 sixteen (catch-up: several
    IQ blocks a thread block)."""
    cfg = zs_cfg(fft, nono, mode, window=window, x_res=fft)
    for t in (1226, 19616 if (fft, nono) == (64, 0.1) else 37):
        packed_case(cuda, cfg, t, seed=12)


@pytest.mark.parametrize("nono", [0.5, 0.25, 0.1])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fft", PACKED_FFTS)
def test_packed_kernel_every_fft_matches_plain(cuda, fft, mode, nono):
    """Every fft K2 takes, 2-128 (blocks of at least 256 samples): P = N
    points a lane up to 16, then 8 x 4, 8 x 8 and 16 x 8 lanes."""
    cfg = zs_cfg(fft, nono, mode, x_res=fft,
                 fft2full_mult4less=max(8, 256 // fft))
    packed_case(cuda, cfg, 300, seed=fft)


@pytest.mark.parametrize("mode", ["AVG", "MIN"])
@pytest.mark.parametrize("fft,nono,mult", PACKED_BIG)
def test_packed_kernel_takes_the_c2_cells(cuda, fft, nono, mult, mode):
    cfg = zs_cfg(fft, nono, mode, x_res=fft, fft2full_mult4less=mult)
    packed_case(cuda, cfg, 64, seed=mult)


@pytest.mark.parametrize("fft,nono,mult,t", [
    (64, 0.1, 8, 37), (128, 0.5, 81, 37), (64, 0.1, 96, 37),
    (64, 0.1, 8, 19616)])
def test_packed_kernel_u8_bit_identical(cuda, fft, nono, mult, t):
    """u8 planes give the bits of their decoded float32, at quickFullScan's
    catch-up batch too, where the smaller u8 spans must not change how the
    plan splits the windows."""
    cfg = zs_cfg(fft, nono, x_res=fft, fft2full_mult4less=mult)
    re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, t, 13))
    got = cuda_packed.curscan_fused_packed(re, im, cfg)
    want = cuda_packed.curscan_fused_packed(tspec.decode_u8(re),
                                            tspec.decode_u8(im), cfg)
    assert torch.equal(got, want)


def test_packed_kernel_gives_identical_bits_twice(cuda):
    """The partial folds combine in group order, without atomics."""
    cfg = zs_cfg(64, 0.1, window=WINDOW_ONES, x_res=64)
    re, im = (torch.from_numpy(decoded(p)).to(cuda)
              for p in raw_planes(cfg, 19616, 21))
    assert torch.equal(cuda_packed.curscan_fused_packed(re, im, cfg),
                       cuda_packed.curscan_fused_packed(re, im, cfg))


# K2's cut-offs (csrc/curscan_packed.cu with -DKSPEC_PACKED_STOP=1..4) of
# both forms, every fft it takes, at a chunked plan (fft 64 x 96, MIN: 951
# windows) and quickFullScan's catch-up geometry.
PACKED_STAGE_CASES = [(fft, 0.25, "AVG", max(8, 256 // fft), 37)
                      for fft in PACKED_FFTS] + [
    (64, 0.1, "MIN", 96, 19), (64, 0.1, "RAW", 8, 1226)]


@pytest.mark.parametrize("parent", [False, True], ids=["new", "parent"])
@pytest.mark.parametrize("stage", cuda_packed.STAGES)
@pytest.mark.parametrize("fft,nono,mode,mult,t", PACKED_STAGE_CASES)
def test_packed_stage_matches_plain(cuda, fft, nono, mode, mult, t, stage,
                                    parent):
    """Each cut-off of both forms against its plain version in float64,
    one launch counted in ``stage_launches`` (``parent_launches``), within
    the per-bin bound (below 'full' the folded value is |re + im|); the
    production form's 'full' is the production kernel, bit for bit."""
    cfg = zs_cfg(fft, nono, mode, x_res=fft, fft2full_mult4less=mult)
    re, im = planes_on(cuda, cfg, t, seed=fft + mult)
    before = (cuda_packed.stage_launches, cuda_packed.parent_launches)
    got = cuda_packed.curscan_packed_stage(re, im, cfg, stage, parent)
    want = cuda_packed.curscan_packed_stage_plain(re, im, cfg, stage, parent)
    torch.cuda.synchronize()
    assert (cuda_packed.stage_launches, cuda_packed.parent_launches) == (
        before[0] + (not parent), before[1] + parent)
    assert bound_share(got, want) <= 1.0
    if stage == "full" and not parent:
        assert torch.equal(got, cuda_packed.curscan_fused_packed(re, im, cfg))


@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("fft,mult", [(f, max(8, 256 // f))
                                      for f in PACKED_FFTS]
                         + [(64, 96), (128, 81), (128, 399)])
def test_packed_kernel_no_less_accurate_than_its_parent_form(cuda, fft, mult,
                                                             nono):
    """On a MIN fold the production form's worst share of the per-bin
    bound stays within 1.1 times the parent form's."""
    cfg = zs_cfg(fft, nono, "MIN", x_res=fft, fft2full_mult4less=mult)
    re, im = planes_on(cuda, cfg, 64, seed=fft + mult + 7)
    want = cuda_packed.curscan_fused_packed_plain(re.double(), im.double(),
                                                  cfg)
    share = bound_share(cuda_packed.curscan_fused_packed(re, im, cfg), want)
    parent = bound_share(
        cuda_packed.curscan_packed_stage(re, im, cfg, "full", True), want)
    assert share <= 1.1 * parent


def test_packed_kernel_occupancy_against_its_parent_form(cuda):
    """At quickFullScan's plans (T = 1226 and 19616, f32 and u8) and fft 32
    the production form holds no fewer blocks an SM than the parent form
    (four of 256 threads, 64 registers), and fft 128 (P = 16) at least
    two where the parent held one."""
    from kspecanal_tpu_torch.ops import _build
    lib, parent = _build.load(), cuda_packed.stage_library("full", True)
    for fft, t in ((64, 1226), (64, 19616), (32, 4096), (128, 4096)):
        cfg = zs_cfg(fft, 0.1 if fft == 64 else 0.5, x_res=fft)
        for u8 in (False, True):
            new = cuda_packed.attrs(lib, cfg, t, u8)
            old = cuda_packed.attrs(parent, cfg, t, u8, parent=True)
            if fft == 128:
                assert (old["blocks_per_sm"], new["blocks_per_sm"]) == (1, 2)
            else:
                assert new["blocks_per_sm"] >= old["blocks_per_sm"] == 4
                assert new["registers"] <= 64


# The tensor-core kernels of the HIGH and DEFAULT classes (ops/cuda_tc.py)
# against their plain versions on the card: every instantiation (class x
# complex form x input x m-tiles a pass), all four modes; Kernel A at odd
# and small n1 (fft 1280: n1 = 10, padded to 16; fft 16256: n1 = 127), the
# main path's 2048, fft 4096 (two windows a pass), 8192 (four m-tiles of
# one window), 10240-14336 (n1p 80-112: stage 1 by m-tiles with F1 in
# shared memory or in L2, 3M HIGH folding in device memory from 112) and
# the lane kernel's cell 16384, at aligned (50%) and misaligned (90%)
# starts; and the pass sizes 1, 2 and 3 windows (fft 2048 with one, two
# and three windows a block).  Tolerances: torch_parity.TC_TOL.
TC_CASES = [(fft, nono, 8) for fft in (256, 1280, 2048, 4096, 8192, 10240,
                                       12288, 14336, 16256, 16384)
            for nono in (0.5, 0.1)] + [(2048, 1.0, 1), (2048, 0.75, 2),
                                       (2048, 0.5, 2)]


def class_planes(cuda, cfg, t, u8, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if u8:
        return tuple(torch.randint(0, 256, (t, cfg.full_size), generator=gen,
                                   device=cuda, dtype=torch.uint8)
                     for _ in range(2))
    return tuple(torch.randn((t, cfg.full_size), generator=gen, device=cuda)
                 for _ in range(2))


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("form", ["force3m", "no3m"])
@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fft,nono,mult", TC_CASES)
def test_tc_kernel_matches_plain(cuda, fft, nono, mult, mode, prec, form,
                                 u8):
    cfg = zs_cfg(fft, nono, mode, tpu_precision=prec, x_res=512,
                 fft2full_mult4less=mult)
    re, im = class_planes(cuda, cfg, 48 if fft <= 2048 else 4, u8, fft)
    before = (cuda_tc.tc_launches, cuda_curscan.launches)
    got = cuda_tc.curscan_tc(re, im, cfg, form)
    torch.cuda.synchronize()
    assert (cuda_tc.tc_launches, cuda_curscan.launches) == (
        before[0] + 1, before[1])
    assert_tc_close(got.cpu().numpy(), cuda_tc.curscan_tc_plain(
        re, im, cfg, form).cpu().numpy(), prec)
    if u8:
        assert torch.equal(got, cuda_tc.curscan_tc(
            tspec.decode_u8(re), tspec.decode_u8(im), cfg, form))


@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("fft,nono,t", [(2048, 0.5, 4096), (16384, 0.1, 16),
                                        (2048, 0.1, 1), (4096, 0.5, 1024),
                                        (8192, 0.1, 300), (10240, 0.1, 300),
                                        (14336, 0.5, 300),
                                        (16384, 0.1, 288)])
def test_tc_kernel_window_groups(cuda, fft, nono, t, prec):
    """Through the dispatcher: one window group a block at the main cell's
    T=4096, several (and the combine pass) for short batches and where one
    group would leave a wave part-empty (fmScan's 288 blocks at fft 16384),
    at every pass size and stage-1 route of the production (4M) form; two
    runs bit-identical."""
    cfg = zs_cfg(fft, nono, tpu_precision=prec, x_res=512)
    re, im = class_planes(cuda, cfg, t, False, t)
    got = tspec.curscan_auto_batched(re, im, cfg)
    assert torch.equal(got, tspec.curscan_auto_batched(re, im, cfg))
    rows = slice(0, 64)
    assert_tc_close(got[rows].cpu().numpy(), cuda_tc.curscan_tc_plain(
        re[rows], im[rows], cfg).cpu().numpy(), prec)


@pytest.mark.parametrize("form", ["force3m", "no3m"])
@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("fft,nono,t", [(2048, 0.5, 300), (10240, 0.1, 64),
                                        (14336, 0.1, 64), (16384, 0.1, 300)])
def test_tc_kernel_gives_identical_bits_twice(cuda, fft, nono, t, prec,
                                              form):
    """Kernel A twice on the same planes, bit for bit: each output element
    folded by one lane in window order, in shared memory or (3M HIGH from
    n1p = 112) in device memory, the groups combined in order."""
    cfg = zs_cfg(fft, nono, "MIN", tpu_precision=prec, x_res=512)
    re, im = class_planes(cuda, cfg, t, False, fft + 1)
    assert torch.equal(cuda_tc.curscan_tc(re, im, cfg, form),
                       cuda_tc.curscan_tc(re, im, cfg, form))


def test_tc_shared_memory_and_occupancy(cuda):
    """Kernel A's shared memory a block (``kspec_curscan_tc_smem``): bf16
    planes of 272-byte rows, the float32 fold of 544-byte rows and F1's
    fragments, each where it fits; every instantiation fits a block and
    holds at least one an SM, as many as an SM's shared memory allows at
    most, the main cell's two."""
    from kspecanal_tpu_torch.ops import _build
    lib = _build.load()

    def smem(n1, wb, high=False, tm=False):
        return lib.kspec_curscan_tc_smem(n1, wb, int(high), int(tm))
    # The main cell, 4 windows of 16 rows a pass: 2 planes (4 at HIGH).
    assert smem(16, 4) == 2 * 64 * 272 + 16 * 544 + 2 * 512
    assert smem(16, 4, high=True) == 4 * 64 * 272 + 16 * 544 + 4 * 512
    assert smem(32, 2) == 34816 + 17408 + 4096
    # n1 = 128: DEFAULT 4M keeps F1 (64 KiB); HIGH and 3M read it from L2;
    # 3M HIGH from n1p = 112 also folds in device memory.
    assert smem(128, 1) == 69632 + 69632 + 65536
    assert smem(128, 1, high=True) == 139264 + 69632
    assert smem(128, 1, tm=True) == 104448 + 69632
    assert smem(128, 1, high=True, tm=True) == 208896
    assert smem(112, 1, high=True, tm=True) == 182784
    assert smem(96, 1, high=True, tm=True) == 156672 + 52224
    for n1 in range(2, 129):
        for w in (1, 2, 3, 15):
            wb = cuda_tc.tc_windows_per_pass(n1, w)
            for high in (False, True):
                for tm in (False, True):
                    b = smem(n1, wb, high, tm)
                    assert (-(-n1 // 16) * 16 * wb * 272
                            * (3 if tm else 2) * (2 if high else 1) <= b
                            <= 232448)
                    per_sm = cuda_tc.tc_occupancy(lib, False, n1, wb, high,
                                                  tm)
                    assert 1 <= per_sm and per_sm * (b + 1024) <= 233472
    # The main cell's instantiation (DEFAULT 4M, 4 windows of n1 = 16).
    assert cuda_tc.tc_occupancy(lib, False, 16, 4, False, False) == 2


# Kernel C (``cuda_tc.curscan_tc_split``) on the JAX dispatcher's splits:
# K3's cells off the 128 grid (2050 = 50 x 41 and 39800 = 200 x 199 with
# odd n2; 3000 = 60 x 50; 10000 = 100 x 100; 131100 = 380 x 345) and the
# grid above fft 16384 (32768 = 256 x 128 at 50% and 90%; 65536, which
# takes 256 x 256 on float32 and 512 x 128 on u8 planes at DEFAULT; 131072
# = 1024 x 128 at 90%).
TC_SPLIT_CASES = [(2050, 0.5), (2050, 0.1), (3000, 0.5), (3000, 0.1),
                  (10000, 0.5), (10000, 0.1), (39800, 0.5), (131100, 0.5),
                  (32768, 0.5), (32768, 0.1), (65536, 0.5), (131072, 0.1)]


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("form", ["force3m", "no3m"])
@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fft,nono", TC_SPLIT_CASES)
def test_tc_split_kernel_matches_plain(cuda, fft, nono, mode, prec, form,
                                       u8):
    """One launch of Kernel C (no FFT kernel, no Kernel A) within TC_TOL of
    its plain version on the same split; u8 bit-identical to decoded
    float32 on the split u8 takes."""
    cfg = zs_cfg(fft, nono, mode, tpu_precision=prec, x_res=500)
    re, im = class_planes(cuda, cfg, 4 if fft <= 16384 else 2, u8, fft)
    before = (cuda_tc.tc_split_launches, cuda_tc.tc_launches,
              cuda_curscan.launches)
    got = cuda_tc.curscan_tc_split(re, im, cfg, form)
    torch.cuda.synchronize()
    assert (cuda_tc.tc_split_launches, cuda_tc.tc_launches,
            cuda_curscan.launches) == (before[0] + 1, before[1], before[2])
    assert_tc_close(got.cpu().numpy(), cuda_tc.curscan_tc_split_plain(
        re, im, cfg, form).cpu().numpy(), prec)
    if u8:
        assert torch.equal(got, cuda_tc.curscan_tc_split(
            tspec.decode_u8(re), tspec.decode_u8(im), cfg, form,
            cuda_curscan.tc_split(cfg, True)))


@pytest.mark.parametrize("form", ["force3m", "no3m"])
@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("split", [(60, 50), (50, 60), (10, 300), (300, 10),
                                   (1, 3000)])
def test_tc_split_kernel_takes_any_split(cuda, split, prec, form):
    """fft 3000 on splits of either shape, one m-tile a block (n1 <= 16)
    and n2 padded from 10; n2 = 3000 at DEFAULT 4M alone fits a block's
    shared memory (one m-tile, 193,024 bytes), elsewhere the wrapper
    refuses it."""
    cfg = zs_cfg(3000, 0.1, "MIN", tpu_precision=prec, x_res=500)
    re, im = class_planes(cuda, cfg, 3, False, split[0])
    high, tm = prec == "HIGH", form == "force3m"
    if split[1] == 3000 and (high or tm):
        with pytest.raises(ValueError, match="shared memory"):
            cuda_tc.curscan_tc_split(re, im, cfg, form, split)
        return
    got = cuda_tc.curscan_tc_split(re, im, cfg, form, split)
    assert_tc_close(got.cpu().numpy(), cuda_tc.curscan_tc_split_plain(
        re, im, cfg, form, split).cpu().numpy(), prec)


@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("fft,nono,t", [(3000, 0.5, 4096), (10000, 0.1, 16),
                                        (65536, 0.5, 64), (2050, 0.1, 1)])
def test_tc_split_kernel_through_the_dispatcher(cuda, fft, nono, t, prec):
    """HIGH/DEFAULT configs of K3 off the grid and of the grid above 16384
    launch Kernel C and never the FFT kernel; two runs bit-identical (each
    element folded by one lane in window order)."""
    cfg = zs_cfg(fft, nono, tpu_precision=prec, x_res=500)
    re, im = class_planes(cuda, cfg, t, False, t)
    before = (cuda_tc.tc_split_launches, cuda_curscan.launches)
    got = tspec.curscan_auto_batched(re, im, cfg)
    assert torch.equal(got, tspec.curscan_auto_batched(re, im, cfg))
    assert (cuda_tc.tc_split_launches, cuda_curscan.launches) == (
        before[0] + 2, before[1])
    rows = slice(0, 16)
    assert_tc_close(got[rows].cpu().numpy(), cuda_tc.curscan_tc_split_plain(
        re[rows], im[rows], cfg).cpu().numpy(), prec)


def test_tc_split_m_tiles(cuda):
    """The library's m-tiles a block (``kspec_curscan_tc_split_mt``, each
    warp a strip of 8 columns for all of them): 4, halved while C's bf16
    planes (forms x halves x 16 rows a tile x (n2p + 8) x 2 bytes) and the
    frame buffers do not fit a block's 232,448 bytes and while half covers
    n1's m-tiles, 0 where one tile's C planes do not fit: n2 up to 3616 at
    DEFAULT 4M, 1808 at HIGH 4M, 1200 at 3M HIGH."""
    from kspecanal_tpu_torch.ops import _build
    lib = _build.load()
    for (n1, n2, high, tm), want in (
            ((10, 128, 0, 0), 1), ((32, 128, 0, 0), 2), ((48, 128, 0, 0), 4),
            ((256, 128, 0, 0), 4), ((256, 128, 1, 0), 4),
            ((256, 256, 1, 1), 2), ((1024, 1024, 0, 0), 2),
            ((1024, 1024, 1, 0), 1), ((1024, 1024, 1, 1), 1),
            ((60, 50, 0, 0), 4), ((60, 50, 1, 0), 4), ((16, 64, 0, 0), 1),
            ((100, 100, 0, 0), 4), ((100, 100, 1, 0), 4),
            ((128, 128, 0, 0), 4), ((200, 199, 0, 0), 4),
            ((1, 3000, 0, 0), 1), ((1, 3000, 1, 0), 0), ((1, 3000, 0, 1), 0),
            ((5, 3616, 0, 0), 1), ((1, 3632, 0, 0), 0),
            ((9, 1808, 1, 0), 1), ((1, 1824, 1, 0), 0),
            ((2, 1200, 1, 1), 1), ((1, 1216, 1, 1), 0),
            ((0, 128, 0, 0), 0)):
        assert lib.kspec_curscan_tc_split_mt(n1, n2, high, tm) == want, (
            n1, n2, high, tm)


def test_tc_split_shared_memory_and_occupancy(cuda):
    """Kernel C's shared memory a block (``kspec_curscan_tc_split_smem``,
    ``layout()``): the C planes and the frame's two chunk buffers, then
    F1's rows, the fold, the twiddles, F2^T and the window while they fit
    half an SM (DEFAULT, where F1's rows and the fold fit it: two blocks
    an SM) or a block's share; every split of the timing cells and the
    boundaries fits a block and holds at least one an SM, fft 3000 and
    10000 DEFAULT two."""
    from kspecanal_tpu_torch.ops import _build
    lib = _build.load()

    def smem(n1, n2, high=False, tm=False):
        return lib.kspec_curscan_tc_split_smem(n1, n2, int(high), int(tm))
    # fft 3000 DEFAULT 4M (4 m-tiles): C 18,432 + frame 9,216 + F1 16,384 +
    # fold 18,432 + twiddles 32,768 + F2^T 16,384.
    assert smem(60, 50) == 18432 + 9216 + 16384 + 18432 + 32768 + 16384
    # fft 10000 DEFAULT 4M: C 30,720 + frame 9,216 + F1 28,672 + fold
    # 30,720 (the twiddles, F2^T and the window do not fit half an SM).
    assert smem(100, 100) == 30720 + 9216 + 28672 + 30720
    # fft 3000 HIGH 4M (chunks of 64 rows): C 36,864 + frame 73,728 + F1
    # 32,768 + fold 18,432 + twiddles 32,768 + F2^T 32,768.
    assert smem(60, 50, high=True) == (36864 + 73728 + 32768 + 18432
                                       + 32768 + 32768)
    for n1, n2 in ((60, 50), (100, 100), (200, 199), (256, 256), (512, 128),
                   (256, 128), (50, 41), (5, 3616), (9, 1808), (2, 1200)):
        for high in (False, True):
            for tm in (False, True):
                if lib.kspec_curscan_tc_split_mt(n1, n2, high, tm) < 1:
                    continue
                b = smem(n1, n2, high, tm)
                assert 0 < b <= 232448
                for u8 in (False, True):
                    per_sm = cuda_tc.tc_split_occupancy(lib, u8, n1, n2,
                                                        high, tm)
                    assert 1 <= per_sm and per_sm * (b + 1024) <= 233472
    for split in ((60, 50), (100, 100)):
        assert cuda_tc.tc_split_occupancy(lib, False, *split, False,
                                          False) == 2


@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("fft,nono,t", [(10000, 0.1, 16), (3000, 0.5, 1),
                                        (2050, 0.1, 3)])
def test_tc_split_kernel_window_groups(cuda, fft, nono, t, prec):
    """Through the dispatcher at short batches, where Kernel C splits each
    IQ block's windows into G > 1 groups (combined in group order): within
    TC_TOL of the plain version, and two runs bit-identical."""
    from kspecanal_tpu_torch.ops import _build
    cfg = zs_cfg(fft, nono, "MIN" if t == 3 else "AVG", tpu_precision=prec,
                 x_res=500)
    re, im = class_planes(cuda, cfg, t, False, fft + t)
    split = cuda_curscan.tc_split(cfg)
    groups = cuda_tc.tc_split_launch_groups(_build.load(), re, cfg, False,
                                            split)
    assert groups > 1
    before = cuda_tc.tc_split_launches
    got = tspec.curscan_auto_batched(re, im, cfg)
    assert torch.equal(got, tspec.curscan_auto_batched(re, im, cfg))
    assert cuda_tc.tc_split_launches == before + 2
    assert_tc_close(got.cpu().numpy(), cuda_tc.curscan_tc_split_plain(
        re, im, cfg).cpu().numpy(), prec)


@pytest.mark.parametrize("fft,split,prec,form", [
    (18080, (5, 3616), "DEFAULT", None), (16272, (9, 1808), "HIGH", None),
    (2400, (2, 1200), "HIGH", "force3m")])
def test_tc_split_kernel_at_the_shared_memory_limit(cuda, fft, split, prec,
                                                    form):
    """The widest n2 Kernel C takes at each class and form (ROADMAP G1),
    where one m-tile's C planes fill a block's shared memory and each lane
    loads its B fragments from the planes: it launches, within TC_TOL of
    the plain version; 16 columns more raise."""
    cfg = zs_cfg(fft, 0.5, "MAX", tpu_precision=prec, x_res=500)
    assert cuda_curscan.kernel_route(cfg) == "tc_split"
    re, im = class_planes(cuda, cfg, 2, False, split[1])
    before = cuda_tc.tc_split_launches
    got = cuda_tc.curscan_tc_split(re, im, cfg, form, split)
    torch.cuda.synchronize()
    assert cuda_tc.tc_split_launches == before + 1
    assert_tc_close(got.cpu().numpy(), cuda_tc.curscan_tc_split_plain(
        re, im, cfg, form, split).cpu().numpy(), prec)
    from kspecanal_tpu_torch.ops import _build
    high, tm = prec == "HIGH", form == "force3m"
    assert _build.load().kspec_curscan_tc_split_mt(1, split[1] + 16,
                                                   int(high), int(tm)) == 0


@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
def test_tc_split_cut_offs(cuda, prec):
    """Kernel C's forensic cut-offs (``-DKSPEC_TCS_STOP`` builds) at the fft
    3000 timing cell: each within TC_TOL of its plain version on 8 blocks,
    'full' Kernel C's output bit for bit, and their times (T=4096, CUDA
    events) rising stage by stage, up to the noise of one call (5%)."""
    from kspecanal_tpu_torch.utils.profiling import cuda_ms
    cfg = zs_cfg(3000, 0.5, tpu_precision=prec, x_res=500)
    re, im = class_planes(cuda, cfg, 4096, False, 3000)
    sub = (re[:8], im[:8])
    ms = []
    for stage in cuda_tc.TC_SPLIT_STAGES:
        got = cuda_tc.curscan_tc_split_stage(*sub, cfg, stage)
        want = cuda_tc.curscan_tc_split_stage_plain(*sub, cfg, stage)
        assert_tc_close(got.cpu().numpy(), want.cpu().numpy(), prec)
        ms.append(cuda_ms(lambda s=stage: cuda_tc.curscan_tc_split_stage(
            re, im, cfg, s)))
    assert torch.equal(got, cuda_tc.curscan_tc_split(*sub, cfg))
    assert all(b >= 0.95 * a for a, b in zip(ms, ms[1:])), ms


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fft,nono", [(fft, nono) for fft in PACKED_FFTS
                                      for nono in (0.5, 0.1)])
def test_packed_tc_kernel_matches_plain(cuda, fft, nono, mode, prec, u8):
    """Kernel B through the dispatcher at every fft it takes;
    quickFullScan's geometry is fft 64 at 90%."""
    cfg = zs_cfg(fft, nono, mode, tpu_precision=prec, x_res=fft,
                 fft2full_mult4less=max(8, 256 // fft))
    re, im = class_planes(cuda, cfg, 300, u8, fft)
    before = (cuda_tc.packed_tc_launches, cuda_packed.launches)
    got = tspec.curscan_auto_batched(re, im, cfg)
    torch.cuda.synchronize()
    assert (cuda_tc.packed_tc_launches, cuda_packed.launches) == (
        before[0] + 1, before[1])
    assert_tc_close(got.cpu().numpy(), cuda_tc.curscan_packed_tc_plain(
        re, im, cfg).cpu().numpy(), prec)
    if u8:
        assert torch.equal(got, tspec.curscan_auto_batched(
            tspec.decode_u8(re), tspec.decode_u8(im), cfg))


@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("fft,nono,mult,t", [(64, 0.1, 8, 19616),
                                             (128, 0.5, 81, 64),
                                             (64, 0.1, 96, 16)])
def test_packed_tc_kernel_chunks(cuda, fft, nono, mult, t, prec):
    """quickFullScan's catch-up T, and blocks of many chunks (fft 128 x 81:
    161 windows; fft 64 x 96 at 90%: 951); two runs bit-identical."""
    cfg = zs_cfg(fft, nono, "MIN", tpu_precision=prec, x_res=fft,
                 fft2full_mult4less=mult)
    re, im = class_planes(cuda, cfg, t, False, mult)
    got = cuda_tc.curscan_packed_tc(re, im, cfg)
    assert torch.equal(got, cuda_tc.curscan_packed_tc(re, im, cfg))
    rows = slice(0, 64)
    assert_tc_close(got[rows].cpu().numpy(), cuda_tc.curscan_packed_tc_plain(
        re[rows], im[rows], cfg).cpu().numpy(), prec)


# Kernel B's new shapes: T that leaves the persistent grid's last round
# partial (1, 7, 1227 and 19617 blocks of quickFullScan), the ffts at both
# ends (2: repeated starts at 90%; 128 at HIGH: the table in shared memory),
# the 951-window block (fft 64 x 96, four or five staged spans) and fft 32
# RAW at 25% non-overlap.
PACKED_TC_SHAPES = [(64, 0.1, 8, "AVG", t) for t in (1, 7, 1227, 19617)] + [
    (2, 0.1, 128, "MIN", 64), (128, 0.1, 8, "MAX", 64),
    (128, 0.5, 8, "AVG", 64), (64, 0.1, 96, "AVG", 16),
    (32, 0.25, 8, "RAW", 64)]


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("prec", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("fft,nono,mult,mode,t", PACKED_TC_SHAPES)
def test_packed_tc_kernel_shapes(cuda, fft, nono, mult, mode, t, prec, u8):
    """Kernel B against its plain version (the first and last 64 blocks),
    two runs bit-identical, u8 equal to decoded float32."""
    cfg = zs_cfg(fft, nono, mode, tpu_precision=prec, x_res=fft,
                 fft2full_mult4less=mult)
    re, im = class_planes(cuda, cfg, t, u8, t + fft)
    before = cuda_tc.packed_tc_launches
    got = cuda_tc.curscan_packed_tc(re, im, cfg)
    assert cuda_tc.packed_tc_launches == before + 1
    assert torch.equal(got, cuda_tc.curscan_packed_tc(re, im, cfg))
    for rows in (slice(0, 64), slice(max(0, t - 64), t)):
        assert_tc_close(got[rows].cpu().numpy(),
                        cuda_tc.curscan_packed_tc_plain(
                            re[rows], im[rows], cfg).cpu().numpy(), prec)
    if u8:
        assert torch.equal(got, cuda_tc.curscan_packed_tc(
            tspec.decode_u8(re), tspec.decode_u8(im), cfg))


def test_packed_tc_shared_memory_and_occupancy(cuda):
    """The library's shared memory a block (``kspec_curscan_packed_tc_smem``)
    is ``cuda_tc.packed_tc_smem`` for every fft, class, input type and
    staging row; every fold's instantiation at the plans' rows fits an SM
    at least once, within the SM's shared memory."""
    from kspecanal_tpu_torch.ops import _build
    lib = _build.load()
    for n in (2, 4, 8, 16, 32, 64, 128):
        for u8 in (False, True):
            for high in (False, True):
                for stride in (256, 512, 2016, 4096):
                    assert lib.kspec_curscan_packed_tc_smem(
                        int(u8), n, int(high), stride) == \
                        cuda_tc.packed_tc_smem(n, stride, u8, high)
                plan = cuda_tc.packed_tc_plan(
                    n, zs_cfg(n, 0.1, x_res=n, fft2full_mult4less=max(
                        8, 256 // n)).window_starts, u8, high)
                for mode in MODES:
                    per_sm = cuda_tc.packed_tc_occupancy(lib, u8, n, high,
                                                         mode, plan.stride)
                    assert 1 <= per_sm and per_sm * (plan.smem + 1024) \
                        <= 233472
    assert lib.kspec_curscan_packed_tc_smem(0, 48, 0, 512) == -1


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


# K4 at HIGHEST on Kernel A's six-pass builds: the main cell, n1 = 96
# (the fold in shared memory) and n1 = 128 (the fold in the output rows,
# window groups).
STAGE_CASES = [(2048, 64), (12288, 16), (16384, 32)]


@pytest.mark.parametrize("fft,t", STAGE_CASES,
                         ids=["2048", "12288", "16384"])
@pytest.mark.parametrize("stage", cuda_curscan.STAGES)
def test_stage_ablate_matches_plain(cuda, stage, fft, t):
    """K4 at HIGHEST: each of Kernel A's six-pass cut-offs (one launch,
    counted in ``tc_stage_launches``) within ``TC_TOL["HIGHEST"]`` of its
    plain version."""
    cfg = zs_cfg(fft, x_res=512)
    assert cfg.tpu_precision == "HIGHEST"
    re, im = (torch.from_numpy(decoded(p)).to(cuda)
              for p in raw_planes(cfg, t, seed=15))
    before = cuda_tc.tc_stage_launches
    got = cuda_curscan.curscan_stage_ablate(re, im, cfg, stage)
    want = cuda_tc.curscan_tc_stage_plain(re, im, cfg, stage)
    torch.cuda.synchronize()
    assert cuda_tc.tc_stage_launches == before + 1
    assert got.shape == (t, fft // 128, 128)
    assert_tc_close(got.cpu().numpy(), want.cpu().numpy(), "HIGHEST")


@pytest.mark.parametrize("fft", [2048, 16384])
def test_full_stage_and_concat_equal_the_kernel_bitwise(cuda, fft):
    """At HIGHEST K4's 'full' (Kernel A's HIGHEST build) under the layout
    map equals the HIGHEST ablate build with no stage removed ('concat')
    bit for bit: the ablate build runs the same operations at the same
    window groups."""
    cfg = zs_cfg(fft, x_res=512)
    re, im = (torch.from_numpy(decoded(p)).to(cuda)
              for p in raw_planes(cfg, 8, seed=16))
    full = cuda_curscan.curscan_stage_ablate(re, im, cfg, "full")
    assert torch.equal(cuda_curscan.stage_layout_to_spectrum(full),
                       cuda_curscan.curscan_fused_sublane(
                           re, im, cfg, ablate=("concat",)))


@pytest.mark.parametrize("name,keys", kernel_ablate.VARIANTS,
                         ids=[v[0] for v in kernel_ablate.VARIANTS])
@pytest.mark.parametrize("mode", ["AVG", "MIN"])
def test_ablate_variant_matches_plain(cuda, name, keys, mode):
    """The ablation script's variants at HIGHEST: Kernel A's six-pass
    ablate build ('base': the FFT kernel) within ``TC_TOL["HIGHEST"]`` of
    the plain version, u8 bit-identical to decoded float32."""
    cfg = zs_cfg(2048, mode=mode)
    re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 8, 17))
    before = cuda_tc.tc_ablate_launches
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg, ablate=keys)
    assert cuda_tc.tc_ablate_launches == before + (1 if keys else 0)
    want = cuda_tc.curscan_tc_plain(re, im, cfg, ablate=keys)
    torch.cuda.synchronize()
    assert_tc_close(got.cpu().numpy(), want.cpu().numpy(), "HIGHEST")
    dec = cuda_curscan.curscan_fused_sublane(
        tspec.decode_u8(re), tspec.decode_u8(im), cfg, ablate=keys)
    assert torch.equal(got, dec)


def test_device_sources_on_card(cuda):
    """devicesynth on the card equals the same start times synthesised on
    the CPU within 1e-6 x gain_mult x tones; devicenoise gives u8 planes of
    mean 127.5."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    t0 = torch.randint(0, 1 << 32, (16,), generator=gen, device=cuda,
                       dtype=torch.int64)
    tones = (1e6, 0.0, -1e6)
    got = tsrc.synth_batch(t0, tones, 2.4e6, 0.5, 16384, cuda)
    want = tsrc.synth_batch(t0.cpu(), tones, 2.4e6, 0.5, 16384, "cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert (g.cpu() - w).abs().max().item() <= 1e-6 * 10 ** 0.05 * 3
    re, im = tsrc.DeviceNoiseIQSource(seed=1).read_device_batch(256, 16384)
    assert re.dtype == torch.uint8 and re.device.type == "cuda"
    assert abs(re.float().mean().item() - 127.5) < 0.5


# Worlds of two ranks sharing the card over gloo (parallel/mesh.py; the
# collectives cross the host): the sharded paths at the main path's sizes
# against the unsharded port on the card, each rank launching the route's
# kernel (scripts/dryrun_multichip.rank_main checks both on its ranks).
MESH_CASES = {
    "stream fft 2048": {"stream": [{
        "fft": 2048, "nono": 0.5, "window": WINDOW_KAISER, "mode": "AVG",
        "blocks": 4096, "u8": False}]},
    "stream fft 3000": {"stream": [{
        "fft": 3000, "nono": 0.5, "window": WINDOW_KAISER, "mode": "AVG",
        "blocks": 1024, "u8": False}]},
    "band-sharded sweep FMSCAN": {"band": ["FMSCAN"]},
    "band-sharded sweep QUICKFULLSCAN": {"band": ["QUICKFULLSCAN"]},
}


@pytest.fixture(scope="module")
def shared_card_world():
    """Rank results of one 2-rank world over every case of MESH_CASES."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from kspecanal_tpu_torch.ops import _build
    from kspecanal_tpu_torch.parallel.spawn import run_world
    from kspecanal_tpu_torch.scripts import dryrun_multichip
    _build.load()      # one build, before the ranks load it
    args = {"band_mesh": [1, 2]}
    for case in MESH_CASES.values():
        for k, v in case.items():
            args[k] = args.get(k, []) + v
    return run_world(dryrun_multichip.TARGET, 2, args, backend="gloo",
                     device_type="cuda", share_card=True)


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_shared_card_world_matches_unsharded_port(shared_card_world, case):
    root = shared_card_world[0]
    shares = {k: v for k, v in root["shares"].items() if k.startswith(case)}
    assert shares and max(shares.values()) <= 1.0, shares
    for rank in shared_card_world:
        launched = [sum(v) for k, v in rank["launches"].items()
                    if k.startswith(case)]
        assert launched and min(launched) > 0, rank["launches"]


@pytest.mark.parametrize("stage", cuda_curscan.STAGES)
@pytest.mark.parametrize("fft,t", [(2048, 64), (16384, 32)])
@pytest.mark.parametrize("prec", ["DEFAULT", "HIGH"])
def test_tc_k4_cut_offs_match_plain(cuda, prec, fft, t, stage):
    """K4 at HIGH and DEFAULT: each of Kernel A's cut-offs (one launch,
    counted in ``tc_stage_launches``) within TC_TOL of its plain version;
    'full' after the layout map bitwise equal to Kernel A (fft 16384 at
    T=32 runs window groups and their combine)."""
    cfg = zs_cfg(fft, tpu_precision=prec)
    re, im = planes_on(cuda, cfg, t, seed=fft + t)
    before = cuda_tc.tc_stage_launches
    got = cuda_curscan.curscan_stage_ablate(re, im, cfg, stage)
    assert cuda_tc.tc_stage_launches == before + 1
    assert got.shape == (t, fft // 128, 128)
    want = cuda_tc.curscan_tc_stage_plain(re, im, cfg, stage)
    assert_tc_close(got.cpu().numpy(), want.cpu().numpy(), prec)
    if stage == "full":
        assert torch.equal(cuda_curscan.stage_layout_to_spectrum(got),
                           cuda_tc.curscan_tc(re, im, cfg))


@pytest.mark.parametrize("fft", [2048, 128])
def test_analyzer_launches_its_kernel(cuda, tmp_path, fft):
    """``tools.analyze_capture`` on the card: K1 at fft 2048, K2 at 128,
    four spectra within the per-bin bound of the plain versions run on
    the CPU on the same capture."""
    from kspecanal_tpu_torch import tools
    from kspecanal_tpu_torch.scripts import make_fixture
    path = str(tmp_path / "cap.iq")
    make_fixture.make_capture(path, 200_000)
    before = (cuda_curscan.launches, cuda_packed.launches)
    got = tools.analyze_capture(path, fft)
    launched = (cuda_curscan.launches - before[0],
                cuda_packed.launches - before[1])
    assert launched == ((4, 0) if fft == 2048 else (0, 4))
    want = tools.analyze_capture(path, fft, device="cpu")
    for k in ("complex", "imag", "abs"):
        assert_spectra_close(got[k], want[k])


@pytest.mark.parametrize("key", sorted(cuda_curscan.ABLATE_KEYS))
@pytest.mark.parametrize("mode", ["AVG", "MIN"])
@pytest.mark.parametrize("prec", ["DEFAULT", "HIGH"])
def test_tc_ablate_key_matches_plain(cuda, prec, mode, key):
    """K1's ablate keys at HIGH and DEFAULT: Kernel A's ablate build (one
    launch, counted in ``tc_ablate_launches``; the direct kernel's forensic
    instantiation never) within TC_TOL of its plain version at fft 2048,
    T=8 (window groups and their combine), u8 bit-identical to decoded
    float32; 'concat' bitwise equal to Kernel A's production output."""
    cfg = zs_cfg(2048, mode=mode, tpu_precision=prec)
    re, im = (torch.from_numpy(p).to(cuda)
              for p in raw_planes(cfg, 8, seed=80 + len(key)))
    before = (cuda_tc.tc_ablate_launches, cuda_curscan.forensic_launches)
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg, ablate=(key,))
    assert (cuda_tc.tc_ablate_launches, cuda_curscan.forensic_launches) == (
        before[0] + 1, before[1])
    want = cuda_tc.curscan_tc_plain(re, im, cfg, ablate=(key,))
    assert_tc_close(got.cpu().numpy(), want.cpu().numpy(), prec)
    assert torch.equal(got, cuda_curscan.curscan_fused_sublane(
        tspec.decode_u8(re), tspec.decode_u8(im), cfg, ablate=(key,)))
    if key == "concat":
        assert torch.equal(got, cuda_tc.curscan_tc(re, im, cfg))


@pytest.mark.parametrize("prec,key", [("DEFAULT", "stage1"),
                                      ("HIGH", "stage2")])
def test_tc_split_ablate_key_matches_plain(cuda, prec, key):
    """Above fft 16384 the keys run Kernel C's ablate build on the split
    (fft / 128, 128) (counted in ``tc_split_ablate_launches``) within
    TC_TOL of its plain version, u8 bit-identical to decoded float32; no
    key ('concat') bitwise equal to Kernel C's production output on that
    split."""
    cfg = zs_cfg(32768, tpu_precision=prec)
    re, im = (torch.from_numpy(p).to(cuda) for p in raw_planes(cfg, 8, 81))
    split = (256, 128)
    before = cuda_tc.tc_split_ablate_launches
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg, ablate=(key,))
    assert cuda_tc.tc_split_ablate_launches == before + 1
    want = cuda_tc.curscan_tc_split_plain(re, im, cfg, None, split, (key,))
    assert_tc_close(got.cpu().numpy(), want.cpu().numpy(), prec)
    assert torch.equal(got, cuda_curscan.curscan_fused_sublane(
        tspec.decode_u8(re), tspec.decode_u8(im), cfg, ablate=(key,)))
    assert torch.equal(
        cuda_curscan.curscan_fused_sublane(re, im, cfg, ablate=("concat",)),
        cuda_tc.curscan_tc_split(re, im, cfg, split=split))


def test_highest_shared_memory_and_occupancy(cuda):
    """The HIGHEST builds (``-DKSPEC_TC_HIGHEST=1``): Kernel A's shared
    memory a block at precision 2 (three parts a form), every n1 and pass
    size within a block and holding at least one an SM (3M's nine planes
    up to n1p = 80; above it the wrapper raises), the fold in the output
    rows from n1p = 112, the main cell's planes too big for two; Kernel
    C's on the sublane split, 4 m-tiles at 4M at every n1, and its widest
    n2 ``cuda_tc.tc_split_max_n2``."""
    lib = cuda_tc.highest_library()
    clib = cuda_tc.tc_split_ablate_library(highest=True)
    # The main cell, 4 windows of 16 rows a pass: 6 planes, fold, F1.
    assert lib.kspec_curscan_tc_smem(16, 4, 2, 0) == (6 * 64 * 272 + 16 * 544
                                                      + 6 * 512)
    assert lib.kspec_curscan_tc_smem(96, 1, 2, 0) == 156672 + 52224
    assert lib.kspec_curscan_tc_smem(112, 1, 2, 0) == 182784
    assert lib.kspec_curscan_tc_smem(128, 1, 2, 0) == 208896
    for n1 in range(2, 129):
        for w in (1, 2, 15):
            wb = cuda_tc.tc_windows_per_pass(n1, w)
            for tm in (False, True):
                b = lib.kspec_curscan_tc_smem(n1, wb, 2, int(tm))
                if tm and -(-n1 // 16) * 16 > 80:   # 9 planes: n1p <= 80
                    assert b > 232448
                    assert lib.kspec_curscan_tc_occupancy(0, n1, wb, 2,
                                                          1) == -1
                    continue
                assert b <= 232448
                per_sm = cuda_tc.tc_occupancy(lib, False, n1, wb, 2, tm)
                assert 1 <= per_sm and per_sm * (b + 1024) <= 233472
    assert cuda_tc.tc_occupancy(lib, False, 16, 4, 2, False) == 1
    assert lib.kspec_curscan_tc_occupancy(0, 16, 4, 1, 0) == -1
    cfg = zs_cfg(16384)
    p = torch.zeros((1, cfg.full_size), device=cuda)
    with pytest.raises(ValueError, match="3M fits up to n1 = 80"):
        cuda_curscan.curscan_fused_sublane(p, p, cfg,
                                           ablate=("win", "force3m"))
    for n1 in (129, 256, 1024, 8192):
        assert clib.kspec_curscan_tc_split_mt(n1, 128, 2, 0) == 4
        assert clib.kspec_curscan_tc_split_mt(n1, 128, 2, 1) == 2
        for u8 in (False, True):
            assert cuda_tc.tc_split_occupancy(clib, u8, n1, 128, 2,
                                              False) == 1
    for tm in (False, True):
        top = cuda_tc.tc_split_max_n2("HIGHEST", tm)
        assert clib.kspec_curscan_tc_split_mt(1, top, 2, int(tm)) == 1
        assert clib.kspec_curscan_tc_split_mt(1, top + 16, 2, int(tm)) == 0


@pytest.mark.parametrize("key", sorted(cuda_curscan.ABLATE_KEYS))
@pytest.mark.parametrize("fft,t", [(2048, 8), (16384, 4), (32768, 4),
                                   (16512, 2)])
def test_highest_ablate_key_matches_plain(cuda, fft, t, key):
    """K1's ablate keys at HIGHEST: Kernel A's six-pass ablate build up to
    fft 16384, Kernel C's on (fft / 128, 128) above (one launch of the
    build), within ``TC_TOL["HIGHEST"]`` of the plain version, u8
    bit-identical to decoded float32."""
    cfg = zs_cfg(fft)
    re, im = (torch.from_numpy(p).to(cuda)
              for p in raw_planes(cfg, t, seed=90 + len(key)))
    counter = "tc_ablate_launches" if fft <= 16384 else \
        "tc_split_ablate_launches"
    before = getattr(cuda_tc, counter)
    got = cuda_curscan.curscan_fused_sublane(re, im, cfg, ablate=(key,))
    assert getattr(cuda_tc, counter) == before + 1
    want = cuda_tc.curscan_tc_split_plain(re, im, cfg, None,
                                          (fft // 128, 128), (key,))
    assert_tc_close(got.cpu().numpy(), want.cpu().numpy(), "HIGHEST")
    assert torch.equal(got, cuda_curscan.curscan_fused_sublane(
        tspec.decode_u8(re), tspec.decode_u8(im), cfg, ablate=(key,)))
