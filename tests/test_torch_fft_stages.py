"""The power-of-two FFT kernel's stage table on the CPU: the plain version of
its cut-offs (``cuda_curscan.curscan_fft_stage_plain``) at 'full' against
the JAX Pallas kernel in interpret mode and the JAX chain (fft 256, 2048
and 16384, 50% and 90% overlap, AVG/MAX/MIN, f32 and u8; bounds in
``torch_parity.assert_spectra_close``: 5e-5 of the bin plus 1e-6 of the
peak), u8 planes bit-identical to decoded float32 at every cut-off, the
dispatch of the forensic builds on the card with a stand-in library and
'meta' tensors, their build with a stand-in nvcc, and the script's
conversion count.  The cut-offs against the NumPy model of the kernel are
in ``test_torch_fft_kernel.py``."""
import contextlib
import stat
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from kspecanal_tpu_torch.ops import _build, cuda_curscan
from kspecanal_tpu_torch.ops import spectrum as tspec
from kspecanal_tpu_torch.scripts import fft_stages
from torch_parity import (assert_spectra_close, decoded, jax_refs,
                          raw_planes, zs_cfg)

POW2 = [1 << e for e in range(8, 18)]          # 256 .. 131072


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("mode", ["AVG", "MAX", "MIN"])
@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("fft", [256, 2048, 16384])
def test_full_stage_plain_matches_jax_kernel_and_chain(fft, nono, mode, u8):
    """The 'full' cut-off's plain version (the production kernel's, in
    float64) on CPU tensors against the JAX kernel in interpret mode and
    the JAX chain on the same planes."""
    re, im, kern, chain = jax_refs(fft, nono, mode)
    if not u8:
        re, im = decoded(re), decoded(im)
    cfg = zs_cfg(fft, nono, mode)
    got = cuda_curscan.curscan_fft_stage(torch.from_numpy(re),
                                         torch.from_numpy(im), cfg,
                                         "full").numpy()
    assert got.dtype == np.float64 and got.shape == kern.shape
    assert_spectra_close(got, kern)
    assert_spectra_close(got, chain)


@pytest.mark.parametrize("parent", [False, True], ids=["float64", "parent"])
@pytest.mark.parametrize("stage", cuda_curscan.FFT_STAGES)
def test_stage_plain_u8_equals_decoded_f32(stage, parent):
    """u8 planes through each cut-off's plain version equal the decoded
    float32 planes', bit for bit (fft 2048 at 90% overlap, misaligned
    starts; fft 32768, a cluster)."""
    for fft in (2048, 32768):
        cfg = zs_cfg(fft, 0.1, "MIN", x_res=512)
        re, im = (torch.from_numpy(p) for p in raw_planes(cfg, 1, seed=fft))
        got = cuda_curscan.curscan_fft_stage_plain(re, im, cfg, stage, parent)
        want = cuda_curscan.curscan_fft_stage_plain(
            tspec.decode_u8(re), tspec.decode_u8(im), cfg, stage, parent)
        assert torch.equal(got, want)


def test_stage_refuses_what_the_power_of_two_kernel_does_not_run():
    """Sizes the mixed kernel serves (3000, 384, 262144), sizes no kernel
    takes and unknown stages raise, on the CPU as on the card; the stage
    names are the forensic builds' cut-offs in order."""
    assert cuda_curscan.FFT_STAGES == ("input", "pass1", "radix16", "full")
    for fft in (3000, 384, 262144, 1000):
        cfg = zs_cfg(fft, 0.5, x_res=500)
        z = torch.zeros((1, cfg.full_size))
        with pytest.raises(ValueError):
            cuda_curscan.curscan_fft_stage(z, z, cfg, "input")
    cfg = zs_cfg(2048)
    z = torch.zeros((1, cfg.full_size))
    with pytest.raises(ValueError, match="unknown stage"):
        cuda_curscan.curscan_fft_stage(z, z, cfg, "odd")


class _FakeLib:
    """A stand-in for a kernels' library: records each launch's
    arguments and reports success."""

    def __init__(self, name):
        self.name = name
        self.args = []

        def fn(*args):
            self.args.append(args)
            return 0
        fn.__name__ = "kspec_curscan_fft"
        self.kspec_curscan_fft = fn


@pytest.fixture
def fake_card(monkeypatch):
    """'meta' tensors routed as the card's: the production library and each
    forensic build are :class:`_FakeLib` s, the stream, device and SM count
    stand-ins, so the dispatch runs on the CPU up to the launch."""
    libs = {"production": _FakeLib("production")}

    def stage_library(stage, parent=False):
        return libs.setdefault((stage, parent), _FakeLib((stage, parent)))

    monkeypatch.setattr(cuda_curscan, "_cuda_lib",
                        lambda dev: libs["production"])
    monkeypatch.setattr(cuda_curscan, "fft_stage_library", stage_library)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev=None: types.SimpleNamespace(multi_processor_count=132))
    return libs


@pytest.mark.parametrize("parent", [False, True], ids=["float64", "parent"])
@pytest.mark.parametrize("fft", POW2)
def test_each_stage_launches_its_forensic_build(fake_card, fft, parent):
    """Each cut-off is one launch of its own forensic build's entry, counted
    in ``fft_stage_launches`` (the parent form's in ``fft_parent_launches``)
    and not in ``launches``, with the blocks of
    ``fft_plan`` (the parent form's in its builds), stop 0 (the cut-off is
    compiled in) and the window groups of ``groups_for``; the production
    call launches the production library with the float64 form's plan."""
    cfg = zs_cfg(fft, 0.1, x_res=512)
    t = 3
    planes = torch.empty((t, cfg.full_size), device="meta")
    c = cuda_curscan.fft_plan(fft, parent)[0]

    def counts():
        return (cuda_curscan.launches, cuda_curscan.fft_stage_launches,
                cuda_curscan.fft_parent_launches)
    for stage in cuda_curscan.FFT_STAGES:
        before = counts()
        out = cuda_curscan.curscan_fft_stage(planes, planes, cfg, stage,
                                             parent)
        assert out.shape == (t, fft)
        assert counts() == (before[0], before[1] + (not parent),
                            before[2] + parent)
        (args,) = fake_card[stage, parent].args
        (t_, n, c_, chunk, w, groups, stop) = (args[i] for i in (
            11, 13, 14, 15, 16, 17, 19))
        assert (t_, n, c_, chunk, w, stop) == (t, fft, c, t,
                                               cfg.num_windows, 0)
        assert groups == cuda_curscan.groups_for(t, c, w, 132)
    cuda_curscan.curscan_fused_sublane(planes, planes, cfg)
    (args,) = fake_card["production"].args
    assert args[14] == cuda_curscan.fft_plan(fft)[0]


def test_stage_variants_build_the_fft_kernel_alone(tmp_path, monkeypatch):
    """``fft_stage_library`` with a stand-in nvcc that logs its arguments:
    ``csrc/curscan_fft.cu`` alone (no mixed route) compiled with
    ``-DKSPEC_FFT_STOP=s`` (and ``-DKSPEC_FFT_PARENT=1`` for the parent
    form), linked into a variant library of its own name beside the
    port's."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {log}\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
                    "  shift\n"
                    "done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(path=path))
    monkeypatch.setattr(_build, "_variants", {})
    names = set()
    for parent in (False, True):
        for i, stage in enumerate(cuda_curscan.FFT_STAGES):
            log.unlink(missing_ok=True)
            lib = cuda_curscan.fft_stage_library(stage, parent)
            calls = log.read_text().splitlines()
            (compile_,) = [c.split() for c in calls if " -c " in c]
            assert Path(compile_[-1]).name == "curscan_fft.cu"
            assert f"-DKSPEC_FFT_STOP={i + 1}" in compile_
            assert ("-DKSPEC_FFT_PARENT=1" in compile_) == parent
            assert calls[-1].startswith("-shared")
            names.add(Path(lib.path).name)
    assert len(names) == 8
    assert all(n.startswith("libkspec_variant_") for n in names)


def test_conversions_counted_from_the_code():
    """The script's count of 64-bit conversions a window: the parent form
    at fft 2048 converts 16384 in its radix-8 pass 1 and 20224 in each of
    its two radix-16 passes (56832, none at the load or the magnitude);
    the float64 form two a point at the load in each of the c blocks that
    read it (c = n/8192 above 8192 points, 16 at fft 131072) and one at
    the magnitude."""
    conv = fft_stages.conversions
    assert conv(2048, parent=True) == {"input": 0, "pass1": 16384,
                                       "radix16": 56832, "full": 56832}
    for n in POW2:
        c = max(1, n // 8192)
        assert conv(n) == {"input": 2 * n * c, "pass1": 2 * n * c,
                           "radix16": 2 * n * c, "full": (2 * c + 1) * n}
    assert conv(2048)["full"] == 6144
    assert conv(131072)["full"] == 33 * 131072
    for n in POW2:
        vals = list(conv(n, parent=True).values())
        assert vals == sorted(vals)
    # A cluster of 4 blocks of 16384 (fft 65536, parent form): the radix-4
    # step widens 4 chunk values and 3 twiddles, narrows, and blocks 1-3
    # widen their own twiddle.
    assert conv(65536, parent=True)["input"] == 65536 * 18 - 16384 * 2
    assert fft_stages.parse_cell("main-u8") == fft_stages.CELLS["main-u8"]
    assert fft_stages.parse_cell("4096:64:0.1:WIN.ONES:u8") == (
        4096, 64, 0.1, "WIN.ONES", True)


def test_script_measures_the_card_only(monkeypatch):
    """Without a card the stage table exits before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail(
        "the script built without a card"))
    with pytest.raises(SystemExit):
        fft_stages.main([])


@pytest.mark.parametrize("stage_bytes", [0, 1 << 17])
def test_staging_builds_launch_the_full_stage(fake_card, monkeypatch,
                                              stage_bytes):
    """``curscan_fft_stage(..., 'full', stage_bytes=b)`` launches the build
    ``-DKSPEC_FFT_STOP=4 -DKSPEC_FFT_STAGE_BYTES=b`` of ``curscan_fft.cu``
    alone, once, counted in ``fft_stage_launches``, with the production
    plan; any other stage, or the parent form, raises; on CPU tensors it
    is the 'full' plain version."""
    loaded = []

    def load_variant(names, defines):
        loaded.append((names, defines))
        return fake_card.setdefault(("staging", defines), _FakeLib(defines))
    monkeypatch.setattr(_build, "load_variant", load_variant)
    cfg = zs_cfg(2048, 0.5, x_res=512)
    planes = torch.empty((3, cfg.full_size), device="meta")
    before = (cuda_curscan.launches, cuda_curscan.fft_stage_launches)
    out = cuda_curscan.curscan_fft_stage(planes, planes, cfg, "full",
                                         stage_bytes=stage_bytes)
    assert out.shape == (3, 2048)
    assert (cuda_curscan.launches, cuda_curscan.fft_stage_launches) == (
        before[0], before[1] + 1)
    defines = ("KSPEC_FFT_STOP=4", f"KSPEC_FFT_STAGE_BYTES={stage_bytes}")
    assert loaded == [(("curscan_fft.cu",), defines)]
    assert cuda_curscan.fft_staging_variant(stage_bytes) == loaded[0]
    (args,) = fake_card["staging", defines].args
    assert (args[14], args[19]) == (cuda_curscan.fft_plan(2048)[0], 0)
    for stage, parent in (("radix16", False), ("full", True)):
        with pytest.raises(ValueError, match="stage_bytes"):
            cuda_curscan.curscan_fft_stage(planes, planes, cfg, stage,
                                           parent, stage_bytes=stage_bytes)
    re, im = (torch.from_numpy(p) for p in raw_planes(cfg, 1, seed=9))
    assert torch.equal(
        cuda_curscan.curscan_fft_stage(re, im, cfg, "full",
                                       stage_bytes=stage_bytes),
        cuda_curscan.curscan_fft_stage_plain(re, im, cfg, "full"))


def test_staging_cells_are_the_single_block_sizes():
    """The script's ``--staging`` cells: every power of two one block
    serves (256-8192), f32 and u8, at 50% overlap with T = min(4096,
    2^23/fft), and fmScan's 90% at fft 2048, whose starts no block
    stages; each parses by name."""
    cells = fft_stages.STAGING
    assert sorted({v[0] for v in cells.values()}) == [
        1 << e for e in range(8, 14)]
    assert all(cuda_curscan.fft_plan(v[0])[0] == 1 for v in cells.values())
    assert fft_stages.parse_cell("8192-u8") == (8192, 1024, 0.5,
                                                "WIN.KAISER", True)
    assert fft_stages.parse_cell("2048-90") == (2048, 4096, 0.1,
                                                "WIN.ONES", False)
    assert len(cells) == 13 and fft_stages.ROUNDS >= 4
