"""K2's packed FFT kernel's stage table on the CPU: the plain version of its
cut-offs (``cuda_packed.curscan_packed_stage_plain``) at 'full' against the
JAX Pallas kernel ``_kernel_packed`` in interpret mode (fft 8, 32, 64 and
128, 50% and 90% overlap, AVG/MAX/MIN, f32 and u8; bounds in
``torch_parity.assert_spectra_close``: 5e-5 of the bin plus 1e-6 of the
peak), u8 planes bit-identical to decoded float32 at every cut-off, the
dispatch of the forensic builds on the card with a stand-in library and
'meta' tensors, their build with a stand-in nvcc, the lane constants'
shared-memory banks, and the script's operation counts.  The cut-offs
against the NumPy models of both forms are in ``test_torch_packed.py``."""
import contextlib
import functools
import stat
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from kspecanal_tpu_torch.ops import _build, cuda_packed
from kspecanal_tpu_torch.ops import spectrum as tspec
from kspecanal_tpu_torch.scripts import packed_stages
from torch_parity import assert_spectra_close, decoded, raw_planes, zs_cfg

FFTS = sorted(cuda_packed.SPLIT)


def stage_cfg(fft, nono, mode="AVG"):
    return zs_cfg(fft, nono, mode, x_res=fft,
                  fft2full_mult4less=max(8, 256 // fft))


@functools.lru_cache(maxsize=None)
def jax_packed(fft, nono, mode):
    """Raw u8 planes (2, full_size) and, on them decoded to float32, JAX's
    packed kernel in interpret mode and JAX's chain."""
    import jax.numpy as jnp
    from kspecanal_tpu.ops import pallas_curscan as jpk
    from kspecanal_tpu.ops import spectrum as jspec
    cfg = stage_cfg(fft, nono, mode)
    assert jpk.supports_fused_packed(cfg)
    re, im = raw_planes(cfg, 2, fft * 10 + int(nono * 10) + len(mode))
    fre, fim = jnp.asarray(decoded(re)), jnp.asarray(decoded(im))
    kern = np.asarray(jpk.curscan_fused_packed(fre, fim, cfg, t_tile=2))
    chain = np.asarray(jspec.curscan_batched(fre, fim, cfg))
    return re, im, kern, chain


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("mode", ["AVG", "MAX", "MIN"])
@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("fft", [8, 32, 64, 128])
def test_full_stage_plain_matches_jax_kernel(fft, nono, mode, u8):
    """The 'full' cut-off's plain version (both forms' production kernel,
    in float64) on CPU tensors against the JAX kernel in interpret mode on
    the same planes (JAX's kernel takes u8 as its decoded float32), and
    against the JAX chain.  At fft 8 with 90% overlap the hop is 0.8
    samples, so window starts repeat; JAX's kernel gives a repeated start
    one slot of its weight table and folds that window once where the
    chain folds it each time (AVG off by far more than the bound; MAX and
    MIN are unaffected), so there the port is held to the chain alone."""
    re, im, kern, chain = jax_packed(fft, nono, mode)
    if not u8:
        re, im = decoded(re), decoded(im)
    cfg = stage_cfg(fft, nono, mode)
    repeats = len(set(cfg.window_starts)) < cfg.num_windows
    assert repeats == (fft * nono < 1)
    if repeats and mode == "AVG":
        assert np.abs(kern - chain).max() > 1e-2 * np.abs(chain).max()
    for parent in (False, True):
        got = cuda_packed.curscan_packed_stage(
            torch.from_numpy(re), torch.from_numpy(im), cfg, "full", parent)
        assert got.dtype == torch.float64 and got.shape == chain.shape
        assert_spectra_close(got.numpy(), chain)
        if not repeats:
            assert_spectra_close(got.numpy(), kern)


@pytest.mark.parametrize("parent", [False, True], ids=["new", "parent"])
@pytest.mark.parametrize("stage", cuda_packed.STAGES)
def test_stage_plain_u8_equals_decoded_f32(stage, parent):
    """u8 planes through each cut-off's plain version equal the decoded
    float32 planes', bit for bit (fft 64 at 90% overlap, misaligned starts;
    fft 128 and 2)."""
    for fft, nono in ((64, 0.1), (128, 0.5), (2, 0.25)):
        cfg = stage_cfg(fft, nono, "MIN")
        re, im = (torch.from_numpy(p) for p in raw_planes(cfg, 2, seed=fft))
        got = cuda_packed.curscan_packed_stage_plain(re, im, cfg, stage,
                                                     parent)
        want = cuda_packed.curscan_packed_stage_plain(
            tspec.decode_u8(re), tspec.decode_u8(im), cfg, stage, parent)
        assert torch.equal(got, want)


def test_stage_refuses_what_the_packed_kernel_does_not_run():
    """Configs outside the packed predicate and unknown stages raise, on
    the CPU as on the card; the stage names are the forensic builds'
    cut-offs in order."""
    assert cuda_packed.STAGES == ("input", "regs", "lanes", "full")
    for cfg in (zs_cfg(256, 0.5), zs_cfg(48, 0.5, x_res=48)):
        z = torch.zeros((1, cfg.full_size))
        with pytest.raises(ValueError):
            cuda_packed.curscan_packed_stage(z, z, cfg, "input")
    cfg = stage_cfg(64, 0.1)
    z = torch.zeros((1, cfg.full_size))
    for fn in (cuda_packed.curscan_packed_stage,
               cuda_packed.curscan_packed_stage_plain):
        with pytest.raises(ValueError, match="unknown stage"):
            fn(z, z, cfg, "shuffle")


class _FakeLib:
    """A stand-in for a kernels' library: records each launch's arguments
    and reports success."""

    def __init__(self, name):
        self.name = name
        self.args = []

        def launch(*args):
            self.args.append(args)
            return 0
        for name_ in ("kspec_curscan_packed", "kspec_curscan_packed_parent"):
            setattr(self, name_, launch)


@pytest.fixture
def fake_card(monkeypatch):
    """'meta' tensors routed as the card's: the production library and each
    forensic build are :class:`_FakeLib` s, the stream, device and SM count
    stand-ins, so the dispatch runs on the CPU up to the launch."""
    libs = {"production": _FakeLib("production")}

    def stage_library(stage, parent=False):
        return libs.setdefault((stage, parent), _FakeLib((stage, parent)))

    monkeypatch.setattr(_build, "load", lambda: libs["production"])
    monkeypatch.setattr(cuda_packed, "_card", lambda dev: None)
    monkeypatch.setattr(cuda_packed, "stage_library", stage_library)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev=None: types.SimpleNamespace(multi_processor_count=132))
    return libs


@pytest.mark.parametrize("parent", [False, True], ids=["new", "parent"])
@pytest.mark.parametrize("fft", FFTS)
def test_each_stage_launches_its_forensic_build(fake_card, fft, parent):
    """Each cut-off is one launch of its own forensic build's entry (the
    parent form's ``kspec_curscan_packed_parent``), counted in
    ``stage_launches`` (``parent_launches``) and not in ``launches``, with
    the plan of the form (``launch_plan``, the parent form's
    ``parent_plan``); the production call launches the library with
    ``launch_plan``'s."""
    cfg = stage_cfg(fft, 0.1)
    t = 19616
    planes = torch.empty((t, cfg.full_size), device="meta")
    starts = cfg.window_starts
    if parent:
        plan = cuda_packed.parent_plan(fft, starts, t, False)
    else:
        plan = cuda_packed.launch_plan(fft, starts, t, False, 132)
    want = (fft, len(starts), 0, plan.groups, plan.chunk, plan.n_chunks,
            plan.stride)

    def counts():
        return (cuda_packed.launches, cuda_packed.stage_launches,
                cuda_packed.parent_launches)
    for stage in cuda_packed.STAGES:
        before = counts()
        out = cuda_packed.curscan_packed_stage(planes, planes, cfg, stage,
                                               parent)
        assert out.shape == (t, fft)
        assert counts() == (before[0], before[1] + (not parent),
                            before[2] + parent)
        (args,) = fake_card[stage, parent].args
        assert args[8:-1] == (t, cfg.full_size) + want
    cuda_packed.curscan_fused_packed(planes, planes, cfg)
    (args,) = fake_card["production"].args
    prod = cuda_packed.launch_plan(fft, starts, t, False, 132)
    assert args[12:17] == (0, prod.groups, prod.chunk, prod.n_chunks,
                           prod.stride)


def test_stage_variants_build_the_packed_kernel_alone(tmp_path, monkeypatch):
    """``stage_library`` with a stand-in nvcc that logs its arguments:
    ``csrc/curscan_packed.cu`` alone compiled with ``-DKSPEC_PACKED_STOP=s``
    (and ``-DKSPEC_PACKED_PARENT=1`` for the parent form), linked into a
    variant library of its own name beside the port's."""
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
        for i, stage in enumerate(cuda_packed.STAGES):
            log.unlink(missing_ok=True)
            lib = cuda_packed.stage_library(stage, parent)
            calls = log.read_text().splitlines()
            (compile_,) = [c.split() for c in calls if " -c " in c]
            assert Path(compile_[-1]).name == "curscan_packed.cu"
            assert f"-DKSPEC_PACKED_STOP={i + 1}" in compile_
            assert ("-DKSPEC_PACKED_PARENT=1" in compile_) == parent
            assert calls[-1].startswith("-shared")
            names.add(Path(lib.path).name)
    assert len(names) == 8
    assert all(n.startswith("libkspec_variant_") for n in names)


@pytest.mark.parametrize("fft", FFTS)
def test_lane_constants_have_no_bank_conflict(fft):
    """The production form's lane constants are laid out [r][lane], 16
    bytes a lane: in each 16-byte load of register r, the distinct
    addresses a quarter-warp reads (8 threads: one group of 8 lanes, two of
    4, or eight windows of one lane) lie in distinct 16-byte bank groups of
    the 32 four-byte banks; threads reading one address share it (a
    broadcast)."""
    p, lanes = cuda_packed.SPLIT[fft]
    for r in range(p):
        for quarter in range(4):
            lane = (quarter * 8 + np.arange(8)) % lanes
            addr = (r * lanes + lane) * 16
            groups = (addr // 16) % 8
            assert len(np.unique(groups)) == len(np.unique(addr))


def test_counts_from_the_code():
    """The script's float64 operations, conversions and shuffles a window.
    Parent form at fft 64 (P = L = 8): the input 2N operations and 2N
    conversions; the registers' FFT 56 operations a lane and the lane
    twiddle 28; three cross-lane passes of 34, 34 and 24 operations and 16
    shuffles a lane; |X|^2 2N and its rounding N conversions: 208
    operations, 24 conversions and 48 shuffles a lane.  Production form:
    C = 1 at fft 64, a complex window (4N), 56 + 32 (P lane twiddles) a
    lane, the exchange 28 shuffles a lane and the L-point DFT 56; u8
    decodes with no conversion (2N operations, one add a value)."""
    par = packed_stages.counts(64, parent=True)
    assert {k: v for k, v in par["full"].items()} == {
        "f64": 8 * 208, "conv": 8 * 24, "shfl": 8 * 48}
    new = packed_stages.counts(64)
    assert new["input"] == {"f64": 256, "conv": 128, "shfl": 0}
    assert new["regs"]["f64"] == 256 + 8 * (56 + 32)
    assert new["full"] == {"f64": 256 + 8 * (56 + 32 + 56) + 128,
                           "conv": 192, "shfl": 8 * 28}
    u8 = packed_stages.counts(64, u8=True)
    assert u8["full"]["conv"] == 64
    assert u8["input"]["f64"] == new["input"]["f64"] + 128
    for fft in FFTS:
        for form in (False, True):
            vals = [v["f64"] for v in packed_stages.counts(
                fft, parent=form).values()]
            assert vals == sorted(vals)
    assert packed_stages.parse_cell("qfs-u8") == packed_stages.CELLS["qfs-u8"]
    assert packed_stages.parse_cell("64:19616:0.1:WIN.ONES:AVG:8:u8") == (
        64, 19616, 0.1, "WIN.ONES", "AVG", 8, True)


def test_script_measures_the_card_only(monkeypatch):
    """Without a card the stage table exits before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail(
        "the script built without a card"))
    for argv in ([], ["--parent"], ["--versus-parent", "--kernel-only"]):
        with pytest.raises(SystemExit):
            packed_stages.main(argv)
