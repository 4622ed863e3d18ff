"""Kernel C (``ops/cuda_tc.curscan_tc_split``): the HIGH and DEFAULT classes
of K1 and K3 on every split the JAX dispatcher takes that Kernel A does
not (K3 off the 128 grid, the grid above fft 16384), on the CPU, where the
wrapper runs its plain version ``curscan_tc_split_plain``.

  * against the JAX package's kernels at the same class, in interpret mode
    (as tests/test_torch_lane.py runs the lane kernel): the lane kernel
    ``curscan_fused`` at fft 2050 (50 x 41), 3000 (60 x 50) and 10000 (100 x
    100) at 50% and 90% overlap and at fft 65536 (256 x 256, DEFAULT
    float32), the sublane kernel ``curscan_fused_sublane`` at fft 32768
    (256 x 128) at 50% and 90%, HIGH on float32 and DEFAULT on u8 planes;
    the port in the JAX kernel's complex form (the lane kernel takes 3M at
    both classes, the sublane kernel as ``test_torch_precision.jax_form``
    says); tolerances of tests/test_torch_precision.py: HIGH ``2e-5 |jax| +
    4e-6 m``, DEFAULT ``3.9e-2 (|jax| + m)``;
  * the production (4M) plain version against the float64 oracle
    ``tests/oracle.py`` within the class bounds (HIGH 5e-5, DEFAULT 3.9e-2;
    ROADMAP.md C), and 3M missing HIGH's where 4M meets it (fault C3 at
    Kernel C's cells);
  * u8 bit-identical to decoded float32 on the same split and form;
  * Kernel A unchanged: the split plain version at ``(n / 128, 128)``
    equals ``curscan_tc_plain`` bit for bit;
  * the route: at HIGH and DEFAULT ``kernel_route`` is "tc" or "tc_split"
    exactly where JAX's ``_fused_choice`` picks a Pallas kernel, and
    ``tc_split`` is the split of the kernel it picks, for every fft
    2048-40000 at 50/75/90% and sampled sizes to 2^20, u8 and float32;
  * the card dispatch with a stand-in library: the split, the window
    groups at the library's occupancy, the cut-off builds and their
    launches;
  * the cut-offs' plain version (``curscan_tc_split_stage_plain``) and the
    stage-table script's pieces that need no card.
"""
import dataclasses
import functools
import stat
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.ops import mxu_fft as jmxu
from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu.ops import spectrum as jspec
from kspecanal_tpu_torch.config import WINDOW_ONES, SpecConfig
from kspecanal_tpu_torch.ops import _build, cuda_curscan, cuda_tc
from kspecanal_tpu_torch.ops import spectrum as tspec
from kspecanal_tpu_torch.ops.mxu_fft import round_bf16, split_bf16
from kspecanal_tpu_torch.scripts import tc_split_stages, threemult_smoke
from test_torch_lane import SAMPLED
from test_torch_precision import (ORACLE_BOUND, assert_class_close,
                                  fake_card, gauss, jax_form, oracle_error,
                                  port, window_peak)  # noqa: F401
from torch_parity import decoded, raw_planes, zs_cfg

CLASSES = ("HIGH", "DEFAULT")


def split_of(cfg, u8):
    """The split of the Pallas kernel JAX's dispatcher picks for ``cfg``."""
    choice = jspec._fused_choice(cfg, u8)
    if choice is None:
        return None
    n = cfg.fft_size
    return (n // 128, 128) if choice == "sublane" else jmxu._factorize(n)


def tc_split_port(re, im, cfg, form=None, split=None):
    return port(cuda_tc.curscan_tc_split, re, im, cfg, form=form,
                split=split)


# --- against the JAX kernels -------------------------------------------------

@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("fft,nono", [(2050, 0.5), (2050, 0.1), (3000, 0.5),
                                      (3000, 0.1), (10000, 0.5),
                                      (10000, 0.1)])
def test_lane_cells_match_jax(fft, nono, prec):
    """K3 off the 128 grid: raw u8 planes through Kernel C's plain version
    in the lane kernel's 3M form (bit-identical to their decoded float32)
    against the JAX lane kernel on the decoded planes (the JAX dispatcher
    decodes u8 before K3)."""
    cfg = zs_cfg(fft, nono, tpu_precision=prec)
    assert cuda_curscan.kernel_route(cfg) == "tc_split"
    assert jspec._fused_choice(cfg, True) == "lane"
    assert cuda_curscan.tc_split(cfg, True) == jmxu._factorize(fft)
    re, im = raw_planes(cfg, 1, seed=fft + int(10 * nono))
    want = np.asarray(jpk.curscan_fused(jnp.asarray(decoded(re)),
                                        jnp.asarray(decoded(im)), cfg,
                                        t_tile=1))
    got = tc_split_port(re, im, cfg, "force3m")
    np.testing.assert_array_equal(
        got, tc_split_port(decoded(re), decoded(im), cfg, "force3m"))
    assert_class_close(got, want, prec, window_peak(decoded(re),
                                                    decoded(im), cfg))


@pytest.mark.parametrize("nono", [0.5, 0.1])
@pytest.mark.parametrize("prec,u8", [("HIGH", False), ("DEFAULT", True)])
def test_sublane_cells_match_jax(prec, u8, nono):
    """The grid above fft 16384: fft 32768 (256 x 128) through the JAX
    sublane kernel (u8 decoded in its loads) and Kernel C's plain version in
    the JAX gate's form (3M, but 4M for DEFAULT u8 at 90%), one block."""
    cfg = zs_cfg(32768, nono, tpu_precision=prec)
    assert cuda_curscan.kernel_route(cfg) == "tc_split"
    assert jspec._fused_choice(cfg, u8) == "sublane"
    assert cuda_curscan.tc_split(cfg, u8) == (256, 128)
    re, im = raw_planes(cfg, 1, seed=int(nono * 10) + u8)
    if not u8:
        re, im = decoded(re), decoded(im)
    want = np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(re), jnp.asarray(im), cfg, t_tile=1))
    got = tc_split_port(re, im, cfg, jax_form(cfg, u8))
    f32 = (decoded(re), decoded(im)) if u8 else (re, im)
    assert_class_close(got, want, prec, window_peak(*f32, cfg))


def test_lane_split_at_65536_matches_jax():
    """fft 65536 at DEFAULT on float32 planes takes the lane kernel's split
    256 x 256 (u8 planes the sublane kernel's 512 x 128): against the JAX
    lane kernel, 3M, two blocks."""
    cfg = zs_cfg(65536, 0.5, tpu_precision="DEFAULT")
    assert jspec._fused_choice(cfg, False) == "lane"
    assert cuda_curscan.tc_split(cfg) == (256, 256)
    assert cuda_curscan.tc_split(cfg, True) == (512, 128)
    re, im = gauss(cfg, 2, seed=65536)
    want = np.asarray(jpk.curscan_fused(jnp.asarray(re), jnp.asarray(im), cfg,
                                        t_tile=2))
    got = tc_split_port(re, im, cfg, "force3m")
    assert_class_close(got, want, "DEFAULT", window_peak(re, im, cfg))


# --- against the float64 oracle ----------------------------------------------

ORACLE_CELLS = [(fft, nono) for fft in (2050, 3000, 10000, 32768)
                for nono in (0.5, 0.1)] + [(39800, 0.5), (65536, 0.5)]


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("fft,nono", ORACLE_CELLS)
def test_plain_meets_the_class_bound(fft, nono, prec, u8):
    """The production form (4M) on its split, two blocks of float32 noise
    or raw u8, kaiser: the worst bin within the class bound.  (HIGH at 90%
    from fft 8192 is fault C4's territory, where the bound may give way to
    JAX's own error; these cells meet the bound.)"""
    cfg = zs_cfg(fft, nono, tpu_precision=prec)
    re, im = raw_planes(cfg, 2, seed=7) if u8 else gauss(cfg, 2, seed=7)
    got = tc_split_port(re, im, cfg)
    f64 = (decoded(re), decoded(im)) if u8 else (re, im)
    assert oracle_error(got, *f64, cfg) <= ORACLE_BOUND[prec]


@pytest.mark.parametrize("fft", [10000, 32768])
def test_4m_meets_high_where_3m_misses(fft):
    """Fault C3 at Kernel C's cells: HIGH, ones window, 90% overlap (fmScan's
    geometry), four blocks of threemult_smoke's float32 noise: the JAX
    kernels' 3M misses 5e-5, the production 4M meets it."""
    cfg = threemult_smoke.job_cfg(fft, 0.1, "HIGH", WINDOW_ONES)
    re, im = threemult_smoke.planes(cfg, 4, False, 7, torch.device("cpu"))

    def err(form):
        got = cuda_tc.curscan_tc_split(re, im, cfg, form)
        return oracle_error(got.numpy().astype(np.float64), re.numpy(),
                            im.numpy(), cfg)
    assert err("force3m") > ORACLE_BOUND["HIGH"] >= err(None)


# --- u8, forms, Kernel A -----------------------------------------------------

@pytest.mark.parametrize("form", ["force3m", "no3m"])
@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("fft,nono", [(2050, 0.1), (65536, 0.5)])
def test_u8_bit_identical_on_the_same_split(fft, nono, prec, form):
    """u8 planes equal their decoded float32 bit for bit in either form on
    the same split (at fft 65536 DEFAULT the split u8 takes, 512 x 128,
    given to the float32 call)."""
    cfg = zs_cfg(fft, nono, "MIN", tpu_precision=prec)
    re, im = raw_planes(cfg, 1, seed=5)
    split = cuda_curscan.tc_split(cfg, True)
    got = tc_split_port(re, im, cfg, form)
    np.testing.assert_array_equal(
        got, tc_split_port(decoded(re), decoded(im), cfg, form, split))
    assert got.shape == (1, fft) and np.isfinite(got).all()
    assert not np.array_equal(got, tc_split_port(
        re, im, cfg, "no3m" if form == "force3m" else "force3m"))


@pytest.mark.parametrize("form", ["force3m", "no3m"])
@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("fft,nono", [(256, 0.5), (1280, 0.1), (2048, 0.5),
                                      (16384, 0.1)])
def test_kernel_a_split_is_the_plain_kernel_a(fft, nono, prec, form):
    """Kernel A's plain version is the split plain version at (n / 128,
    128), bit for bit, in both forms."""
    cfg = zs_cfg(fft, nono, "AVG", tpu_precision=prec)
    assert cuda_curscan.kernel_route(cfg) == "tc"
    re, im = gauss(cfg, 1, seed=fft)
    np.testing.assert_array_equal(
        port(cuda_tc.curscan_tc_plain, re, im, cfg, form=form),
        port(cuda_tc.curscan_tc_split_plain, re, im, cfg, form=form,
             split=(fft // 128, 128)))


def test_wrapper_refuses_what_it_does_not_take():
    """Kernel A's and HIGHEST configs, splits that are not factorisations
    and unknown forms raise (on the card also splits whose 16 rows of C
    exceed a block's shared memory: ``test_torch_gpu.py``)."""
    z = torch.zeros((1, zs_cfg(3000).full_size))
    for cfg in (zs_cfg(2048, tpu_precision="DEFAULT"), zs_cfg(3000)):
        zz = torch.zeros((1, cfg.full_size))
        with pytest.raises(ValueError, match="not supported"):
            cuda_tc.curscan_tc_split(zz, zz, cfg)
    cfg = zs_cfg(3000, tpu_precision="HIGH")
    with pytest.raises(ValueError, match="factorisation"):
        cuda_tc.curscan_tc_split(z, z, cfg, split=(64, 50))
    with pytest.raises(ValueError, match="unknown complex form"):
        cuda_tc.curscan_tc_split(z, z, cfg, form="3m")


# --- the route ---------------------------------------------------------------

class _WalkCfg(SpecConfig):
    """The port's config with its window starts computed once (the walk
    asks for them a dozen times a config)."""
    window_starts = functools.cached_property(SpecConfig.window_starts.fget)


def _walk(sizes, nono):
    missed, taken = [], 0
    for fft in sizes:
        base = _WalkCfg(prg_mode="ZEROSPAN", fft_size=fft,
                        sampling_rate=2.4e6, cur_scan_non_overlap=nono,
                        x_res=min(fft, 512)).finalize()
        for prec in CLASSES:
            cfg = dataclasses.replace(base, tpu_precision=prec)
            route = cuda_curscan.kernel_route(cfg)
            for u8 in (False, True):
                want = split_of(cfg, u8)
                ok = (route is None if want is None else
                      route in ("tc", "tc_split")
                      and cuda_curscan.tc_split(cfg, u8) == want
                      and (route == "tc") == (want[1] == 128
                                              and fft <= 16384))
                taken += want is not None
                if not ok:
                    missed.append((fft, prec, u8, route, want))
    return missed, taken


@pytest.mark.parametrize("nono", [0.5, 0.25, 0.1])
def test_route_walk_2048_to_40000(nono):
    """Every fft 2048-40000: Kernel A or Kernel C exactly where JAX picks a
    Pallas kernel, on its split, Kernel A where that split is the sublane
    one up to fft 16384, at both classes and input types."""
    missed, taken = _walk(range(2048, 40001, 1), nono)
    assert missed == []
    assert taken > 4 * {0.5: 4603, 0.25: 1948, 0.1: 779}[nono]


def test_route_walk_sampled_to_2_20():
    """The same at every fifth sampled size from 2048 to 2^20, each
    overlap."""
    taken = 0
    for nono in (0.5, 0.25, 0.1):
        missed, n = _walk(SAMPLED[::5], nono)
        assert missed == [], (nono, missed[:5])
        taken += n
    assert taken > 400


def test_highest_routes_as_before():
    """HIGHEST keeps the FFT kernel wherever JAX picks a Pallas kernel."""
    for fft in (2050, 3000, 10000, 32768, 65536, 131100):
        for nono in (0.5, 0.1):
            cfg = zs_cfg(fft, nono, x_res=500)
            want = jspec._fused_choice(cfg, False) is not None
            assert cuda_curscan.kernel_route(cfg) == ("fft" if want
                                                      else None)


# --- the card dispatch -------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_card_dispatch_launches_kernel_c(fake_card, dtype):
    """On the card, HIGH/DEFAULT configs of K3 off the grid and of the grid
    above 16384 launch Kernel C (counted in ``tc_split_launches``) with the
    split the JAX dispatcher takes for the planes' type, the class and the
    4M form; neither Kernel A's nor the FFT kernel's counter moves.  Where
    the library finds no m-tiles a block that fit, the wrapper raises and
    launches nothing."""
    fake_card.kspec_curscan_tc_split = fake_card._entry(
        "kspec_curscan_tc_split")
    fake_card.kspec_curscan_tc_split_mt = lambda n1, n2, high, tm: int(
        n2 < 1000)
    fake_card.kspec_curscan_tc_split_occupancy = (
        lambda u8, n1, n2, high, tm: 2)
    u8 = dtype == torch.uint8
    for fft, nono, prec, t, split in (
            (3000, 0.5, "DEFAULT", 4096, (60, 50)),
            (10000, 0.1, "HIGH", 16, (100, 100)),
            (39800, 0.5, "HIGH", 64, (200, 199)),
            (65536, 0.5, "DEFAULT", 64, (512, 128) if u8 else (256, 256)),
            (32768, 0.1, "HIGH", 64, (256, 128))):
        cfg = zs_cfg(fft, nono, tpu_precision=prec, x_res=500)
        planes = torch.empty((t, cfg.full_size), device="meta", dtype=dtype)
        fake_card.calls.clear()
        before = (cuda_tc.tc_split_launches, cuda_tc.tc_launches,
                  cuda_curscan.launches)
        out = tspec.curscan_auto_batched(planes, planes, cfg)
        assert out.shape == (t, fft)
        [(name, args)] = fake_card.calls
        assert name == "kspec_curscan_tc_split"
        assert args[2] == int(u8)
        groups = cuda_tc.tc_split_groups(t, -(-split[0] // 16),
                                         cfg.num_windows, 132, 2)
        assert args[11:21] == (t, cfg.full_size, fft, *split,
                               cfg.num_windows, groups,
                               cuda_curscan._FOLD["AVG"],
                               int(prec == "HIGH"), 0)
        assert (cuda_tc.tc_split_launches, cuda_tc.tc_launches,
                cuda_curscan.launches) == (before[0] + 1, *before[1:])
    cfg = zs_cfg(3000, 0.5, tpu_precision="HIGH", x_res=500)
    planes = torch.empty((4, cfg.full_size), device="meta", dtype=dtype)
    fake_card.calls.clear()
    with pytest.raises(ValueError, match="shared memory"):
        cuda_tc.curscan_tc_split(planes, planes, cfg, split=(1, 3000))
    assert fake_card.calls == []


def _kernel_c_card(fake_card, mt=lambda n1, n2, high, tm: int(n2 < 1000),
                   per_sm=2):
    fake_card.kspec_curscan_tc_split = fake_card._entry(
        "kspec_curscan_tc_split")
    fake_card.kspec_curscan_tc_split_mt = mt
    fake_card.kspec_curscan_tc_split_occupancy = (
        lambda u8, n1, n2, high, tm: per_sm)
    return fake_card


def test_window_groups_of_kernel_c():
    """Kernel C's window groups per IQ block and k1 tile
    (``tc_split_groups``): Kernel A's choice over t x tiles blocks; one at
    the T=4096 cells, one a window for the serial zero-span session's T=1,
    four at fft 10000 90% T=16 on DEFAULT's 4 tiles at two blocks an SM,
    one at HIGH's 7 tiles at one (112 blocks fill the card), never more
    than the windows."""
    assert cuda_tc.tc_split_groups(4096, 1, 15, 132, 2) == 1
    assert cuda_tc.tc_split_groups(4096, 2, 15, 132, 1) == 1
    assert cuda_tc.tc_split_groups(1, 1, 15, 132, 2) == 15
    assert cuda_tc.tc_split_groups(1, 2, 15, 132, 1) == 15
    assert cuda_tc.tc_split_groups(16, 4, 71, 132, 2) == 4
    assert cuda_tc.tc_split_groups(16, 7, 71, 132, 1) == 7
    assert cuda_tc.tc_split_groups(3, 2, 71, 132, 1) == 22
    assert cuda_tc.tc_split_groups(64, 16, 15, 132, 2) == 1
    assert cuda_tc.tc_split_groups(64, 32, 15, 132, 1) == 1
    assert cuda_tc.tc_split_groups(64, 8, 71, 132, 2) == 1
    for t in (1, 3, 16, 64, 4096):
        for tiles in (1, 2, 7, 32):
            for w in (1, 15, 71):
                for per_sm in (1, 2):
                    g = cuda_tc.tc_split_groups(t, tiles, w, 132, per_sm)
                    assert 1 <= g <= w
                    assert g == cuda_tc.tc_groups(t * tiles, 0, w, 132,
                                                  per_sm)


@pytest.mark.parametrize("t,fft,nono,prec,mt,per_sm,tiles,groups", [
    (4096, 3000, 0.5, "DEFAULT", 4, 2, 1, 1),
    (1, 3000, 0.5, "DEFAULT", 4, 2, 1, 15),
    (16, 10000, 0.1, "DEFAULT", 2, 2, 4, 4),
    (16, 10000, 0.1, "HIGH", 1, 1, 7, 7),
    (3, 2050, 0.1, "HIGH", 2, 1, 2, 22)])
def test_card_dispatch_launches_kernel_c_in_window_groups(
        fake_card, t, fft, nono, prec, mt, per_sm, tiles, groups):
    """The dispatcher launches Kernel C with the groups of
    ``tc_split_groups`` over the library's tiles (n1's m-tiles over its
    m-tiles a block) at its occupancy, and a (T, G, fft) partial buffer
    where G > 1; ``launch_tc_split`` takes groups it is given."""
    lib = _kernel_c_card(fake_card, lambda n1, n2, high, tm: mt, per_sm)
    cfg = zs_cfg(fft, nono, tpu_precision=prec, x_res=500)
    planes = torch.empty((t, cfg.full_size), device="meta")
    split = cuda_curscan.tc_split(cfg)
    assert cuda_tc.tc_split_tiles(lib, *split, prec == "HIGH", False) == tiles
    lib.calls.clear()
    tspec.curscan_auto_batched(planes, planes, cfg)
    [(name, args)] = lib.calls
    assert name == "kspec_curscan_tc_split" and args[17] == groups
    lib.calls.clear()
    before = cuda_tc.tc_split_launches
    out = cuda_tc.launch_tc_split(lib, planes, planes, cfg, False, split, 3)
    assert out.shape == (t, fft) and cuda_tc.tc_split_launches == before
    [(name, args)] = lib.calls
    assert args[17] == 3


def test_kernel_c_cut_offs_launch_their_builds(fake_card, monkeypatch):
    """``curscan_tc_split_stage`` on the card: each cut-off launches its
    own build (``tc_split_stage_library``, ``KSPEC_TCS_STOP`` 1-4) with
    the production library's window groups; 'full' launches the port's
    library; each counts in ``tc_split_stage_launches`` and not in
    ``tc_split_launches``."""
    prod = _kernel_c_card(fake_card, per_sm=1)
    builds = {}

    def build(stage):
        lib = types.SimpleNamespace(calls=[])
        lib.kspec_curscan_tc_split = lambda *args: lib.calls.append(args) \
            or 0
        lib.kspec_curscan_tc_split.__name__ = "kspec_curscan_tc_split"
        lib.kspec_curscan_tc_split_mt = prod.kspec_curscan_tc_split_mt
        return builds.setdefault(stage, lib)
    monkeypatch.setattr(cuda_tc, "tc_split_stage_library", build)
    cfg = zs_cfg(3000, 0.5, tpu_precision="HIGH", x_res=500)
    planes = torch.empty((2, cfg.full_size), device="meta")
    groups = cuda_tc.tc_split_groups(2, 4, 15, 132, 1)
    assert [cuda_tc.tc_split_stage_stop(s) for s in
            cuda_tc.TC_SPLIT_STAGES] == [1, 2, 3, 4, 0]
    for stage in cuda_tc.TC_SPLIT_STAGES:
        prod.calls.clear()
        before = (cuda_tc.tc_split_stage_launches, cuda_tc.tc_split_launches)
        out = cuda_tc.curscan_tc_split_stage(planes, planes, cfg, stage)
        assert out.shape == (2, 3000)
        assert (cuda_tc.tc_split_stage_launches,
                cuda_tc.tc_split_launches) == (before[0] + 1, before[1])
        if stage == "full":
            [(_, args)] = prod.calls
        else:
            assert prod.calls == []
            [args] = builds[stage].calls
        assert args[14:18] == (60, 50, 15, groups)
    with pytest.raises(ValueError, match="unknown Kernel C stage"):
        cuda_tc.curscan_tc_split_stage(planes, planes, cfg, "s1x")


def test_stage_variant_builds_kernel_c_with_its_cut_off(tmp_path,
                                                        monkeypatch):
    """``_build.load_variant`` of Kernel C's cut-off (``scripts/
    tc_split_stages.py``) with a stand-in nvcc that logs its arguments:
    Kernel C's two sources, each compiled with ``-DKSPEC_TCS_STOP=s``,
    linked into a variant library of its own name beside the port's;
    ``tc_split_stage_variants`` lists the four cut-offs."""
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
    lib = cuda_tc.tc_split_stage_library("s1")
    calls = log.read_text().splitlines()
    compiles = [c.split() for c in calls if " -c " in c]
    assert sorted(Path(c[-1]).name for c in compiles) == [
        "curscan_tc_split.cu", "curscan_tc_split_high.cu"]
    assert all("-DKSPEC_TCS_STOP=2" in c for c in compiles)
    assert calls[-1].startswith("-shared")
    assert Path(lib.path).name.startswith("libkspec_variant_")
    assert Path(lib.path).name != _build.library_path().name
    assert cuda_tc.tc_split_stage_variants() == [
        (cuda_tc.TC_SPLIT_SOURCES, (f"KSPEC_TCS_STOP={s}",))
        for s in (1, 2, 3, 4)]


@pytest.mark.parametrize("prec", CLASSES)
def test_cut_off_frame_is_the_rounded_windowed_frame(prec):
    """The 'frame' cut-off's plain version, on the CPU: the sum over windows
    of weights[w] (x_re win + x_im win as rounded: bf16, hi + lo at HIGH)
    at (m1, m2) in the production layout, from numpy framing; 'full' is
    ``curscan_tc_split`` bit for bit."""
    cfg = zs_cfg(3000, 0.5, tpu_precision=prec, x_res=500)
    re, im = gauss(cfg, 1, seed=3)
    got = cuda_tc.curscan_tc_split_stage(torch.from_numpy(re),
                                         torch.from_numpy(im), cfg, "frame")
    _, weights, win, _ = cuda_curscan._tables(
        3000, cfg.window, cfg.window_starts, cfg.cur_scan_cumu_mode,
        torch.device("cpu"))

    def rounded(x):
        if prec == "HIGH":
            hi, lo = split_bf16(x)
            return hi + lo
        return round_bf16(x)
    acc = torch.zeros(3000)
    for j, s in enumerate(cfg.window_starts):
        fr = rounded(torch.from_numpy(re[0, s:s + 3000]) * win)
        fi = rounded(torch.from_numpy(im[0, s:s + 3000]) * win)
        acc = acc + weights[j] * (fr + fi)
    want = cuda_curscan.stage_layout_to_spectrum(acc.view(1, 60, 50))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    planes = (torch.from_numpy(re), torch.from_numpy(im))
    assert torch.equal(cuda_tc.curscan_tc_split_stage(*planes, cfg, "full"),
                       cuda_tc.curscan_tc_split(*planes, cfg))


def test_tc_split_stages_script_pieces_on_the_cpu():
    """``scripts/tc_split_stages.py`` measures the card only: without one it
    exits before any timing; its bound is the 4M tensor-core flops (x3 at
    HIGH) or the bytes; it reads ptxas' lines of Kernel C's instantiations
    (the first build of each) from a build log."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tc_split_stages.main([])
    cfg = tc_split_stages.cell_cfg(10000, 0.5, "DEFAULT")
    ms, by = tc_split_stages.bound_ms(cfg, 4096, False, (100, 100))
    assert by == "operations"
    assert ms == pytest.approx(8 * 100 * 100 * 200 * 4096 * 15 / 989e12 * 1e3)
    high = tc_split_stages.cell_cfg(10000, 0.5, "HIGH")
    assert tc_split_stages.bound_ms(high, 4096, False, (100, 100))[0] == \
        pytest.approx(3 * ms)
    cfg = tc_split_stages.cell_cfg(3000, 0.5, "DEFAULT")
    assert tc_split_stages.bound_ms(cfg, 4096, False, (60, 50))[1] == "bytes"
    name = "_ZN9kspec_tcs23curscan_tc_split_kernelIfLb0ELb0ELi4ELi1ELb1EEEv"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 120 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN8kspec_tc5otherE' for "
        "'sm_90a'",
        "ptxas info    : Used 40 registers",
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        "ptxas info    : Used 99 registers, used 1 barriers"])
    assert tc_split_stages.ptxas_lines(log) == [
        f"{name}: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads", f"{name}: Used 120 registers, used 1 barriers"]
    assert len(tc_split_stages.CELLS) == 14
