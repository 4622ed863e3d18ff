"""K4 at every class: the stage ablation of ``scripts/roofline_r2.py``
(``_kernel_ablate``, which the JAX script runs at DEFAULT) on Kernel A's
cut-offs (``cuda_tc.curscan_tc_stage``, ``csrc/curscan_tc.cuh`` built with
``-DKSPEC_TC_STOP``; HIGHEST in the six-pass builds, ``-DKSPEC_TC_HIGHEST``).

On the CPU ``cuda_curscan.curscan_stage_ablate`` runs the plain version
(``cuda_tc.curscan_tc_stage_plain``: Kernel A's rounding points, 4M); the
JAX side runs the script's Pallas kernel in interpret mode at the same
class, its module global ``pl`` swapped for an interpreting one as in
test_torch_ablate.py.  On the CPU JAX's DEFAULT dot does not round to bf16,
so the class's ``torch_parity.TC_TOL`` is the bound.  The card's
dispatch runs here against a stand-in library on 'meta' tensors."""
import contextlib
import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kspecanal_tpu_torch.ops import cuda_curscan as cc
from kspecanal_tpu_torch.ops import cuda_tc
from torch_parity import assert_tc_close, zs_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def roofline_module():
    spec = importlib.util.spec_from_file_location(
        "roofline_r2_jax_class",
        os.path.join(REPO, "scripts", "roofline_r2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def roofline(monkeypatch):
    """The JAX script with interpreting Pallas calls."""
    mod = roofline_module()
    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True)))
    return mod


def planes(cfg, seed, t=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((t, cfg.full_size)).astype(np.float32)
                 for _ in range(2))


CLASSES = ("DEFAULT", "HIGH", "HIGHEST")


@pytest.mark.parametrize("stage", cc.STAGES)
@pytest.mark.parametrize("fft", [512, 2048])
@pytest.mark.parametrize("prec", CLASSES)
def test_class_stage_matches_jax_roofline_kernel(roofline, prec, fft, stage):
    cfg = zs_cfg(fft, tpu_precision=prec)
    re, im = planes(cfg, fft + 7 * cc.STAGES.index(stage))
    want = np.asarray(roofline.build(cfg, 1, stage)(jnp.asarray(re),
                                                    jnp.asarray(im)))
    got = cc.curscan_stage_ablate(torch.from_numpy(re), torch.from_numpy(im),
                                  cfg, stage)
    assert got.shape == (2, fft // 128, 128) and got.dtype == torch.float32
    assert_tc_close(got.numpy(), want, prec)


@pytest.mark.parametrize("prec", CLASSES)
def test_class_full_is_kernel_a_plain_under_the_layout_map(prec):
    """'full' is Kernel A's plain version bit for bit after the layout map,
    and the inverse map takes it back."""
    cfg = zs_cfg(2048, tpu_precision=prec)
    re, im = (torch.from_numpy(p) for p in planes(cfg, 11, t=3))
    full = cc.curscan_stage_ablate(re, im, cfg, "full")
    spec = cc.stage_layout_to_spectrum(full)
    assert torch.equal(spec, cuda_tc.curscan_tc_plain(re, im, cfg))
    assert torch.equal(cc.spectrum_to_stage_layout(spec, 16), full)


@pytest.mark.parametrize("prec", CLASSES)
def test_class_frame_stage_holds_the_rounded_operands(prec):
    """The frame cut-off folds the frames as Kernel A stages them: a frame
    of ones times the window, rounded (bf16; hi + lo at HIGH; (hi + mid) +
    lo at HIGHEST), weighted over the windows; 'read' sums the raw slabs,
    unrounded."""
    cfg = zs_cfg(512, tpu_precision=prec)
    re = torch.full((1, cfg.full_size), 1.0 / 3.0)
    im = torch.zeros((1, cfg.full_size))
    got = cc.curscan_stage_ablate(re, im, cfg, "frame")
    win = torch.as_tensor(cuda_tc._plain_tables(512, cfg.window,
                                                torch.device("cpu"))[8])
    x = cuda_tc._operand_value(re[0, :512].reshape(4, 128) * win, prec)
    weights = cc._tables(512, cfg.window, cfg.window_starts, "AVG",
                         torch.device("cpu"))[1]
    want = None
    for w in weights:
        want = w * x if want is None else want + w * x
    assert torch.equal(got[0], want)
    read = cc.curscan_stage_ablate(re, im, cfg, "read")
    slabs = cfg.full_size // 512
    assert torch.allclose(read, torch.full((1, 4, 128), slabs / 3.0))


def test_class_stage_refusals():
    """K4 refuses the same cases at every class, and above fft 16384 (Kernel
    A's configs) at every class."""
    f32 = torch.zeros((1, zs_cfg(2048).full_size))
    for prec in CLASSES:
        cfg = zs_cfg(2048, tpu_precision=prec)
        with pytest.raises(ValueError, match="unknown stage"):
            cc.curscan_stage_ablate(f32, f32, cfg, "s3")
        with pytest.raises(TypeError):
            cc.curscan_stage_ablate(f32.to(torch.uint8), f32.to(torch.uint8),
                                    cfg, "full")
        with pytest.raises(ValueError, match="AVG"):
            cc.curscan_stage_ablate(f32, f32, zs_cfg(
                2048, mode="MAX", tpu_precision=prec), "s1")
        big = zs_cfg(32768, tpu_precision=prec)
        z = torch.zeros((1, big.full_size))
        with pytest.raises(ValueError, match="Kernel A's configs"):
            cc.curscan_stage_ablate(z, z, big, "s2")


def test_stage_stops_and_variants():
    """KSPEC_TC_STOP of each stage (read 1 .. s2 5, 'full' the production
    library's 0) and the five cut-off builds of Kernel A's two sources."""
    assert [cuda_tc.tc_stage_stop(s) for s in cc.STAGES] == [1, 2, 3, 4, 5,
                                                              0]
    assert cuda_tc.stage_variants() == [
        (("curscan_tc.cu", "curscan_tc_high.cu"), (f"KSPEC_TC_STOP={i}",))
        for i in range(1, 6)]


class _Lib:
    """A stand-in library: records Kernel A's launches; its occupancy
    query answers ``blocks``."""

    def __init__(self, name, blocks):
        self.name, self.blocks, self.calls = name, blocks, []

    def kspec_curscan_tc_occupancy(self, *args):
        return self.blocks

    def kspec_curscan_tc(self, *args):
        self.calls.append(args)
        return 0

    def __hash__(self):
        return hash(self.name)


@pytest.fixture
def fake_card(monkeypatch):
    """'meta' tensors routed as the card's: the port's library (and at
    HIGHEST Kernel A's HIGHEST build) answers one block an SM, each cut-off
    build two."""
    prod = _Lib("production", 1)
    stages = {s: _Lib(s, 2) for s in cc.STAGES[:-1]}
    monkeypatch.setattr(cuda_tc, "_cuda_lib", lambda dev: prod)
    monkeypatch.setattr(cuda_tc, "highest_library", lambda: prod)
    monkeypatch.setattr(cuda_tc, "stage_library",
                        lambda s, highest=False: stages[s])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev=None: types.SimpleNamespace(multi_processor_count=132))
    return prod, stages


@pytest.mark.parametrize("prec", CLASSES)
def test_card_dispatch_launches_kernel_a_cut_offs(fake_card, prec):
    """On the card each stage below 'full' launches its cut-off build and
    'full' the port's library (HIGHEST: Kernel A's HIGHEST build), all at
    the window groups of that library's occupancy, 4M, at the class's
    precision code, counted in ``tc_stage_launches`` (Kernel A's own and the
    mixed cut-offs' counters do not move)."""
    prod, stages = fake_card
    cfg = zs_cfg(16384, tpu_precision=prec)
    t = 32
    planes_ = torch.empty((t, cfg.full_size), device="meta")
    groups = cuda_tc.tc_groups(t, 128, cfg.num_windows, 132, 1)
    assert groups == 4
    for stage in cc.STAGES:
        before = (cuda_tc.tc_stage_launches, cuda_tc.tc_launches,
                  cc.forensic_launches)
        out = cc.curscan_stage_ablate(planes_, planes_, cfg, stage)
        assert out.shape == (t, 128, 128)
        lib = prod if stage == "full" else stages[stage]
        [args] = lib.calls
        lib.calls.clear()
        assert args[11:21] == (t, cfg.full_size, 16384, 128, cfg.num_windows,
                               groups, cc._FOLD["AVG"], 1,
                               cuda_tc.PREC_CODE[prec], 0)
        assert (cuda_tc.tc_stage_launches, cuda_tc.tc_launches,
                cc.forensic_launches) == (before[0] + 1, before[1],
                                          before[2])


def test_highest_stage_variants_and_libraries(monkeypatch):
    """The HIGHEST forensic builds: Kernel A whole, its five cut-offs and
    its ablate build, and Kernel C's ablate build, each with
    ``KSPEC_TC_HIGHEST=1``; the loaders ask ``_build.load_variant`` for
    exactly those."""
    hi = "KSPEC_TC_HIGHEST=1"
    a = ("curscan_tc.cu", "curscan_tc_high.cu")
    c = ("curscan_tc_split.cu", "curscan_tc_split_high.cu")
    assert cuda_tc.highest_variants() == [(a, (hi,))] + [
        (a, (hi, f"KSPEC_TC_STOP={i}")) for i in range(1, 6)] + [
        (a, (hi, "KSPEC_TC_ABLATE=1")), (c, (hi, "KSPEC_TCS_ABLATE=1"))]
    from kspecanal_tpu_torch.ops import _build
    asked = []
    monkeypatch.setattr(_build, "load_variant",
                        lambda names, defines: asked.append((names, defines)))
    cuda_tc.highest_library()
    for stage in cc.STAGES[:-1]:
        cuda_tc.stage_library(stage, highest=True)
    cuda_tc.tc_ablate_library(highest=True)
    cuda_tc.tc_split_ablate_library(highest=True)
    assert asked == cuda_tc.highest_variants()
    asked.clear()
    cuda_tc.stage_library("s1")
    cuda_tc.tc_ablate_library()
    assert asked == [(a, ("KSPEC_TC_STOP=3",)), (a, ("KSPEC_TC_ABLATE=1",))]
