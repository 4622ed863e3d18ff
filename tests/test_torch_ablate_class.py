"""K1's ``ablate`` keys at every class: ``scripts/kernel_ablate.py``'s
stage removals (``pallas_curscan.curscan_fused_sublane(..., ablate=keys)``)
on the tensor-core kernels, Kernel A up to fft 16384 and Kernel C on the
sublane split above (``cuda_tc.curscan_tc`` / ``curscan_tc_split(...,
ablate)``, their ablate builds ``-DKSPEC_TC_ABLATE`` and
``-DKSPEC_TCS_ABLATE``; HIGHEST in their six-pass builds,
``-DKSPEC_TC_HIGHEST``).

On the CPU the class entries run their plain versions (Kernel A's rounding
points, ``cuda_curscan.two_stage_chain``'s pass-throughs); the JAX side runs
its kernel in interpret mode at the same class with ``no3m`` added, so both
run the 4M form.  On the CPU JAX's DEFAULT dot does not round to bf16, so
the class's ``torch_parity.TC_TOL`` is the bound.  The card's dispatch runs
here against stand-in libraries on 'meta' tensors; the card's own checks
are in test_torch_gpu.py and chip_smoke.py."""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu_torch.ops import cuda_curscan as cc
from kspecanal_tpu_torch.ops import cuda_tc
from kspecanal_tpu_torch.scripts import kernel_ablate
from torch_parity import assert_tc_close, decoded, raw_planes, zs_cfg

CLASSES = ("HIGHEST", "HIGH", "DEFAULT")


def planes(cfg, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, cfg.full_size)).astype(np.float32)
                 for _ in range(2))


def jax_ablate(re, im, cfg, keys):
    """JAX's kernel in interpret mode with ``keys`` removed, 4M."""
    return np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(re), jnp.asarray(im), cfg, ablate=tuple(keys) + ("no3m",)))


def port_ablate(re, im, cfg, keys, form=None):
    return cuda_tc.curscan_tc(torch.from_numpy(re), torch.from_numpy(im),
                              cfg, form, ablate=keys).numpy()


@pytest.mark.parametrize("key", sorted(cc.ABLATE_KEYS))
@pytest.mark.parametrize("prec", CLASSES)
def test_ablate_key_matches_jax_kernel(prec, key):
    """Every stage key at fft 512 on float32 planes."""
    cfg = zs_cfg(512, tpu_precision=prec)
    re, im = planes(cfg, 70 + sorted(cc.ABLATE_KEYS).index(key))
    got = port_ablate(re, im, cfg, (key,))
    assert got.shape == (2, 512) and got.dtype == np.float32
    assert_tc_close(got, jax_ablate(re, im, cfg, (key,)), prec)


@pytest.mark.parametrize("name,keys", kernel_ablate.VARIANTS,
                         ids=[v[0] for v in kernel_ablate.VARIANTS])
def test_kernel_ablate_variants_match_jax_on_u8(name, keys):
    """The script's ten variants at its own cell: fft 2048, 50%, DEFAULT,
    raw u8 planes (decoded in the kernel; JAX takes the decoded planes).
    'base' is Kernel A's ablate build with no key."""
    cfg = zs_cfg(2048, tpu_precision="DEFAULT")
    re, im = raw_planes(cfg, 2, seed=71)
    assert_tc_close(port_ablate(re, im, cfg, keys),
                    jax_ablate(decoded(re), decoded(im), cfg, keys),
                    "DEFAULT")


@pytest.mark.parametrize("keys", [("sqrt",), ("cumulate",)])
@pytest.mark.parametrize("mode", ["MAX", "MIN", "RAW"])
@pytest.mark.parametrize("prec", CLASSES)
def test_sqrt_and_cumulate_under_other_folds(prec, mode, keys):
    """'sqrt' keeps the mode's fold of |D|^2; 'cumulate' sums |D|
    unweighted whatever the mode."""
    cfg = zs_cfg(512, mode=mode, tpu_precision=prec)
    re, im = planes(cfg, 72)
    assert_tc_close(port_ablate(re, im, cfg, keys),
                    jax_ablate(re, im, cfg, keys), prec)


def test_force3m_with_win_at_high_matches_jax():
    """The 3M form with the window removed, against JAX's kernel with the
    same keys, through ``curscan_fused_sublane`` as the script calls it."""
    cfg = zs_cfg(512, tpu_precision="HIGH")
    re, im = planes(cfg, 73)
    keys = ("win", "force3m")
    want = np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(re), jnp.asarray(im), cfg, ablate=keys))
    got = cc.curscan_fused_sublane(torch.from_numpy(re), torch.from_numpy(im),
                                   cfg, ablate=keys)
    assert_tc_close(got.numpy(), want, "HIGH")
    assert torch.equal(got, torch.from_numpy(
        port_ablate(re, im, cfg, ("win",), "force3m")))


@pytest.mark.parametrize("prec", CLASSES)
def test_kernel_c_plain_equals_kernel_a_plain_under_every_key(prec):
    """On the sublane split (n / 128, 128) Kernel C's plain version is
    Kernel A's bit for bit under every key, and the dispatch of
    ``curscan_fused_sublane`` gives the same."""
    cfg = zs_cfg(2048, tpu_precision=prec)
    re, im = (torch.from_numpy(p) for p in planes(cfg, 74))
    for keys in [(k,) for k in sorted(cc.ABLATE_KEYS)] + [
            v[1] for v in kernel_ablate.VARIANTS]:
        a = cuda_tc.curscan_tc(re, im, cfg, ablate=keys)
        c = cuda_tc.curscan_tc_split_plain(re, im, cfg, None, (16, 128),
                                           keys)
        assert torch.equal(a, c), keys
        if keys:
            assert torch.equal(cc.curscan_fused_sublane(re, im, cfg,
                                                        ablate=keys), a)


@pytest.mark.parametrize("prec", CLASSES)
def test_no_stage_removed_is_the_production_plain_version(prec):
    """No key, or 'concat' alone, is Kernel A's plain version bit for bit;
    u8 planes equal their decoded float32 bit for bit under every key."""
    cfg = zs_cfg(512, tpu_precision=prec)
    re, im = raw_planes(cfg, 2, seed=75)
    r8, i8 = torch.from_numpy(re), torch.from_numpy(im)
    rf, i_f = torch.from_numpy(decoded(re)), torch.from_numpy(decoded(im))
    prod = cuda_tc.curscan_tc_plain(r8, i8, cfg)
    for keys in ((), ("concat",)):
        assert torch.equal(cuda_tc.curscan_tc(r8, i8, cfg, ablate=keys), prod)
    for name, keys in kernel_ablate.VARIANTS:
        assert torch.equal(cuda_tc.curscan_tc(r8, i8, cfg, ablate=keys),
                           cuda_tc.curscan_tc(rf, i_f, cfg, ablate=keys))


def test_removed_stages_take_the_staged_operands():
    """Without stage 1 B is the frame as staged (bf16, or its parts summed
    at HIGH and HIGHEST), without stage 2 D is C as staged; with every
    stage but the fold removed, the spectrum is the weighted fold of
    |rounded frame|^2 at 'sqrt' and the plain sum of |rounded frame| at
    'cumulate'."""
    for prec in CLASSES:
        cfg = zs_cfg(512, tpu_precision=prec)
        re, im = (torch.from_numpy(p) for p in planes(cfg, 76))
        keys = ("win", "stage1", "twiddle", "stage2", "cumulate")
        frame = [cuda_tc._operand_value(cuda_tc._operand_value(
            cc.spectrum.frame_signal(p, cfg.window_starts, 512), prec), prec)
            for p in (re, im)]
        mag = torch.sqrt(frame[0] ** 2 + frame[1] ** 2)
        want = None
        for j in range(mag.shape[1]):
            want = mag[:, j] if want is None else want + mag[:, j]
        want = cc.stage_layout_to_spectrum(want.reshape(2, 4, 128))
        got = cuda_tc.curscan_tc(re, im, cfg, ablate=keys)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_class_ablate_refusals():
    """Form keys belong to ``form`` on the class entries; unknown keys
    raise; outside the sublane predicate (K3 off the grid) the keys have
    no JAX kernel to follow; ``force3m`` without a stage key still raises
    on the FFT kernel."""
    cfg = zs_cfg(512, tpu_precision="DEFAULT")
    z = torch.zeros((1, cfg.full_size))
    with pytest.raises(ValueError, match="form"):
        cuda_tc.curscan_tc(z, z, cfg, ablate=("win", "no3m"))
    with pytest.raises(ValueError, match="unknown ablate key"):
        cuda_tc.curscan_tc(z, z, cfg, ablate=("stage3",))
    with pytest.raises(ValueError, match="unknown ablate key"):
        cc.curscan_fused_sublane(z, z, cfg, ablate=("stage3",))
    with pytest.raises(ValueError, match="force3m"):
        cc.curscan_fused_sublane(z, z, cfg, ablate=("force3m",))
    off = zs_cfg(3000, tpu_precision="DEFAULT")
    z = torch.zeros((1, off.full_size))
    with pytest.raises(ValueError, match="sublane"):
        cc.curscan_fused_sublane(z, z, off, ablate=("win",))


class _Lib:
    """A stand-in library: records the launches of every entry point it is
    given; the occupancy and m-tile queries answer as a card would."""

    def __init__(self, name, *entries):
        self.name, self.calls = name, []
        for entry in entries:
            setattr(self, entry, self._entry(entry))

    def _entry(self, entry):
        def fn(*args):
            self.calls.append((entry, args))
            return 0
        fn.__name__ = entry
        return fn

    @staticmethod
    def kspec_curscan_tc_occupancy(*args):
        return 1

    @staticmethod
    def kspec_curscan_tc_smem(*args):
        return 0

    @staticmethod
    def kspec_curscan_tc_split_occupancy(*args):
        return 1

    @staticmethod
    def kspec_curscan_tc_split_mt(*args):
        return 4

    def __hash__(self):
        return hash(self.name)


@pytest.fixture
def fake_card(monkeypatch):
    """'meta' tensors routed as the card's: the port's library (and Kernel
    A's HIGHEST build) and the ablate builds are stand-ins."""
    prod = _Lib("production", "kspec_curscan_tc", "kspec_curscan_tc_split",
                "kspec_curscan_fft", "kspec_curscan_sublane")
    a = _Lib("kernel A ablate", "kspec_curscan_tc_ablate")
    c = _Lib("kernel C ablate", "kspec_curscan_tc_split_ablate")
    for mod in (cc, cuda_tc):
        monkeypatch.setattr(mod, "_cuda_lib", lambda dev: prod)
    monkeypatch.setattr(cuda_tc, "highest_library", lambda: prod)
    monkeypatch.setattr(cuda_tc, "tc_ablate_library",
                        lambda highest=False: a)
    monkeypatch.setattr(cuda_tc, "tc_split_ablate_library",
                        lambda highest=False: c)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev=None: types.SimpleNamespace(multi_processor_count=132))
    return prod, a, c


def counters():
    return (cc.forensic_launches, cc.launches, cuda_tc.tc_launches,
            cuda_tc.tc_split_launches, cuda_tc.tc_ablate_launches,
            cuda_tc.tc_split_ablate_launches, cc.direct_launches)


@pytest.mark.parametrize("prec", CLASSES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_card_dispatch_never_reaches_the_direct_kernel(fake_card, prec,
                                                       dtype):
    """At every class every variant of the script but 'base' (no key: the
    FFT kernel) launches the class kernel's ablate build with its mask
    (Kernel A at fft 2048, Kernel C on (256, 128) at fft 32768), at the
    precision code of the class, the window groups of the production
    library (HIGHEST: Kernel A's HIGHEST build, Kernel C's ablate build)
    and the form its keys pick, counted in ``tc_ablate_launches`` /
    ``tc_split_ablate_launches``; the direct kernel, the FFT kernel and the
    production kernels launch nothing."""
    prod, a, c = fake_card
    for fft, t, lib, entry, moves in (
            (2048, 64, a, "kspec_curscan_tc_ablate", 4),
            (32768, 8, c, "kspec_curscan_tc_split_ablate", 5)):
        cfg = zs_cfg(fft, tpu_precision=prec)
        p = torch.empty((t, cfg.full_size), device="meta", dtype=dtype)
        for name, keys in kernel_ablate.VARIANTS[1:] + [
                ("3M", ("win", "force3m")), ("4M", ("sqrt", "no3m"))]:
            lib.calls.clear()
            before = counters()
            out = cc.curscan_fused_sublane(p, p, cfg, ablate=keys)
            assert out.shape == (t, fft)
            [(called, args)] = lib.calls
            assert called == entry and prod.calls == []
            after = counters()
            assert after[moves] == before[moves] + 1
            assert [x for i, x in enumerate(after) if i != moves] == [
                x for i, x in enumerate(before) if i != moves]
            assert args[-2] == cc.ablate_mask(keys)
            assert args[-3] == int("force3m" in keys)
            assert args[-4] == cuda_tc.PREC_CODE[prec]
            if lib is a:
                groups = cuda_tc.tc_groups(t, fft // 128, cfg.num_windows,
                                           132, 1)
                assert args[16] == groups
            else:
                assert args[14:16] == (fft // 128, 128)
                assert args[17] == cuda_tc.tc_split_groups(
                    t, 4, cfg.num_windows, 132, 1)


def test_card_ablate_without_a_stage_key_keeps_the_fft_kernel(fake_card):
    """``no3m`` alone is no ablation: the FFT kernel runs, as before."""
    prod, a, c = fake_card
    cfg = zs_cfg(2048, tpu_precision="DEFAULT")
    p = torch.empty((4, cfg.full_size), device="meta")
    before = cc.launches
    cc.curscan_fused_sublane(p, p, cfg, ablate=("no3m",))
    assert [e for e, _ in prod.calls] == ["kspec_curscan_fft"]
    assert cc.launches == before + 1 and a.calls == [] and c.calls == []


def test_ablate_variants_are_the_two_builds():
    """The two ablate builds: Kernel A's and Kernel C's sources, each with
    its define, registered with the cut-off builds of phase 2."""
    assert cuda_tc.ablate_variants() == [
        (("curscan_tc.cu", "curscan_tc_high.cu"), ("KSPEC_TC_ABLATE=1",)),
        (("curscan_tc_split.cu", "curscan_tc_split_high.cu"),
         ("KSPEC_TCS_ABLATE=1",))]
