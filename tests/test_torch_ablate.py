"""Parity of the forensic forms at HIGHEST with the JAX package: K4, the
stage ablation of ``scripts/roofline_r2.py`` (``_kernel_ablate``), and the
``ablate`` keys of ``pallas_curscan.curscan_fused_sublane``, which the port
runs on the six-pass HIGHEST builds of its tensor-core kernels.

On the CPU the port's wrappers run their plain versions (the two-stage DFT
in PyTorch, six bf16 passes a product); the JAX side runs its Pallas
kernels in interpret mode at HIGHEST.  The roofline script is loaded from
its path, and its module global ``pl`` is swapped for one whose
``pallas_call`` interprets; the script itself is unchanged.  Bounds: ``torch_parity.assert_spectra_close``.
The card's tests are in test_torch_gpu.py."""
import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kspecanal_tpu.ops import pallas_curscan as jpk
from kspecanal_tpu_torch.ops import _build, cuda_curscan as cc
from kspecanal_tpu_torch.scripts import fm_ablate, kernel_ablate, \
    perf_followup, perf_probe, perf_r2, probe_membw, qfs_ablate, \
    roofline_r2, session_ablate, session_file_ablate, tc_stages, \
    threemult_smoke
from torch_parity import assert_spectra_close, decoded, raw_planes, zs_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABLATE_KEYS = ("win", "stage1", "twiddle", "stage2", "sqrt", "cumulate",
               "concat")


@functools.lru_cache(maxsize=None)
def roofline_module():
    spec = importlib.util.spec_from_file_location(
        "roofline_r2_jax", os.path.join(REPO, "scripts", "roofline_r2.py"))
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


def planes(cfg, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, cfg.full_size)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("stage", cc.STAGES)
@pytest.mark.parametrize("fft", [512, 2048])
def test_stage_matches_jax_roofline_kernel(roofline, fft, stage):
    cfg = zs_cfg(fft, tpu_precision="HIGHEST")
    re, im = planes(cfg, fft + cc.STAGES.index(stage))
    want = np.asarray(roofline.build(cfg, 1, stage)(jnp.asarray(re),
                                                    jnp.asarray(im)))
    got = cc.curscan_stage_ablate(torch.from_numpy(re), torch.from_numpy(im),
                                  cfg, stage)
    assert got.shape == (2, fft // 128, 128) and got.dtype == torch.float32
    assert_spectra_close(got.numpy(), want)


def test_full_stage_is_the_kernel_under_the_layout_map():
    cfg = zs_cfg(2048)
    re, im = (torch.from_numpy(p) for p in planes(cfg, 3))
    full = cc.curscan_stage_ablate(re, im, cfg, "full")
    spec = cc.stage_layout_to_spectrum(full)
    # the ablate keys' plain version with no stage removed
    np.testing.assert_array_equal(
        spec.numpy(),
        cc.curscan_fused_sublane(re, im, cfg, ablate=("concat",)).numpy())
    assert_spectra_close(spec.numpy(),
                         cc.curscan_fused_sublane_plain(re, im, cfg).numpy())
    # out[b, (k1 + n1*k2 + N/2) % N] = K4[b, k1, k2]
    n1, n = 16, 2048
    assert spec[1, (3 + n1 * 5 + n // 2) % n] == full[1, 3, 5]


@pytest.mark.parametrize("key", ABLATE_KEYS)
@pytest.mark.parametrize("fft", [512, 2048])
def test_ablate_key_matches_jax_kernel(fft, key):
    cfg = zs_cfg(fft, tpu_precision="HIGHEST")
    re, im = planes(cfg, 40 + ABLATE_KEYS.index(key))
    want = np.asarray(jpk.curscan_fused_sublane(
        jnp.asarray(re), jnp.asarray(im), cfg, ablate=(key,)))
    got = cc.curscan_fused_sublane(torch.from_numpy(re), torch.from_numpy(im),
                                   cfg, ablate=(key,))
    assert_spectra_close(got.numpy(), want)


@pytest.mark.parametrize("mode", ["MAX", "MIN", "RAW"])
def test_ablate_keys_under_other_folds_match_jax(mode):
    """sqrt keeps the mode's fold; cumulate sums whatever the mode."""
    cfg = zs_cfg(512, mode=mode, tpu_precision="HIGHEST")
    re, im = planes(cfg, 60)
    for keys in (("sqrt",), ("cumulate",), ("win", "stage1", "twiddle")):
        want = np.asarray(jpk.curscan_fused_sublane(
            jnp.asarray(re), jnp.asarray(im), cfg, ablate=keys))
        got = cc.curscan_fused_sublane(torch.from_numpy(re),
                                       torch.from_numpy(im), cfg, ablate=keys)
        assert_spectra_close(got.numpy(), want)


def test_kernel_ablate_variants_match_jax_on_u8():
    """The ten variants of the ablation script on raw u8 planes, which the
    plain version decodes as the kernel does."""
    cfg = zs_cfg(512, tpu_precision="HIGHEST")
    re, im = raw_planes(cfg, 2, seed=61)
    for _, keys in kernel_ablate.VARIANTS:
        want = np.asarray(jpk.curscan_fused_sublane(
            jnp.asarray(decoded(re)), jnp.asarray(decoded(im)), cfg,
            ablate=keys))
        got = cc.curscan_fused_sublane(torch.from_numpy(re),
                                       torch.from_numpy(im), cfg, ablate=keys)
        assert_spectra_close(got.numpy(), want)


def test_unknown_and_precision_keys_raise():
    """An unknown key raises.  The 3M/4M keys are valid since the HIGH and
    DEFAULT classes exist (tests/test_torch_precision.py): at HIGHEST the
    float64 FFT kernel has no complex-matmul form, so ``no3m`` is its own
    form and returns the HIGHEST result bit for bit, and ``force3m``
    raises ValueError."""
    cfg = zs_cfg(512)
    z = torch.zeros((1, cfg.full_size))
    with pytest.raises(ValueError, match="unknown ablate key"):
        cc.curscan_fused_sublane(z, z, cfg, ablate=("stage3",))
    with pytest.raises(ValueError, match="force3m"):
        cc.curscan_fused_sublane(z, z, cfg, ablate=("force3m",))
    re, im = (torch.from_numpy(decoded(p)) for p in raw_planes(cfg, 2, 62))
    assert torch.equal(cc.curscan_fused_sublane(re, im, cfg, ablate=("no3m",)),
                       cc.curscan_fused_sublane(re, im, cfg))
    with pytest.raises(TypeError):
        cc.curscan_fused_sublane(z, z, cfg, ablate="win")
    assert cc.ablate_mask(()) == cc.ablate_mask(("concat",)) == 0
    assert cc.ablate_mask(("win", "cumulate")) == 1 | 32


def test_stage_ablation_refuses_what_k4_does_not_take():
    cfg = zs_cfg(2048)
    f32 = torch.zeros((1, cfg.full_size))
    u8 = f32.to(torch.uint8)
    with pytest.raises(ValueError, match="unknown stage"):
        cc.curscan_stage_ablate(f32, f32, cfg, "s3")
    with pytest.raises(TypeError):
        cc.curscan_stage_ablate(u8, u8, cfg, "full")
    with pytest.raises(ValueError, match="128-aligned"):
        cc.curscan_stage_ablate(f32, f32, zs_cfg(2048, 0.1), "frame")
    with pytest.raises(ValueError, match="AVG"):
        cc.curscan_stage_ablate(f32, f32, zs_cfg(2048, mode="MAX"), "s1")


def test_forensic_cpu_path_never_builds(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cfg = zs_cfg(512)
    re, im = (torch.from_numpy(p) for p in planes(cfg, 5))
    before = (cc.launches, cc.forensic_launches)
    cc.curscan_stage_ablate(re, im, cfg, "s2")
    cc.curscan_fused_sublane(re, im, cfg, ablate=("sqrt",))
    assert (cc.launches, cc.forensic_launches) == before


def test_read_stage_sums_every_sample_once():
    cfg = zs_cfg(512)
    re = torch.ones((1, cfg.full_size))
    im = 2 * torch.ones((1, cfg.full_size))
    got = cc.curscan_stage_ablate(re, im, cfg, "read")
    slabs = cfg.full_size // cfg.fft_size
    np.testing.assert_array_equal(got.numpy(), np.full((1, 4, 128),
                                                       3.0 * slabs))


@pytest.mark.parametrize("script,argv", [
    (roofline_r2, []), (kernel_ablate, []), (session_ablate, ["2"]),
    (qfs_ablate, ["--bands", "2"]), (threemult_smoke, []),
    (tc_stages, []), (probe_membw, []), (fm_ablate, ["--bands", "2"]),
    (session_file_ablate, ["4", "2"]), (perf_followup, []), (perf_r2, []),
    (perf_probe, []), (roofline_r2, ["--precision", "HIGH"])])
def test_forensics_scripts_need_the_card(monkeypatch, script, argv):
    """A measurement never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main(argv)


def test_qfs_ablate_splits_a_sweep_on_the_cpu(capsys):
    """The port of scripts/qfs_ablate.py at 2 bands on the CPU (the host
    clock): every row of the split, and the session's sweep beside it."""
    rows = qfs_ablate.main(["--bands", "2", "--sweeps", "2", "--device",
                            "cpu"])
    assert list(rows) == ["acquire (host synth)", "upload", "curscans (K2)",
                          "display chain", "stitch", "epilogue",
                          "sweep_step", "run_scan sweep"]
    assert all(np.isfinite(v) and v > 0 for v in rows.values())
    out = capsys.readouterr().out
    assert "2 bands x 512 samples, fft 64, 71 windows a band" in out
    assert "no device time" in out and "final average finite: True" in out


def test_qfs_ablate_parts_are_the_sweep_step():
    """The split's parts, composed, are the session's sweep step: the band
    display after the curscans is band_spectra, the epilogue after the
    gathered curves the gathered stitch."""
    from kspecanal_tpu_torch import session as sess_mod
    from kspecanal_tpu_torch.models import scan as scan_mod
    from kspecanal_tpu_torch.ops.spectrum import curscan_auto_batched
    cfg = qfs_ablate.qfs_config(4)
    plan = sess_mod.make_plan_cached(cfg)
    assert plan.num_bands == 4
    rng = np.random.default_rng(5)
    re, im = (torch.from_numpy(rng.standard_normal(
        (4, cfg.full_size)).astype(np.float32)) for _ in range(2))
    oks = torch.tensor([True, False, True, True])
    state = scan_mod.init_state(cfg, plan, "cpu")
    spectra = scan_mod.band_display(curscan_auto_batched(re, im, cfg), oks,
                                    cfg)
    assert torch.equal(spectra, scan_mod.band_spectra(re, im, oks, cfg))
    tbl = scan_mod._gather_tables(cfg, plan, torch.device("cpu"))
    got = scan_mod._sweeps_epilogue(
        state, scan_mod._gathered_curves(state, spectra[None], cfg, tbl),
        cfg, None)
    want = scan_mod.sweep_step(state, re, im, oks, cfg, plan)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fm_ablate_splits_a_sweep_batch_on_the_cpu(capsys):
    """The port of scripts/fm_ablate.py at 2 bands and 2 sweeps on the CPU
    (the host clock): every row of the split."""
    rows = fm_ablate.main(["--bands", "2", "--sweeps", "2", "--device",
                           "cpu"])
    assert list(rows) == ["curscans (K1)", "curscans + display",
                          "curscans + stitch", "sweep_steps", "stitch alone",
                          "gathers alone"]
    assert all(ms > 0 for ms in rows.values())


def test_session_file_ablate_reconciles_the_stages_on_the_cpu(capsys):
    """The port of scripts/session_file_ablate.py at 16 blocks in batches of
    4 on the CPU: every stage of both threads, and the main thread's stages
    within the wall."""
    out = session_file_ablate.main(["16", "4", "--device", "cpu"])
    assert set(out) == {"wall", *session_file_ablate.MAIN_STAGES,
                        *session_file_ablate.WORKER_STAGES}
    assert 0 < sum(out[s] for s in session_file_ablate.MAIN_STAGES) \
        <= out["wall"]
    assert out["acquire.read"] > 0
    assert "main-thread stages explain" in capsys.readouterr().out


@pytest.mark.parametrize("prec", ["HIGHEST", "DEFAULT"])
def test_roofline_class_refuses_f32_sums(prec):
    """``--f32-sums`` priced the float64 sums of the direct kernel, which
    no longer serves K4: an unknown option at every class, an argument
    error before any card is asked for."""
    with pytest.raises(SystemExit) as e:
        roofline_r2.main(["--precision", prec, "--f32-sums"])
    assert e.value.code == 2
