"""Port parity of zero-span mode (``models/zerospan``) against the JAX package,
both continuing from one mid-session state carried across by
``models/convert``.

Tolerances (``torch_parity``): linear spectra within 1e-5 of their peak;
dB curves and heatmap rows within 1e-3 dB wherever the reference is within
100 dB of its peak (f32 rounding of two FFT libraries); counters and the
seeded bitmask exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.models import zerospan as jzs
from kspecanal_tpu_torch.models import zerospan as tzs
from kspecanal_tpu_torch.ops import dsp as tdsp
from kspecanal_tpu_torch.models.convert import state_from_numpy, \
    state_to_numpy
from torch_parity import assert_db_close, blocks, zs_cfg

CFG = zs_cfg(2048)
INTS = ("hm_index", "iteration", "seeded")


def mid_state(cfg, seed=1):
    """A JAX state after three serial steps, as numpy arrays."""
    st = jzs.init_state(cfg)
    re, im = blocks(cfg, 3, seed)
    for r, i in zip(re, im):
        st, _ = jzs.zero_span_step_jit(st, jnp.asarray(r), jnp.asarray(i), cfg)
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def baseline(cfg):
    return (np.random.default_rng(9).standard_normal(cfg.fft_size) * 3
            - 40).astype(np.float32)


def assert_state_close(got, want):
    got = state_to_numpy(got)
    for k in INTS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)))
    for k in ("fft_max", "fft_min", "fft_avg", "fft_cur", "heatmap"):
        assert_db_close(got[k], np.asarray(getattr(want, k)))


def assert_view_close(got, want):
    np.testing.assert_allclose(got.x_freqs.numpy(), np.asarray(want.x_freqs),
                               rtol=1e-7)
    for k in ("max_lvls", "min_lvls", "avg_lvls", "cur_lvls", "heatmap"):
        assert_db_close(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    spec, ref = got.spectrum.numpy(), np.asarray(want.spectrum)
    np.testing.assert_allclose(spec, ref, rtol=0,
                               atol=1e-5 * np.max(np.abs(ref)))


@pytest.mark.parametrize("with_adj", [False, True], ids=["plain", "adj"])
def test_zero_span_step_matches_jax(with_adj):
    d = mid_state(CFG)
    re, im = blocks(CFG, 7, seed=2)
    adj = baseline(CFG) if with_adj else None
    jst = jzs.ZeroSpanState(*(jnp.asarray(d[k]) for k in jzs.ZeroSpanState._fields))
    tst = state_from_numpy(d, "cpu")
    for r, i in zip(re, im):
        if adj is None:
            jst, jview = jzs.zero_span_step_jit(jst, jnp.asarray(r),
                                                jnp.asarray(i), CFG)
        else:
            jst, jview = jzs.zero_span_step_adj_jit(
                jst, jnp.asarray(r), jnp.asarray(i), jnp.asarray(adj), CFG)
        tst, tview = tzs.zero_span_step(
            tst, torch.from_numpy(r), torch.from_numpy(i), CFG,
            None if adj is None else torch.from_numpy(adj))
    assert int(tst.iteration) == 10
    assert_state_close(tst, jst)
    assert_view_close(tview, jview)


@pytest.mark.parametrize("with_adj", [False, True], ids=["plain", "adj"])
def test_zero_span_steps_matches_jax(with_adj):
    d = mid_state(CFG)
    re, im = blocks(CFG, 5, seed=3)
    jst = jzs.ZeroSpanState(*(jnp.asarray(d[k]) for k in jzs.ZeroSpanState._fields))
    if with_adj:
        adj = baseline(CFG)
        jst, jview = jzs.zero_span_steps_adj_jit(
            jst, jnp.asarray(re), jnp.asarray(im), jnp.asarray(adj), CFG)
        tadj = torch.from_numpy(adj)
    else:
        jst, jview = jzs.zero_span_steps_jit(jst, jnp.asarray(re),
                                             jnp.asarray(im), CFG)
        tadj = None
    tst, tview = tzs.zero_span_steps(state_from_numpy(d, "cpu"),
                                     torch.from_numpy(re),
                                     torch.from_numpy(im), CFG, tadj)
    assert_state_close(tst, jst)
    assert_view_close(tview, jview)
    _, none = tzs.zero_span_steps(state_from_numpy(d, "cpu"),
                                  torch.from_numpy(re), torch.from_numpy(im),
                                  CFG, tadj, with_view=False)
    assert none is None


@pytest.mark.parametrize("entry", ["raw_bytes", "u8_planes"])
def test_zero_span_steps_u8_matches_jax(entry):
    """Raw capture bytes through the JAX u8 entry vs the port's u8 entry,
    and vs its steps on host-split u8 planes (which reach the kernel
    wrapper undecoded)."""
    d = mid_state(CFG)
    raw = np.random.default_rng(4).integers(0, 256, (5, 2 * CFG.full_size),
                                            dtype=np.uint8)
    jst = jzs.ZeroSpanState(*(jnp.asarray(d[k]) for k in jzs.ZeroSpanState._fields))
    jst, jview = jzs.zero_span_steps_u8_jit(jst, jnp.asarray(raw), CFG)
    tst = state_from_numpy(d, "cpu")
    if entry == "raw_bytes":
        tst, tview = tzs.zero_span_steps_u8(tst, torch.from_numpy(raw), CFG)
    else:
        re, im = (torch.from_numpy(np.ascontiguousarray(raw[:, j::2]))
                  for j in (0, 1))
        tst, tview = tzs.zero_span_steps(tst, re, im, CFG)
    assert_state_close(tst, jst)
    assert_view_close(tview, jview)


def test_batched_equals_serial():
    d = mid_state(CFG)
    re, im = (torch.from_numpy(p) for p in blocks(CFG, 5, seed=5))
    ser = state_from_numpy(d, "cpu")
    for r, i in zip(re, im):
        ser, sview = tzs.zero_span_step(ser, r, i, CFG)
    bat, bview = tzs.zero_span_steps(state_from_numpy(d, "cpu"), re, im, CFG)
    got, want = state_to_numpy(bat), state_to_numpy(ser)
    for k in INTS:
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("fft_max", "fft_min", "fft_avg", "fft_cur", "heatmap"):
        assert_db_close(got[k], want[k])
    np.testing.assert_array_equal(bview.spectrum.numpy(),
                                  sview.spectrum.numpy())


@pytest.mark.parametrize("seeded", [False, True], ids=["first", "seeded"])
def test_batched_average_keeps_minus_inf(seeded):
    """An exactly-zero spectrum bin (-inf dB) in an early block of a 1024-
    block batch, whose float32 decay weight underflows to 0: the average
    stays -inf there, as the serial fold (old + new)/2 keeps it, not NaN;
    every other bin keeps the plain weighted sum.  The decay of a -inf
    running average (the stream's chunk continuation) stays -inf too."""
    k = 1024
    rng = np.random.default_rng(6)
    spec = torch.from_numpy(rng.uniform(1e-3, 1.0, (k, CFG.fft_size))
                            .astype(np.float32))
    spec[3, 100] = 0.0
    st = tzs.init_state(CFG, "cpu")
    if seeded:
        st, _ = tzs.display_updates(st, spec[:2], CFG, with_view=False)
    got, _ = tzs.display_updates(st, spec, CFG, with_view=False)
    avg = got.fft_avg.numpy()
    assert avg[100] == -np.inf and np.isfinite(np.delete(avg, 100)).all()
    prev = torch.zeros(CFG.fft_size)
    prev[7] = -np.inf
    dbs = torch.log10(spec[4:6])
    w = torch.tensor([0.25, 0.5])
    out = tdsp.decay_avg(w, dbs, prev, torch.tensor(0.0))
    assert out[7] == -np.inf
    np.testing.assert_array_equal(np.delete(out.numpy(), 7), np.delete(
        torch.einsum("t,tf->f", w, dbs).numpy(), 7))


def test_display_branches_match_jax():
    """Edge-bin skip, a disabled curve and the PSD cross-check, serial and
    batched, from a fresh state (first-copy seeding)."""
    cfg = zs_cfg(2048, tpu_edge_skip_bins=8, b_data_min=False,
                 b_use_psd=True)
    re, im = blocks(cfg, 3, seed=6)
    jst, tst = jzs.init_state(cfg), tzs.init_state(cfg, "cpu")
    for r, i in zip(re[:2], im[:2]):
        jst, jview = jzs.zero_span_step_jit(jst, jnp.asarray(r),
                                            jnp.asarray(i), cfg)
        tst, tview = tzs.zero_span_step(tst, torch.from_numpy(r),
                                        torch.from_numpy(i), cfg)
    assert_state_close(tst, jst)
    assert_view_close(tview, jview)
    jst, jview = jzs.zero_span_steps_jit(jst, jnp.asarray(re),
                                         jnp.asarray(im), cfg)
    tst, tview = tzs.zero_span_steps(tst, torch.from_numpy(re),
                                     torch.from_numpy(im), cfg)
    assert int(tst.seeded) == 5
    assert_state_close(tst, jst)
    assert_view_close(tview, jview)


def test_ring_beyond_its_depth_matches_jax():
    """A batch of 130 > 128 rows writes only the last 128, at their serial
    ring positions."""
    cfg = zs_cfg(256, x_res=256)
    d = {k: np.asarray(v) for k, v in jzs.init_state(cfg)._asdict().items()}
    d["hm_index"] = np.int32(100)
    d["iteration"] = np.int32(100)
    raw = np.random.default_rng(7).integers(0, 256, (2, 130, cfg.full_size),
                                            dtype=np.uint8)
    jst = jzs.ZeroSpanState(*(jnp.asarray(d[k]) for k in jzs.ZeroSpanState._fields))
    fre, fim = (jnp.asarray(r.astype(np.float32) - 127) for r in raw)
    jst, _ = jzs.zero_span_steps_jit(jst, fre, fim, cfg, with_view=False)
    tst, _ = tzs.zero_span_steps(state_from_numpy(d, "cpu"),
                                 torch.from_numpy(raw[0]),
                                 torch.from_numpy(raw[1]), cfg,
                                 with_view=False)
    assert int(tst.hm_index) == (100 + 130) % 128
    assert_state_close(tst, jst)


def test_convert_round_trip():
    d = mid_state(zs_cfg(256, x_res=256))
    st = state_from_numpy(d, "cpu")
    assert st.hm_index.dtype == torch.int32 and st.heatmap.dtype == torch.float32
    back = state_to_numpy(st)
    assert back.keys() == d.keys()
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])
        assert back[k].dtype == d[k].dtype
