"""The display fold kernel (``csrc/display_fold.cu``) on the CPU: a plain
PyTorch model of its chunked algorithm against the port's plain chain
(``cuda_display.display_fold_plain``) and against the JAX package's
``display_updates``; its launch plan; the routing rule; the wrapper's
arguments with a stand-in library; the route counts.  The kernel itself
runs on the card only (``test_torch_gpu.py``).

The model does what the kernel does, in its order: launch 1 splits the K
rows into chunks (``cuda_display.plan``, or a count given here) and each
chunk into 8 warps' contiguous sub-ranges, each warp folding max, min
(NaN wins), a -inf flag and a float64 Horner sum h = h/2 + d; the warps
combine in warp order, the chunks in chunk order with exact power-of-two
scales; the ring rows are recomputed from the spectra.

Tolerances: max, min, cur and the RAW, MAX and MIN heatmaps equal the plain
chain bit for bit (the same float32 dB values; extrema do not round).  The
average is the plain chain's within 1e-3 dB and no farther from the float64
fold than the plain chain's float32 weighted sum (plus one float32 step of
the value).  An AVG heatmap row sums its columns in float32 in another
order than ``torch.mean``: within cols * 2^-23 of its largest magnitude.
Against JAX: ``assert_db_close`` (1e-3 dB)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kspecanal_tpu.models import zerospan as jzs
from kspecanal_tpu_torch.config import HEATMAP_ROWS
from kspecanal_tpu_torch.models import zerospan as tzs
from kspecanal_tpu_torch.models.convert import state_to_numpy
from kspecanal_tpu_torch.ops import cuda_display, dsp
from kspecanal_tpu_torch.utils import profiling
from torch_parity import assert_db_close, zs_cfg

WARPS = 8
INTS = ("hm_index", "iteration", "seeded")


def warp_ranges(a, b):
    """The kernel's split of rows [a, b) over a block's 8 warps."""
    return [(a + w * (b - a) // WARPS, a + (w + 1) * (b - a) // WARPS)
            for w in range(WARPS)]


def chunk_model(state, spec, cfg, adj=None, chunks=None, sms=132):
    """The kernel's algorithm in plain PyTorch on the CPU; returns the new
    state.  ``chunks`` overrides the plan's chunk count."""
    k, f = spec.shape
    d = dsp.fftvals_dispproc(spec.to(torch.float32), cfg.zero_span_disp_proc,
                             gain=cfg.gain)
    if chunks is None:
        rows = cuda_display.plan(k, f, sms).rows
    else:
        rows = -(-k // chunks)
    ninf = torch.tensor(float("-inf"), dtype=torch.float64)
    pmax, pmin, psum, ends = [], [], [], []
    for a in range(0, k, rows):
        b = min(k, a + rows)
        wmax, wmin, wsum = [], [], []
        for wa, wb in warp_ranges(a, b):
            blk = d[wa:wb]
            if wb == wa:
                wmax.append(torch.full((f,), float("-inf")))
                wmin.append(torch.full((f,), float("inf")))
                wsum.append(torch.zeros(f, dtype=torch.float64))
                continue
            wmax.append(blk.amax(dim=0))
            wmin.append(blk.amin(dim=0))
            h = torch.zeros(f, dtype=torch.float64)
            for row in blk:
                h = h * 0.5 + row.double()
            neg = torch.isneginf(blk).any(dim=0)
            wsum.append(torch.where(neg, ninf, ldexp(h, wb - b)))
        m, q, s = wmax[0], wmin[0], wsum[0]
        for w in range(1, WARPS):
            m, q = torch.maximum(m, wmax[w]), torch.minimum(q, wmin[w])
            s = keep_neg_add(s, wsum[w])
        pmax.append(m)
        pmin.append(q)
        psum.append(s)
        ends.append(b)
    seeded = int(state.seeded)
    out = {}
    m, q = pmax[0], pmin[0]
    for y in range(1, len(pmax)):
        m, q = torch.maximum(m, pmax[y]), torch.minimum(q, pmin[y])
    out["fft_max"] = (torch.maximum(state.fft_max, m) if seeded & 1 else m
                      ) if cfg.b_data_max else state.fft_max
    out["fft_min"] = (torch.minimum(state.fft_min, q) if seeded & 2 else q
                      ) if cfg.b_data_min else state.fft_min
    s = torch.zeros(f, dtype=torch.float64)
    for part, b in zip(psum, ends):
        s = keep_neg_add(s, ldexp(part, b - k - 1))
    prev = state.fft_avg if seeded & 4 else d[0]
    avg = keep_neg_add(ldexp(prev.double(), -k), s)
    out["fft_avg"] = avg.float() if cfg.b_data_avg else state.fft_avg
    out["fft_cur"] = d[-1]
    out["heatmap"] = ring_model(state, d, cfg, adj)
    hm = int(state.hm_index)
    out["hm_index"] = torch.tensor((hm + k) % HEATMAP_ROWS, dtype=torch.int32)
    out["iteration"] = state.iteration + k
    out["seeded"] = torch.tensor(seeded | cuda_display.seeded_bits(cfg),
                                 dtype=torch.int32)
    return type(state)(**out)


def ldexp(x, n):
    """x * 2^n for float64 ``x``: infinities and NaN kept (a scale that
    underflows to 0 gives 0, not NaN, as ldexp does)."""
    return torch.where(torch.isinf(x), x, x * 2.0 ** n)


def keep_neg_add(s, x):
    neg = torch.isneginf(s) | torch.isneginf(x)
    return torch.where(neg, torch.tensor(float("-inf"), dtype=s.dtype), s + x)


def ring_model(state, d, cfg, adj):
    """Launch 2's ring rows: ring row r holds spec row k - kw + j where
    (r - hm - (k - kw)) mod 128 = j < kw, else its old row."""
    k, f = d.shape
    kw = min(k, HEATMAP_ROWS)
    hm, skip = int(state.hm_index), cfg.tpu_edge_skip_bins
    heat = state.heatmap.clone()
    for r in range(HEATMAP_ROWS):
        j = (r - hm - (k - kw)) % HEATMAP_ROWS
        if j >= kw:
            continue
        row = d[k - kw + j]
        if adj is not None:
            row = row - adj
        if skip > 0:
            inner = row[skip:f - skip].amin()
            row = row.clone()
            row[:skip] = inner
            row[f - skip:] = inner
        mode = cfg.plt_compress_hm
        cols = 0 if mode == "RAW" else f // cfg.x_res
        if cols == 0:
            heat[r] = row
            continue
        g = row[:cfg.x_res * cols].reshape(cfg.x_res, cols)
        if mode == "MAX":
            heat[r] = g.amax(dim=1)
        elif mode == "MIN":
            heat[r] = g.amin(dim=1)
        else:
            acc = g[:, 0].clone()
            for c in range(1, cols):
                acc = acc + g[:, c]
            heat[r] = acc * torch.tensor(1.0 / cols, dtype=torch.float32)
    return heat


def fold64(state, spec, cfg):
    """The serial fold (old + new)/2 of the average in float64."""
    d = dsp.fftvals_dispproc(spec.to(torch.float32), cfg.zero_span_disp_proc,
                             gain=cfg.gain).double()
    acc = state.fft_avg.double() if int(state.seeded) & 4 else d[0]
    for row in d:
        acc = (acc + row) / 2
    return acc


def make_state(cfg, seeded, hm, rng):
    st = tzs.init_state(cfg, "cpu")
    f = cfg.fft_size

    def curve(mu):
        return torch.from_numpy(rng.normal(mu, 4, f).astype(np.float32))
    return st._replace(
        fft_max=curve(-20), fft_min=curve(-70), fft_avg=curve(-45),
        heatmap=torch.from_numpy(rng.normal(-50, 4, st.heatmap.shape)
                                 .astype(np.float32)),
        hm_index=torch.tensor(hm, dtype=torch.int32),
        iteration=torch.tensor(1000, dtype=torch.int32),
        seeded=torch.tensor(seeded, dtype=torch.int32))


def spectra(k, f, rng, zeros=()):
    spec = torch.from_numpy(rng.uniform(1e-6, 1.0, (k, f)).astype(np.float32))
    for i, c in zeros:
        spec[i % k, c % f] = 0.0
    return spec


def assert_avg_rows_close(got, want, cols):
    """AVG heatmap rows: the same infinities; elsewhere within cols *
    2^-23 of the largest finite magnitude."""
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got[torch.isinf(got)], want[torch.isinf(want)])
    fin = torch.isfinite(want)
    tol = cols * 2.0 ** -23 * float(want[fin].abs().max())
    assert float((got[fin] - want[fin]).abs().max()) <= tol


def assert_like_plain(got, want, state, spec, cfg):
    for key in INTS:
        assert int(getattr(got, key)) == int(getattr(want, key)), key
    for key in ("fft_max", "fft_min", "fft_cur"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    if cfg.plt_compress_hm == "AVG":
        assert_avg_rows_close(got.heatmap, want.heatmap,
                              cfg.fft_size // cfg.x_res)
    else:
        assert torch.equal(got.heatmap, want.heatmap)
    g, w = got.fft_avg, want.fft_avg
    assert torch.equal(torch.isneginf(g), torch.isneginf(w))
    fin = torch.isfinite(w)
    np.testing.assert_allclose(g[fin].numpy(), w[fin].numpy(), rtol=0,
                               atol=1e-3)
    if cfg.b_data_avg:
        ref = fold64(state, spec, cfg)[fin]
        step = torch.finfo(torch.float32).eps * ref.abs()
        assert bool(((g[fin].double() - ref).abs()
                     <= (w[fin].double() - ref).abs() + step).all())


# (K, F, chunks, seeded, hm_index, extra config); chunks None: the plan's.
CASES = [
    (1, 64, None, 0, 0, {}),
    (1, 2048, None, 7, 127, {}),
    (7, 64, 3, 7, 5, {"plt_compress_hm": "RAW"}),
    (7, 2048, None, 5, 126, {"tpu_edge_skip_bins": 9}),
    (128, 64, 5, 2, 3, {"plt_compress_hm": "MIN", "x_res": 16}),
    (128, 2048, 16, 0, 64, {"plt_compress_hm": "AVG"}),
    (300, 64, 7, 7, 100, {"tpu_edge_skip_bins": 4, "x_res": 32}),
    (300, 2048, None, 7, 90, {}),
    (300, 16384, None, 3, 0, {"plt_compress_hm": "AVG"}),
    (7, 16384, 2, 6, 125, {"tpu_edge_skip_bins": 100,
                           "zero_span_disp_proc": "Raw.LogNoGain"}),
    (4096, 64, None, 7, 17, {"plt_compress_hm": "MAX"}),
    (4096, 64, 9, 1, 127, {"b_data_min": False, "b_data_avg": False}),
    (4096, 2048, 64, 7, 33, {}),
    (64, 64, 8, 4, 0, {"zero_span_disp_proc": "Raw", "x_res": 64}),
]


@pytest.mark.parametrize("with_adj", [False, True], ids=["plain", "adj"])
@pytest.mark.parametrize("k,f,chunks,seeded,hm,extra", CASES,
                         ids=[f"k{c[0]}-f{c[1]}-c{c[2]}-s{c[3]}-h{c[4]}"
                              for c in CASES])
def test_chunk_model_matches_plain_chain(k, f, chunks, seeded, hm, extra,
                                         with_adj):
    """Chunk counts that divide K and do not, the plan's; seeded none,
    partial and full; -inf bins in early and late rows; the ring wrapping
    and, past 128 rows, rewritten whole; every heatmap mode the kernel
    covers; a baseline; edge skips."""
    rng = np.random.default_rng(k * 7 + f)
    cfg = zs_cfg(f, **extra)
    state = make_state(cfg, seeded, hm, rng)
    spec = spectra(k, f, rng, zeros=((0, 1), (k // 2, 2), (k - 1, 3)))
    adj = (torch.from_numpy(rng.normal(0, 3, f).astype(np.float32))
           if with_adj else None)
    got = chunk_model(state, spec, cfg, adj, chunks)
    want = cuda_display.display_fold_plain(state, spec, cfg, adj)
    assert_like_plain(got, want, state, spec, cfg)


def test_chunk_model_keeps_nan_and_minus_inf():
    """A NaN bin wins max, min and the average; a -inf bin or a -inf seeded
    average wins the average over a NaN, as the plain chain's mask."""
    rng = np.random.default_rng(11)
    cfg = zs_cfg(64)
    state = make_state(cfg, 7, 0, rng)
    state = state._replace(fft_avg=state.fft_avg.index_fill(
        0, torch.tensor([12]), float("-inf")))
    spec = spectra(40, 64, rng, zeros=((3, 10),))
    spec[17, 9] = spec[30, 10] = spec[5, 12] = float("nan")
    got = chunk_model(state, spec, cfg, chunks=6)
    want = cuda_display.display_fold_plain(state, spec, cfg)
    for key in ("fft_max", "fft_min", "fft_avg", "heatmap"):
        g, w = getattr(got, key), getattr(want, key)
        assert torch.equal(torch.isnan(g), torch.isnan(w)), key
        assert torch.equal(torch.isneginf(g), torch.isneginf(w)), key
    assert bool(got.fft_avg[9].isnan()) and got.fft_avg[10] == -np.inf
    assert got.fft_avg[12] == -np.inf


JAX_CASES = [(1, 64, {}), (7, 2048, {"tpu_edge_skip_bins": 8}),
             (300, 2048, {"plt_compress_hm": "AVG"}),
             (4096, 64, {"b_data_min": False})]


@pytest.mark.parametrize("seeded", [0, 7], ids=["first", "seeded"])
@pytest.mark.parametrize("k,f,extra", JAX_CASES,
                         ids=[f"k{c[0]}-f{c[1]}" for c in JAX_CASES])
def test_chunk_model_matches_jax(k, f, extra, seeded):
    rng = np.random.default_rng(k + f + seeded)
    cfg = zs_cfg(f, **extra)
    state = make_state(cfg, seeded, 120, rng)
    spec = spectra(k, f, rng)
    got = state_to_numpy(chunk_model(state, spec, cfg))
    jst = jzs.ZeroSpanState(*(jnp.asarray(v.numpy())
                              for v in state))
    want, _ = jzs.display_updates(jst, jnp.asarray(spec.numpy()), cfg,
                                  with_view=False)
    for key in INTS:
        np.testing.assert_array_equal(got[key], np.asarray(getattr(want,
                                                                    key)))
    for key in ("fft_max", "fft_min", "fft_avg", "fft_cur", "heatmap"):
        assert_db_close(got[key], np.asarray(getattr(want, key)))


@pytest.mark.parametrize("k", [1, 7, 128, 300, 512, 4096, 100000])
@pytest.mark.parametrize("f", [2, 64, 2048, 16384, 131072])
@pytest.mark.parametrize("sms", [132, 4])
def test_plan_fills_the_card_and_leaves_no_chunk_empty(k, f, sms):
    """The chunk count aims at BLOCKS_PER_SM blocks an SM over the column
    tiles, one wave (all K rows where fewer; one chunk where the tiles
    alone fill the card); rounding the rows a chunk up loses at most half
    of it, and no chunk is empty."""
    p = cuda_display.plan(k, f, sms)
    assert p.tiles * cuda_display.TILE >= f > (p.tiles - 1) * cuda_display.TILE
    assert p.chunks * p.rows >= k > (p.chunks - 1) * p.rows
    aim = max(1, min(k, cuda_display.BLOCKS_PER_SM * sms // p.tiles))
    assert aim / 2 < p.chunks <= aim <= 65535
    assert p.chunks == 1 or (p.tiles * p.chunks
                             <= cuda_display.BLOCKS_PER_SM * sms)


def test_plan_of_the_benchmark_cells():
    """zs2048k50: 16 tiles x 24 chunks of 171 rows; zs16384o90: 128 tiles x
    3 chunks of 171 rows (on the H100's 132 SMs: 384 blocks of the 396
    that fit at three an SM)."""
    assert cuda_display.plan(4096, 2048, 132) == (16, 24, 171)
    assert cuda_display.plan(512, 16384, 132) == (128, 3, 171)


ROUTES = [
    ("LogNoGain", "MAX", True), ("LogNoGain", "MIN", True),
    ("LogNoGain", "AVG", True), ("LogNoGain", "RAW", True),
    ("Raw", "MAX", True), ("Raw.LogNoGain", "MAX", True),
    ("LogNoGain.LogNoGain", "AVG", True),
    ("HistLowClip", "MAX", False), ("LogNoGain.HistLowClip", "MAX", False),
    ("LogNoGain", "CONV", False), ("Raw", "CONV", False)]


@pytest.mark.parametrize("disp,hm,kernel", ROUTES,
                         ids=[f"{r[0]}-{r[1]}" for r in ROUTES])
def test_routing_rule(disp, hm, kernel):
    """Which configurations take the kernel on a CUDA tensor: chosen from
    the configuration, never a CPU tensor, whatever the curves, edge skip
    and K."""
    for extra in ({}, {"tpu_edge_skip_bins": 7, "b_data_max": False},
                  {"b_data_min": False, "b_data_avg": False}):
        cfg = zs_cfg(2048, zero_span_disp_proc=disp, plt_compress_hm=hm,
                     **extra)
        assert cuda_display.supports(cfg) is kernel
        assert cuda_display.covers(cfg, torch.device("cuda")) is kernel
        assert cuda_display.covers(cfg, "cuda:0") is kernel
        assert not cuda_display.covers(cfg, torch.device("cpu"))


class StandIn:
    """A stand-in library: records the C entry's arguments."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def kspec_display_fold(self, *args):
        self.calls.append(args)
        return self.err


@pytest.mark.parametrize("mode,code", list(cuda_display.HM_MODES.items()))
def test_launch_arguments(mode, code):
    cfg = zs_cfg(2048, plt_compress_hm=mode, tpu_edge_skip_bins=3,
                 b_data_min=False, zero_span_disp_proc="Raw.LogNoGain")
    rng = np.random.default_rng(1)
    state = make_state(cfg, 3, 9, rng)
    spec = spectra(300, 2048, rng)
    adj = torch.zeros(2048)
    lib = StandIn()
    new = cuda_display.launch(lib, state, spec, cfg, adj, 132, 77)
    (args,) = lib.calls
    width = dsp.heatmap_width(2048, cfg.x_res, mode)
    pl = cuda_display.plan(300, 2048, 132)
    assert args[:5] == (spec.data_ptr(), 300, 2048, 1, cfg.gain)
    assert args[5] == adj.data_ptr()
    assert args[6:11] == (3, code, cfg.x_res, width, 5)
    assert args[11:14] == tuple(x.data_ptr() for x in
                                (state.fft_max, state.fft_min,
                                 state.fft_avg))
    assert args[14:18] == tuple(x.data_ptr() for x in
                                (state.seeded, state.hm_index,
                                 state.iteration, state.heatmap))
    out = new.fft_max.data_ptr()
    n_out = 4 * 2048 + HEATMAP_ROWS * width
    assert args[18:24] == (out, out + 4 * 2048, out + 8 * 2048,
                           out + 12 * 2048, out + 16 * 2048, out + 4 * n_out)
    psum = args[26]
    assert args[24:26] == (psum + pl.chunks * 2048 * 8,
                           psum + pl.chunks * 2048 * 12)
    assert args[27:] == (pl.chunks, pl.rows, 1, 77)
    # Fresh outputs, views of one allocation; the disabled curve is the old.
    assert new.fft_min is state.fft_min
    assert new.fft_avg.data_ptr() == out + 8 * 2048
    assert new.fft_cur.data_ptr() == out + 12 * 2048
    assert new.heatmap.shape == (HEATMAP_ROWS, width)
    assert [x.dtype for x in new[5:]] == [torch.int32] * 3
    assert new.seeded.data_ptr() == out + 4 * n_out + 8


def test_launch_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(2)
    cfg = zs_cfg(256, x_res=256)
    state = make_state(cfg, 0, 0, rng)
    spec = spectra(4, 256, rng)
    with pytest.raises(ValueError, match="does not cover"):
        cuda_display.launch(StandIn(), state, spec,
                            zs_cfg(256, x_res=256,
                                   zero_span_disp_proc="HistLowClip"),
                            None, 132, 0)
    with pytest.raises(ValueError, match="K >= 1"):
        cuda_display.launch(StandIn(), state, spec[:0], cfg, None, 132, 0)
    with pytest.raises(ValueError, match="heatmap"):
        cuda_display.launch(StandIn(), state._replace(
            heatmap=torch.zeros(HEATMAP_ROWS, 8)), spec, cfg, None, 132, 0)
    with pytest.raises(ValueError, match="int32"):
        cuda_display.launch(StandIn(), state._replace(
            seeded=torch.tensor(0)), spec, cfg, None, 132, 0)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        cuda_display.launch(StandIn(err=9), state, spec, cfg, None, 132, 0)
    # Spectra not on 16 bytes, or rows not of whole 16 bytes, take the
    # kernel's scalar loads.
    lib = StandIn()
    odd = torch.ones(4 * 256 + 1)[1:].view(4, 256)
    cuda_display.launch(lib, state, odd, cfg, None, 132, 0)
    assert lib.calls[0][29] == 0
    lib = StandIn()
    cfg254 = zs_cfg(254, x_res=254, plt_compress_hm="RAW")
    cuda_display.launch(lib, make_state(cfg254, 0, 0, rng),
                        spectra(4, 254, rng), cfg254, None, 132, 0)
    assert lib.calls[0][29] == 0


def test_display_updates_counts_its_route():
    """On the CPU every step takes the plain chain: the installed timer
    counts ``display.plain`` and its report says so; the count of plain
    steps on a CUDA tensor stays."""
    cfg = zs_cfg(256, x_res=256)
    rng = np.random.default_rng(3)
    timer = profiling.StageTimer()
    before = tzs.plain_cuda_steps
    st = tzs.init_state(cfg, "cpu")
    with profiling.installed(timer):
        for _ in range(3):
            st, _ = tzs.display_updates(st, spectra(5, 256, rng), cfg,
                                        with_view=False)
    assert timer.count("display.plain") == 3
    assert timer.count("display.fold") == 0
    assert tzs.plain_cuda_steps == before
    assert timer.report().splitlines()[-1] == "display.plain: n=3"
    assert int(st.iteration) == 15
