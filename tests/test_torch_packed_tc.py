"""Kernel B (``csrc/curscan_packed_tc.cu``, the HIGH/DEFAULT tensor-core
packed curscan) on the CPU: its launch plan (``cuda_tc.packed_tc_plan``,
``packed_tc_spans``, ``packed_tc_smem``, ``packed_tc_grid``) over every
config the packed predicate takes, and a NumPy model of its data flow (the
bf16 operand planes with their one-sample shifted copy, the fragment
addressing at odd and even starts, the table's A fragments, the products
per tile, the per-lane fold and the lanes' combine) held to
``spectrum.frame_signal`` and to the plain version.  The kernel itself runs
only on the card (``tests/test_torch_gpu.py``).

Tolerance of the model against the plain version: ``torch_parity.TC_TOL``
(the card's bound for the kernel), since the model, like the kernel, sums
each product's bf16 terms in another order and folds the windows lane by
lane.
"""
import numpy as np
import pytest
import torch

from kspecanal_tpu_torch.cli import parse_args
from kspecanal_tpu_torch.config import (WINDOW_HANNING, WINDOW_KAISER,
                                        WINDOW_ONES)
from kspecanal_tpu_torch.ops import cuda_packed, cuda_tc
from kspecanal_tpu_torch.ops import spectrum as tspec
from kspecanal_tpu_torch.scripts import packed_tc_stages
from torch_parity import assert_tc_close, decoded, raw_planes, zs_cfg

PACKED_FFTS = (2, 4, 8, 16, 32, 64, 128)
SMEM_LIMIT = 232448         # a block's shared memory on the H100


@pytest.mark.parametrize("fft", PACKED_FFTS)
def test_plan_stages_every_frame_within_shared_memory(fft):
    """Every config the packed predicate takes (fft 2-128 x fft2FullMult
    1-399 x overlap 50/75/90%), both classes and input types: each window's
    frame lies inside its chunk's staged span (16-byte aligned, inside the
    block), the widest span is the staging row, every fragment word a lane
    reads lies inside its operand plane, the float32 staging fits
    ``PACKED_TC_STAGE_BYTES`` and the block's shared memory 232,448 bytes,
    and u8 takes float32's chunk (so its windows fold on the same
    lanes)."""
    kc = cuda_tc.packed_k_tiles(fft)
    taken = 0
    for nono in (0.5, 0.25, 0.1):
        for mult in range(1, 400):
            cfg = zs_cfg(fft, nono, x_res=fft, fft2full_mult4less=mult)
            if not cuda_packed.supports_fused_packed(cfg):
                continue
            taken += 1
            starts = np.asarray(cfg.window_starts)
            w = len(starts)
            for high in (False, True):
                chunks = set()
                for u8 in (False, True):
                    plan = cuda_tc.packed_tc_plan(fft, cfg.window_starts, u8,
                                                  high)
                    chunks.add(plan.chunk)
                    assert plan.chunk == w or plan.chunk % 8 == 0 \
                        or plan.chunk < 8
                    spans = cuda_tc.packed_tc_spans(cfg.window_starts, fft,
                                                    plan.chunk, u8)
                    assert len(spans) == plan.n_chunks == -(-w // plan.chunk)
                    a0, span = spans[np.arange(w) // plan.chunk].T
                    align = 16 if u8 else 4
                    assert (a0 % align == 0).all()
                    assert (span % align == 0).all()
                    assert (a0 <= starts).all()
                    assert (starts + fft <= a0 + span).all()
                    assert (a0 + span <= cfg.full_size).all()
                    assert spans[:, 1].max() == plan.stride
                    last_word = (starts - a0) // 2 + 8 * kc - 1
                    assert (last_word < cuda_tc.packed_tc_plane_words(
                        plan.stride)).all()
                    assert plan.smem == cuda_tc.packed_tc_smem(
                        fft, plan.stride, u8, high) <= SMEM_LIMIT
                    staged = plan.smem - cuda_tc.packed_tc_table_bytes(fft,
                                                                       high)
                    assert staged <= cuda_tc.PACKED_TC_STAGE_BYTES, (nono,
                                                                     mult)
                assert len(chunks) == 1, (nono, mult, high)
    assert taken > 0


def test_plan_at_the_main_cells():
    """quickFullScan (fft 64, 90%, 71 windows) stages a block in one span
    of 512 samples; the 951-window block (fft64 x 96) and fft 128 x 81 in
    chunks; only fft 128 at HIGH copies the table (128 KiB) into shared
    memory."""
    qfs = zs_cfg(64, 0.1, window=WINDOW_ONES, x_res=64)
    for u8, high, smem in ((False, False, 13056), (True, False, 6912),
                           (False, True, 17920), (True, True, 11776)):
        assert cuda_tc.packed_tc_plan(64, qfs.window_starts, u8, high) == (
            cuda_tc.PackedTcPlan(71, 1, 512, smem))
    big = zs_cfg(64, 0.1, x_res=64, fft2full_mult4less=96)
    assert cuda_tc.packed_tc_plan(64, big.window_starts, False,
                                  False)[:2] == (304, 4)
    c2 = zs_cfg(128, 0.5, x_res=128, fft2full_mult4less=81)
    assert cuda_tc.packed_tc_plan(128, c2.window_starts, False,
                                  True)[:2] == (16, 11)
    assert [cuda_tc.packed_tc_hold(n, high) for n in (64, 128)
            for high in (False, True)] == [True, True, True, False]
    assert cuda_tc.packed_tc_table_bytes(128, True) == 128 << 10


@pytest.mark.parametrize("t,per_sm", [(1, 7), (7, 7), (1226, 7),
                                      (1227, 4), (19616, 7), (19617, 4)])
def test_grid_takes_every_block_once(t, per_sm):
    """The persistent grid: one thread block an IQ block up to the card's
    resident blocks, then that many; block i walks IQ blocks i, i + grid,
    ..., so each is taken exactly once."""
    grid = cuda_tc.packed_tc_grid(t, 132, per_sm)
    assert grid == min(t, 132 * per_sm)
    taken = np.concatenate([np.arange(i, t, grid) for i in range(grid)])
    np.testing.assert_array_equal(np.sort(taken), np.arange(t))


def test_stage_cells_are_quick_full_scan():
    """The stage script's cells take quickFullScan's curscan geometry."""
    qfs = parse_args(["quickFullScan"])[0]
    cell = packed_tc_stages.cell_cfg("DEFAULT")
    for key in ("fft_size", "full_size", "window_starts", "window",
                "cur_scan_cumu_mode"):
        assert getattr(cell, key) == getattr(qfs, key), key
    assert sum(s % 2 for s in cell.window_starts) == 28


# --- A NumPy model of the kernel --------------------------------------------

def bf16_value(bits):
    """float32 values of bf16 bit patterns (uint16)."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def model_planes(x, high):
    """The conversion pass on a staged span ``x`` (decoded float32, zero
    past the span): per half (hi; HIGH lo), the word-aligned plane P0
    (x[2m], x[2m+1]) and its copy P1 shifted by one sample (x[2m+1],
    x[2m+2]), as uint32 words (first sample in the low half)."""
    pairs = []
    for half in cuda_tc.bf16_halves(x)[:2 if high else 1]:
        h = half.astype(np.uint32)
        m = (len(h) - 2) // 2
        pairs.append((h[0:2 * m:2] | h[1:2 * m:2] << 16,
                      h[1:2 * m + 1:2] | h[2:2 * m + 2:2] << 16))
    return pairs


def frame_fragments(planes, e0, kc_tiles):
    """The B-fragment values lane (g, t) loads for the window at span
    offset ``e0``: k-chunk kc's words (e0 >> 1) + 8 kc + t and + 4 of plane
    P(e0 & 1), unpacked into the frame's samples 16 kc + 2t, +1, +8, +9.
    Returns ``(16 kc_tiles,)`` values per half."""
    out = []
    for p0p1 in planes:
        plane = p0p1[e0 & 1]
        vals = np.zeros(16 * kc_tiles, np.float32)
        for kc in range(kc_tiles):
            for t in range(4):
                for b, k in ((0, 2 * t), (4, 2 * t + 8)):
                    word = plane[(e0 >> 1) + 8 * kc + t + b]
                    vals[16 * kc + k] = bf16_value(word & 0xffff)
                    vals[16 * kc + k + 1] = bf16_value(word >> 16)
        out.append(vals)
    return out


def table_tiles(cfg):
    """Dt^T rebuilt from the kernel's A fragments (``packed_tc_tables``):
    ``[slot](16 kc, 16 kc)`` float32, slots Dr hi, Dr lo, Di hi, Di lo."""
    n = cfg.fft_size
    kc = cuda_tc.packed_k_tiles(n)
    dt = cuda_tc.packed_tc_tables(n, cfg.window, cfg.cur_scan_cumu_mode,
                                  cfg.num_windows, torch.device("cpu"))[0]
    frags = dt.numpy().view(np.uint16).reshape(4, kc, kc, 32, 8)
    rows, cols = cuda_tc._frag_a_index()
    out = np.zeros((4, 16 * kc, 16 * kc), np.float32)
    for mt in range(kc):
        for k in range(kc):
            out[:, mt * 16 + rows, k * 16 + cols] = bf16_value(
                frags[:, mt, k])
    return out


def model_kernel(re, im, cfg):
    """Kernel B in NumPy on ``(T, full_size)`` planes: per IQ block and
    chunk the staged span's operand planes, each window's B fragments by
    the kernel's addressing (checked against ``frame_signal``), the 4M
    products (HIGH: hi hi + (hi lo + lo hi)) against the table rebuilt from
    its fragments, |X| and the weights, the fold of lane t's windows 8 nt +
    2t, + 1 in order, then the lanes combined as (t0 t1)(t2 t3)."""
    n, mode = cfg.fft_size, cfg.cur_scan_cumu_mode
    high = cuda_tc.precision_class(cfg) == "HIGH"
    u8 = re.dtype == np.uint8
    kc = cuda_tc.packed_k_tiles(n)
    starts = np.asarray(cfg.window_starts)
    plan = cuda_tc.packed_tc_plan(n, cfg.window_starts, u8, high)
    spans = cuda_tc.packed_tc_spans(cfg.window_starts, n, plan.chunk, u8)
    tab = table_tiles(cfg)
    weights = cuda_tc._packed_plain_tables(
        n, cfg.window, mode, len(starts), torch.device("cpu"))[2].numpy()
    fold = {"AVG": np.add, "RAW": np.add, "MAX": np.maximum,
            "MIN": np.minimum}[mode]
    init = {"MAX": -np.inf, "MIN": np.inf}.get(mode, 0.0)
    planes = [decoded(p) if u8 else p for p in (re, im)]
    want_frames = [tspec.frame_signal(torch.from_numpy(p), cfg.window_starts,
                                      n).numpy() for p in planes]
    out = np.zeros((re.shape[0], n), np.float32)
    for b in range(re.shape[0]):
        acc = np.full((4, 16 * kc), init, np.float32)      # [lane t][bin]
        for c, (a0, span) in enumerate(spans):
            w0 = c * plan.chunk
            cw = min(plan.chunk, len(starts) - w0)
            stage = []
            for p in planes:
                words = cuda_tc.packed_tc_plane_words(plan.stride)
                x = np.zeros(2 * words + 2, np.float32)
                x[:span] = p[b, a0:a0 + span]
                stage.append(model_planes(x, high))
            frames = np.zeros((2, 2 if high else 1, cw, 16 * kc), np.float32)
            for j in range(cw):
                e0 = starts[w0 + j] - a0
                for p in range(2):
                    got = frame_fragments(stage[p], e0, kc)
                    frames[p, :, j] = got
                    hi = got[0][:n]
                    want = want_frames[p][b, w0 + j]
                    np.testing.assert_array_equal(
                        hi, bf16_value(cuda_tc.bf16_halves(want)[0]))
            lo = -1 if high else 0

            def prod(m, p):
                big = frames[p, 0] @ tab[2 * m].T
                if not high:
                    return big
                return big + (frames[p, lo] @ tab[2 * m].T
                              + frames[p, 0] @ tab[2 * m + 1].T)
            xr = prod(0, 0) - prod(1, 1)
            xi = prod(0, 1) + prod(1, 0)
            mag = np.sqrt(xr * xr + xi * xi).astype(np.float32)
            if mode in ("AVG", "RAW"):
                mag = (weights[w0:w0 + cw, None] * mag).astype(np.float32)
            for j in range(cw):
                t = (j % 8) // 2
                acc[t] = fold(acc[t], mag[j]).astype(np.float32)
        comb = fold(fold(acc[0], acc[1]), fold(acc[2], acc[3]))
        out[b] = np.fft.fftshift(comb[:n].astype(np.float32))
    return out


MODEL_CASES = [  # (fft, overlap, mult, mode, window, precision, u8, T)
    (64, 0.1, 8, "AVG", WINDOW_ONES, "DEFAULT", False, 3),
    (64, 0.1, 8, "MIN", WINDOW_ONES, "HIGH", True, 2),
    (32, 0.25, 8, "RAW", WINDOW_HANNING, "HIGH", False, 2),
    (8, 0.5, 32, "MAX", WINDOW_KAISER, "DEFAULT", True, 2),
    (2, 0.1, 128, "AVG", WINDOW_ONES, "HIGH", False, 1),
    (128, 0.5, 81, "AVG", WINDOW_KAISER, "HIGH", False, 1),
    (64, 0.1, 96, "MAX", WINDOW_ONES, "DEFAULT", True, 1),
]


@pytest.mark.parametrize("fft,nono,mult,mode,window,prec,u8,t", MODEL_CASES)
def test_kernel_model_matches_plain(fft, nono, mult, mode, window, prec, u8,
                                    t):
    """The model's frames equal ``frame_signal``'s rounded to bf16 at every
    start (quickFullScan: 28 odd of 71; fft 2 at 90%: repeated starts;
    chunked blocks: fft 128 x 81 in 11 spans, fft 64 x 96 in 4), and its
    spectra match the plain version within ``TC_TOL``."""
    cfg = zs_cfg(fft, nono, mode, window=window, tpu_precision=prec,
                 x_res=fft, fft2full_mult4less=mult)
    re, im = raw_planes(cfg, t, seed=fft + mult)
    if not u8:
        re, im = decoded(re), decoded(im)
    got = model_kernel(re, im, cfg)
    want = cuda_tc.curscan_packed_tc_plain(torch.from_numpy(re),
                                           torch.from_numpy(im), cfg).numpy()
    assert_tc_close(got, want, prec)
    if u8:
        np.testing.assert_array_equal(
            got, model_kernel(decoded(re), decoded(im), cfg))
