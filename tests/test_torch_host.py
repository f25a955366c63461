"""The port's copies of the reference's host tier equal their originals.

The port imports nothing of `jpgenc_tpu`, so it keeps its own copy of every
host module it needs (tables, layout, huffman, config, container, native,
ref, utils.fixtures) and of the helpers it took out of JAX-importing modules
(ops/pack, engine, ops/transform, ops/color, ops/pallas/k1_dct,
ops/pallas/block_pack), and of the colour stage the shared transform runs
before its block products. Each copy is pinned here against the original on
the same inputs: this file is where the two packages meet.
"""
import dataclasses
import json
import multiprocessing
import os
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpgenc_tpu
import jpgenc_tpu_torch
from jpgenc_tpu import engine as jeng
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops import pack as jpack
from jpgenc_tpu.ref.encoder import standard_tables
from jpgenc_tpu_torch import engine as teng
from jpgenc_tpu_torch.ops import pack as tpack

LAYOUTS = [(1080, 1920, "420", 0), (120, 136, "420", 0), (64, 126, "422", 0),
           (48, 62, "444", 0), (120, 120, "420", 3), (100, 64, "gray", 3),
           (2160, 3840, "422", 8)]
ROOT = Path(__file__).resolve().parent.parent


def test_kdct_zz_and_rounding():
    from jpgenc_tpu.ops.transform import _KDCT_ZZ, round_half_away
    from jpgenc_tpu_torch.ops import transform as tt
    np.testing.assert_array_equal(tt._KDCT_ZZ, _KDCT_ZZ)
    x = np.array([0.5, -0.5, 1.5, -1.5, 0.49999997, -0.49999997, 2.4999998,
                  -0.0, 0.0, 445.49994, -1023.5, 7.0], np.float32)
    x = np.concatenate([x, np.random.default_rng(0).normal(0, 50, 4096)
                        .astype(np.float32)])
    np.testing.assert_array_equal(
        tt.round_half_away(torch.from_numpy(x)).numpy(),
        np.asarray(round_half_away(jnp.asarray(x))))


_SUB = {(1, 1): "444", (2, 1): "422", (2, 2): "420"}


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("h,w", [(48, 80), (37, 83)])
def test_mcu_samples_equal_reference_colour_stage(hs, vs, h, w):
    """Steps 1-3 of the shared transform (BT.601, box mean, - 128, blocks in
    scan order) hold the reference's float32 samples bit for bit:
    ops/color.rgb_to_ycbcr -> subsample -> blockify - 128 -> _mcu_group.
    (Where the subsampled width is a power of two XLA's CPU reduction adds
    the box as two row sums instead, one ulp apart on about a tenth of the
    4:2:0 samples; these widths are not, like 1920 and 16384 + 16. The next
    test pins what holds at such widths.)"""
    from jpgenc_tpu.ops import color as jcolor, transform as jtransform
    from jpgenc_tpu.utils.fixtures import synth_frame
    from jpgenc_tpu_torch.ops.cuda.k1_dct import mcu_samples
    img = synth_frame(h, w, seed=31)
    lay = make_layout(h, w, _SUB[hs, vs], 0)
    c0 = lay.comps[0]
    ycc = jcolor.rgb_to_ycbcr(jcolor.pad_replicate(jnp.asarray(img),
                                                   c0.plane_h, c0.plane_w))
    planes = [ycc[..., 0], jcolor.subsample(ycc[..., 1], hs, vs),
              jcolor.subsample(ycc[..., 2], hs, vs)]
    y, cb, cr = (jtransform.blockify(p).reshape(-1, 64) - jnp.float32(128.0)
                 for p in planes)
    ref = np.asarray(jeng._mcu_group(y, cb, cr, lay.mcus_y, lay.mcus_x, hs,
                                     vs))
    ours = mcu_samples(torch.from_numpy(img)[None],
                       teng.get_plan(h, w, _SUB[hs, vs], 75, "cpu").layout)
    assert ours.dtype == torch.float32
    assert tuple(ours.shape) == (1, lay.n_mcus, hs * vs + 2, 64)
    np.testing.assert_array_equal(ours[0].reshape(-1, 64).numpy(), ref)


@pytest.mark.parametrize("h,w,sub,quality", [
    (128, 128, "420", 75), (128, 128, "422", 75), (128, 128, "444", 75),
    (128, 128, "420", 90), (128, 256, "420", 95), (128, 256, "444", 95)])
def test_mcu_samples_at_power_of_two_widths(h, w, sub, quality):
    """The other side of the caveat above, pinned: at a power-of-two
    subsampled width the reference's CPU box sum may associate differently,
    so steps 1-3 are held to what does hold there. Luma and unsubsampled
    chroma equal the reference's samples bit for bit, a subsampled chroma
    sample lies within one ulp of the reference's, and the quantized
    coefficients equal engine.pixels_to_scan's on every coefficient."""
    from jpgenc_tpu.ops import color as jcolor, transform as jtransform
    from jpgenc_tpu.utils.fixtures import synth_frame
    from jpgenc_tpu_torch.ops.cuda.k1_dct import mcu_samples, transform_plain
    img = synth_frame(h, w)
    lay = make_layout(h, w, sub, 0)
    c0 = lay.comps[0]
    hs, vs, nb = c0.hs, c0.vs, c0.hs * c0.vs
    ycc = jcolor.rgb_to_ycbcr(jnp.asarray(img))
    planes = [ycc[..., 0], jcolor.subsample(ycc[..., 1], hs, vs),
              jcolor.subsample(ycc[..., 2], hs, vs)]
    y, cb, cr = (jtransform.blockify(p).reshape(-1, 64) - jnp.float32(128.0)
                 for p in planes)
    ref = np.asarray(jeng._mcu_group(y, cb, cr, lay.mcus_y, lay.mcus_x, hs,
                                     vs)).reshape(lay.n_mcus, nb + 2, 64)
    plan = teng.get_plan(h, w, sub, quality, "cpu")
    x = torch.from_numpy(img)[None]
    ours = mcu_samples(x, plan.layout)[0].numpy()
    np.testing.assert_array_equal(ours[:, :nb], ref[:, :nb])
    if nb == 1:
        np.testing.assert_array_equal(ours, ref)
    # one ulp of the sample before the level shift, whose exponent the
    # reference's box mean was rounded at
    ulp = np.spacing(np.abs(ref[:, nb:]) + np.float32(128.0))
    assert np.all(np.abs(ours[:, nb:] - ref[:, nb:]) <= ulp)
    want = np.asarray(jeng.pixels_to_scan(
        jnp.asarray(img), lay, jeng.qtables_for_quality(quality)[1]))
    got = transform_plain(x, plan.layout, plan.kdct, plan.q)[0].numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (2, 2)])
def test_box_mean_is_the_row_major_sum(hs, vs):
    """box_mean adds the vs x hs samples in row-major order, one rounding per
    add, then scales by the exact 1 / (hs*vs): equal to that sum written out
    in numpy float32 and to the reference's subsample, bit for bit, on
    samples whose sums do round (BT.601 outputs are not integers)."""
    from jpgenc_tpu.ops.color import subsample
    from jpgenc_tpu_torch.ops.cuda.k1_dct import box_mean
    plane = (np.random.default_rng(5).random((2, 32, 48)) * 255
             ).astype(np.float32)
    out = box_mean(torch.from_numpy(plane), hs, vs).numpy()
    p = plane.reshape(2, 32 // vs, vs, 48 // hs, hs)
    want = None
    for i in range(vs):
        for j in range(hs):
            want = p[:, :, i, :, j] if want is None else \
                want + p[:, :, i, :, j]
    want = want * np.float32(1.0 / (hs * vs))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(out, want)
    for n in range(2):
        np.testing.assert_array_equal(
            out[n], np.asarray(subsample(jnp.asarray(plane[n]), hs, vs)))


def test_packed_tables_and_luts_equal_reference():
    from jpgenc_tpu.ops.pallas.block_pack import packed_tables as ref_pt
    from jpgenc_tpu_torch.ops.cuda.block_pack import packed_tables
    dc_t, ac_t = standard_tables()
    jl = jeng.luts_from_tables(dc_t, ac_t)
    tl = teng.luts_from_tables(dc_t, ac_t)
    np.testing.assert_array_equal(tl.dc, np.asarray(jl.dc))
    np.testing.assert_array_equal(tl.ac, np.asarray(jl.ac))
    one = teng.luts_from_tables(dc_t[:1], ac_t[:1])       # one table set
    np.testing.assert_array_equal(one.ac,
                                  np.asarray(jeng.luts_from_tables(
                                      dc_t[:1], ac_t[:1]).ac))
    ours = packed_tables(tl)
    theirs = ref_pt(jl)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).reshape(-1)
                                      if a.dim() == 1 else np.asarray(b))


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 81, 90, 91, 95, 96, 100])
def test_quality_helpers(quality):
    np.testing.assert_array_equal(teng.qtables_for_quality(quality),
                                  jeng.qtables_for_quality(quality)[0])
    assert tpack.w_blk_for_quality(quality) == jpack.w_blk_for_quality(quality)


def test_pack_constants_and_alignment():
    assert tpack.MAX_BLOCK_BITS == jpack.MAX_BLOCK_BITS
    for spb in (1, 6, 15, 16, 63, 64, 255, 256, 48960):
        assert tpack.walign_for(spb) == jpack.walign_for(spb)
        assert tpack.words_per_segment(spb) == jpack.words_per_segment(spb)
    bits = np.arange(0, 5000, 7, dtype=np.int64)
    for wal in (8, 16, 32, 64):
        np.testing.assert_array_equal(tpack.seg_nwords_aligned(bits, wal),
                                      jpack.seg_nwords_aligned(bits, wal))
        assert tpack.seg_nwords_aligned(12345, wal) == \
            jpack.seg_nwords_aligned(12345, wal)


@pytest.mark.parametrize("h,w,sub,dri", LAYOUTS)
def test_scan_caps_over_layouts_and_tiers(h, w, sub, dri):
    """safe and worst are the reference's; the port's tight tier takes the
    safe tier's stream capacity on purpose (a larger capacity costs it
    device memory only), where the reference's is a quarter of it."""
    lay = make_layout(h, w, sub, dri)
    for q in (10, 75, 85, 92, 93, 100):
        for tier in ("safe", "worst"):
            assert teng.scan_caps(lay, q, tier) == jeng.scan_caps(lay, q, tier)
        assert teng.scan_caps(lay, q, "tight") == jeng.scan_caps(lay, q, "safe")


def test_tiers_follow_the_reference_ladder():
    """api.py:51-55's shape: tight -> safe with max(w, 24) -> worst with
    56, duplicates dropped, with tight at the safe tier's capacity: at Q100
    w is 24 already, so tight and safe merge."""
    lay = make_layout(120, 136, "420", 0)
    for q in (50, 75, 90, 95, 100):
        w = jpack.w_blk_for_quality(q)
        safe = jeng.scan_caps(lay, q, "safe")[0]
        ref = [(safe, w), (safe, max(w, 24)),
               (jeng.scan_caps(lay, q, "worst")[0], 56)]
        ref = [t for i, t in enumerate(ref) if t not in ref[:i]]
        assert teng.tiers_for(lay, q) == ref
        assert len(ref) == (2 if q == 100 else 3)


@pytest.mark.parametrize("h,w", [(1080, 1920), (2160, 3840)])
def test_tier0_holds_the_benchmark_content(h, w):
    """Tier 0's stream capacity holds the benchmark's photographic content
    at its top level with half again to spare, at 1080p and at 4K, so
    that a photograph is coded once (portbench/configs: content.bpp)."""
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "rgb1080p_420_q75.json").read_text())
    lay = make_layout(h, w, cfg["subsampling"], 0)
    cap_u, w_blk = teng.tiers_for(lay, cfg["quality"])[0]
    assert w_blk == jpack.w_blk_for_quality(cfg["quality"])
    assert cap_u >= 1.5 * max(cfg["content"]["bpp"]) * h * w / 8


def test_pad_replicate_equals_reference():
    from jpgenc_tpu.ops.color import pad_replicate as ref
    from jpgenc_tpu_torch.ops.color import pad_replicate
    img = np.random.default_rng(3).integers(0, 256, (13, 21, 3), np.uint8)
    out = pad_replicate(torch.from_numpy(img)[None], 16, 32)[0].numpy()
    np.testing.assert_array_equal(out, np.asarray(ref(jnp.asarray(img), 16,
                                                      32)))


def _stream_case(seed, n_seg, walign, ff=None, nbytes=None):
    """A word-compact stream (each segment from a walign-word boundary, the
    words past its bytes left random) and the segments' bit counts.

    ff None makes every fifth word 0xFFFFFFFF. Otherwise each segment's own
    bytes are drawn free of 0xFF and then: ff = k > 0 makes one byte in k
    0xFF (1: every byte; 0: none); "edges" makes 0xFF the bytes either side
    of 8-, 16- and 32-byte boundaries; "pad" leaves 0xFF only where a
    segment's 1-padding fills its last byte. nbytes: each segment's length
    in bytes (a random bit count below 3000 by default)."""
    rng = np.random.default_rng(seed)
    if nbytes is None:
        nbits = rng.integers(0, 3000, n_seg).astype(np.int32)
    else:
        nbytes = np.asarray(nbytes, np.int64)
        pad = rng.integers(1 if ff == "pad" else 0, 8, n_seg) * (nbytes > 0)
        nbits = (8 * nbytes - pad).astype(np.int32)
    nwa = tpack.seg_nwords_aligned(nbits.astype(np.int64), walign)
    words = rng.integers(0, 2 ** 32, int(nwa.sum()) + 3, dtype=np.uint64)
    if ff is None:
        words[::5] = 0xFFFFFFFF                      # force FF stuffing
        return words.astype(np.uint32).view(np.int32), nbits
    b = words.astype(np.uint32).view(np.uint8)
    starts = 4 * (np.cumsum(nwa) - nwa)
    for s0, bits in zip(starts, nbits):
        n = (int(bits) + 7) >> 3
        seg = rng.integers(0, 255, n).astype(np.uint8)
        if ff == "edges":
            seg[[j for j in (7, 8, 15, 16, 31, 32) if j < n]] = 0xFF
        elif ff == "pad":
            if n:
                seg[-1] = 0xFF ^ ((1 << (8 * n - int(bits))) - 1)
        elif ff:
            seg[rng.random(n) < 1 / ff] = 0xFF
        b[s0:s0 + n] = seg
    return b.view(np.int32), nbits


# (seed, n_seg, walign, ff, nbytes, first_rst, n_rst): 0xFF densities, 0xFF
# either side of a chunk boundary, a last byte made 0xFF by its padding,
# segments of 0-40 bytes (tails short of a chunk), RSTn after only some
# segments (a stripe's sub-image)
_STUFFING = [
    pytest.param((20, 3, 8, 0, [1000, 17, 4000], 2, 2), id="no-ff"),
    pytest.param((21, 2, 64, 256, [40000, 3001], 5, 1), id="ff-1-in-256"),
    pytest.param((22, 4, 16, 16, [5000, 16, 15, 2048], 0, 3),
                 id="ff-1-in-16"),
    pytest.param((23, 3, 1, 1, [3000, 1, 33], 7, 2), id="ff-every-byte"),
    pytest.param((24, 5, 8, "edges", [9, 16, 17, 33, 48], 6, 4),
                 id="ff-at-chunk-edges"),
    pytest.param((25, 40, 1, "pad", list(range(1, 41)), 3, 39),
                 id="ff-from-padding"),
    pytest.param((26, 41, 8, 8, list(range(41)), 1, 40), id="lengths-0-40"),
    pytest.param((27, 6, 16, 64, [700, 0, 90, 31, 32, 2500], 7, 2),
                 id="rst-after-some"),
]


@pytest.mark.parametrize("case", [
    pytest.param((1, 1, 64, None, None, 2, 0), id="1-64"),
    pytest.param((5, 5, 8, None, None, 2, 4), id="5-8"),
    pytest.param((3, 3, 16, None, None, 2, 2), id="3-16"),
    *_STUFFING])
def test_finalize_host_w_equals_reference(case, monkeypatch):
    seed, n_seg, walign, ff, nbytes, first, n_rst = case
    up, nbits = _stream_case(seed, n_seg, walign, ff, nbytes)
    ref = jeng.finalize_host_w(up, nbits, first, n_rst, walign)
    assert teng.finalize_host_w(up, nbits, first, n_rst, walign) == ref
    # the numpy fallback (no C++ library) writes the same bytes
    monkeypatch.setattr(teng.native, "available", lambda: False)
    assert teng.finalize_host_w(up, nbits, first, n_rst, walign) == ref


@pytest.mark.parametrize("case", _STUFFING[:3] + _STUFFING[-2:])
def test_finalize_frames_the_scan_with_head_and_tail(case, monkeypatch):
    """head + scan + tail in one bytes object: from the C++ finalize, whose
    buffer a larger stream grew first, and from the numpy fallback; an
    unframed finalize after a framed one is the bare scan."""
    seed, n_seg, walign, ff, nbytes, first, n_rst = case
    up, nbits = _stream_case(seed, n_seg, walign, ff, nbytes)
    ref = jeng.finalize_host_w(up, nbits, first, n_rst, walign)
    head, tail = bytes(range(7, 207)), b"\xff\xd9"
    big_up, big_nbits = _stream_case(28, 2, 8, 256, [90000, 7000])
    teng.finalize_host_w(big_up, big_nbits, 0, 1, 8, head, tail)
    assert teng.finalize_host_w(up, nbits, first, n_rst, walign, head,
                                tail) == head + ref + tail
    assert teng.finalize_host_w(up, nbits, first, n_rst, walign) == ref
    monkeypatch.setattr(teng.native, "available", lambda: False)
    assert teng.finalize_host_w(up, nbits, first, n_rst, walign, head,
                                tail) == head + ref + tail


_FINALIZE_CASES = [
    pytest.param((1, 1, 64, None, None, 2, 0), id="1-64"),
    pytest.param((5, 5, 8, None, None, 2, 4), id="5-8"),
    pytest.param((3, 3, 16, None, None, 2, 2), id="3-16"),
    *_STUFFING]
_TAIL = b"\xff\xd9"
_ROWS_CASES = {}


def _rows_case(case, n_rows: int):
    """A batch of n_rows rows of one _STUFFING-style case, as
    EncodePlan.fetch returns them, and each row's file from the reference.

    One row is the case itself with its RSTn plan, no head and no tail.
    Otherwise every row has the case's segment count and walign but its own
    seed and lengths (each length scaled by row % 5 / 2: a fifth of the rows
    0 bytes), and over the rows: every fourth skipped (cause "stream" or
    "block"), a head of its own on every third and a shared one on the rest,
    the shared tail, and (first_rst, n_rst, n_seg_keep) stripe plans, some
    keeping fewer segments than the row has."""
    key = (repr(case), n_rows)
    if key not in _ROWS_CASES:
        _ROWS_CASES[key] = _make_rows_case(case, n_rows)
    return _ROWS_CASES[key]


def _make_rows_case(case, n_rows: int):
    seed, n_seg, walign, ff, nbytes, first, n_rst = case
    if n_rows == 1:
        rows = [_stream_case(seed, n_seg, walign, ff, nbytes)]
        causes = [None]
        rst = [(first, n_rst, n_seg)]
        heads, tail = [b""], b""
    else:
        rows, causes, rst, heads = [], [], [], []
        shared = bytes(range(40, 240))
        for r in range(n_rows):
            lens = None if nbytes is None else \
                [b * (r % 5) // 2 for b in nbytes]
            rows.append(_stream_case(seed * 1000 + r, n_seg, walign,
                                     ff if lens is not None else None, lens))
            causes.append(("stream", "block")[r % 2] if r % 4 == 3 else None)
            keep = n_seg - (r % 3 == 1) * (n_seg // 2)
            rst.append((first + r, min(n_rst, keep - 1) if r % 2 else n_rst,
                        keep))
            heads.append(bytes([r % 256]) * (r % 7) if r % 3 == 0
                         else shared)
        tail = _TAIL
    want = [None if cause else heads[i] + jeng.finalize_host_w(
        up, nbits[:rst[i][2]], rst[i][0], rst[i][1], walign) + tail
        for i, ((up, nbits), cause) in enumerate(zip(rows, causes))]
    # the rows as one fetch holds them: each stream in a row of one array,
    # the rest of the row left as it was
    width = max(len(up) for up, _ in rows)
    up2 = np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, (n_rows, width + 3), dtype=np.int64
    ).astype(np.int32)[:, :width]
    for i, (up, _) in enumerate(rows):
        up2[i, :len(up)] = up
    nbits2 = np.stack([nbits for _, nbits in rows])
    return (up2, nbits2, causes, walign, rst, heads, tail), rows, want


@pytest.mark.parametrize("n_threads", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("n_rows", [1, 3, 64])
@pytest.mark.parametrize("case", _FINALIZE_CASES)
def test_finalize_rows_equals_per_row_finalize(case, n_rows, n_threads):
    """The batch finalize (one native call, rows over workers) writes each
    row's file byte for byte as the row-at-a-time finalize_host_w and the
    reference do; a skipped row is None; one row takes one worker."""
    from jpgenc_tpu_torch import native as tn
    args, rows, want = _rows_case(case, n_rows)
    _, _, causes, walign, rst, heads, tail = args
    per_row = [None if cause else teng.finalize_host_w(
        up, nb[:rst[i][2]], rst[i][0], rst[i][1], walign, heads[i], tail)
        for i, ((up, nb), cause) in enumerate(zip(rows, causes))]
    assert per_row == want
    calls, workers = tn.finalize_calls, tn.finalize_workers
    assert tn.finalize_rows(*args, n_threads) == want
    assert tn.finalize_calls == calls + 1
    used = tn.finalize_workers - workers
    if n_threads:
        assert used == min(n_threads, n_rows)
    else:
        assert used == 1 if n_rows == 1 else 1 <= used <= os.cpu_count()


@pytest.mark.parametrize("n_rows,row_bytes", [
    (1, 3 << 20), (8, 100_000), (12, 400_000), (40, 300_000)])
def test_finalize_rows_sizes_its_workers_from_the_bytes(n_rows, row_bytes):
    """Given no count, the batch finalize takes about one worker a MiB of
    scan bytes, capped by the rows and the cores: one row however long, and
    a batch under a MiB, stay on the calling thread; larger batches split
    over several workers and give the reference's files."""
    from jpgenc_tpu_torch import native as tn
    rows = [_stream_case(60 + r, 2, 8, 0, [row_bytes // 2] * 2)
            for r in range(n_rows)]
    up = np.zeros((n_rows, max(len(u) for u, _ in rows)), np.int32)
    for i, (u, _) in enumerate(rows):
        up[i, :len(u)] = u
    nbits = np.stack([nb for _, nb in rows])
    want = [jeng.finalize_host_w(u, nb, 0, 1, 8) for u, nb in rows]
    workers = tn.finalize_workers
    assert tn.finalize_rows(up, nbits, [None] * n_rows, 8) == want
    assert tn.finalize_workers - workers == min(
        n_rows, os.cpu_count(), n_rows * row_bytes // (1 << 20) + 1)


@pytest.mark.parametrize("case", _FINALIZE_CASES)
def test_finalize_rows_without_sse2(case, monkeypatch):
    """The codec built without SSE2 stuffs every byte alone: the batch
    finalize's files are the same."""
    from jpgenc_tpu_torch import native as tn
    args, _, want = _rows_case(case, 64)
    monkeypatch.setattr(tn, "GXX_FLAGS", [*tn.GXX_FLAGS, "-U__SSE2__"])
    monkeypatch.setattr(tn, "LIB", None)
    assert tn.available()
    assert tn.finalize_rows(*args, 3) == want


def test_finalize_rows_defaults_and_refusals():
    """No rst: each row a whole image (RSTn after all but the last
    segment); no heads: bare scans; no rows: no files; rows that are not
    contiguous are read all the same. A row whose bit counts need more
    words than its stream holds, or that keeps more segments than it has,
    is refused before any is written."""
    from jpgenc_tpu_torch import native as tn
    rows = [_stream_case(40 + r, 4, 8) for r in range(5)]
    need = max(int(tpack.seg_nwords_aligned(nb.astype(np.int64), 8).sum())
               for _, nb in rows)
    up = np.zeros((5, max(len(u) for u, _ in rows)), np.int32)
    for i, (u, _) in enumerate(rows):
        up[i, :len(u)] = u
    nbits = np.stack([nb for _, nb in rows])
    want = [jeng.finalize_host_w(u, nb, 0, 3, 8) for u, nb in rows]
    assert tn.finalize_rows(up, nbits, [None] * 5, 8) == want
    assert tn.finalize_rows(np.asfortranarray(up), nbits, [None] * 5,
                            8) == want
    assert tn.finalize_rows(up[:0], nbits[:0], [], 8) == []
    with pytest.raises(ValueError):
        tn.finalize_rows(up[:, :need - 1], nbits, [None] * 5, 8)
    with pytest.raises(ValueError):
        tn.finalize_rows(up, nbits, [None] * 5, 8, [(0, 3, 5)] * 5)


def test_finalize_rows_from_many_threads():
    """Sixteen threads finalize at once (more than the cores), each batch
    over up to three workers: the pool serves one call at a time and the
    others run on their own thread, every file is right, and every call
    and worker is counted."""
    from jpgenc_tpu_torch import native as tn
    args, _, want = _rows_case(_FINALIZE_CASES[-1].values[0], 64)
    n_threads, n_iter = 16, 10
    start = threading.Barrier(n_threads)
    errors = []

    def worker():
        try:
            start.wait(timeout=30)
            for _ in range(n_iter):
                assert tn.finalize_rows(*args, 3) == want
        except Exception as exc:      # noqa: BLE001  (reported below)
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        calls, workers = tn.finalize_calls, tn.finalize_workers
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads) and not errors
    finally:
        sys.setswitchinterval(old)
    assert tn.finalize_calls == calls + n_threads * n_iter
    assert n_threads * n_iter <= tn.finalize_workers - workers \
        <= 3 * n_threads * n_iter


def _finalize_in_child(args, conn):
    from jpgenc_tpu_torch import native as tn
    conn.send(tn.finalize_rows(*args, 3))


@pytest.mark.filterwarnings(
    "ignore:This process .* is multi-threaded:DeprecationWarning")
@pytest.mark.filterwarnings("ignore:os.fork.. was called:RuntimeWarning")
def test_finalize_rows_after_fork():
    """A process forked after the pool's workers started has none of them:
    its first threaded finalize makes its own and gives the same files."""
    from jpgenc_tpu_torch import native as tn
    args, _, want = _rows_case(_FINALIZE_CASES[-1].values[0], 64)
    assert tn.finalize_rows(*args, 3) == want
    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=_finalize_in_child, args=(args, send),
                        daemon=True)
    child.start()
    try:
        got = recv.recv() if recv.poll(60) else "no answer in 60 s"
        child.join(timeout=60)
        assert not child.is_alive() and child.exitcode == 0
    finally:
        if child.is_alive():
            child.kill()
            child.join(timeout=10)
    assert got == want


def test_fetch_split_equals_reference():
    wstream = torch.arange(2 * 40, dtype=torch.int32).reshape(2, 40)
    nbits = torch.tensor([[77], [1200]], dtype=torch.int32)
    ovf = torch.tensor([False, True])
    handle, k = teng.combined_fetch(wstream, nbits, ovf, 16)
    arr = handle.wait()
    assert k == 16 and arr.shape == (2, 16 + 1 + 1)
    ours = teng.split_fetch(arr, k, 1)
    theirs = jeng.split_fetch(arr, k, 1)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[0], wstream[:, :16].numpy())
    np.testing.assert_array_equal(ours[2], [False, True])


def test_tables_from_reference_carries_the_reference_tables():
    qt_host, _ = jeng.qtables_for_quality(75)
    jl = jeng.luts_from_tables(*standard_tables())
    t = teng.tables_from_reference(qt_host, np.asarray(jl.dc),
                                   np.asarray(jl.ac))
    from jpgenc_tpu import tables as T
    np.testing.assert_array_equal(
        t["qzz"].numpy(), qt_host.astype(np.float32)[:, np.asarray(T.ZIGZAG)])
    np.testing.assert_array_equal(t["ac_rows"].numpy().reshape(2, 256),
                                  np.asarray(jl.ac))
    assert t["misc"].tolist() == [int(jl.ac[0, 0xF0]), int(jl.ac[1, 0xF0]),
                                  int(jl.ac[0, 0]), int(jl.ac[1, 0])]


def test_wcompact_single_segment_is_a_bswapped_prefix():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2 ** 32, (2, 1, 50), dtype=np.uint64) \
        .astype(np.uint32)
    bits = np.array([[1500], [40]], np.int32)
    for cap in (32, 64):
        out, nb = tpack.wcompact_unstuffed(
            torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
            cap, 8)
        for b in range(2):
            ref, rnb = jpack.wcompact_unstuffed(jnp.asarray(words[b]),
                                                jnp.asarray(bits[b]), cap, 8)
            np.testing.assert_array_equal(out[b].numpy().view(np.uint32),
                                          np.asarray(ref))
            np.testing.assert_array_equal(nb[b].numpy(), np.asarray(rnb))
    # three segments: starts aligned to the 8-word chunk, words past each
    # segment's content zero
    words3 = rng.integers(0, 2 ** 32, (1, 3, 20), dtype=np.uint64) \
        .astype(np.uint32)
    bits3 = np.array([[70, 300, 33]], np.int32)
    out, nb = tpack.wcompact_unstuffed(
        torch.from_numpy(words3.view(np.int32)), torch.from_numpy(bits3), 40,
        8)
    ref, rnb = jpack.wcompact_unstuffed(jnp.asarray(words3[0]),
                                        jnp.asarray(bits3[0]), 40, 8)
    np.testing.assert_array_equal(out[0].numpy().view(np.uint32),
                                  np.asarray(ref))
    np.testing.assert_array_equal(nb[0].numpy(), np.asarray(rnb))


# --- the copied host modules --------------------------------------------------

def test_tables_module_equals_reference():
    from jpgenc_tpu import tables as jt
    from jpgenc_tpu_torch import tables as tt
    names = [n for n in dir(jt) if n.isupper()]
    assert len(names) >= 12 and names == [n for n in dir(tt) if n.isupper()]
    for n in names:
        np.testing.assert_array_equal(getattr(tt, n), getattr(jt, n), n)
    for q in (1, 25, 50, 75, 90, 100):
        for base in (jt.QTABLE_LUMA, jt.QTABLE_CHROMA):
            np.testing.assert_array_equal(tt.scale_qtable(base, q),
                                          jt.scale_qtable(base, q))


@pytest.mark.parametrize("h,w,sub,dri", LAYOUTS)
def test_layout_module_equals_reference(h, w, sub, dri):
    from jpgenc_tpu_torch.layout import make_layout as port_layout
    ours, ref = port_layout(h, w, sub, dri), make_layout(h, w, sub, dri)
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "comps":
            assert [dataclasses.astuple(c) for c in a] == \
                [dataclasses.astuple(c) for c in b]
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, f.name)
        else:
            assert a == b, f.name
    for prop in ("n_mcus", "n_scan", "n_segments", "blocks_per_segment",
                 "comp_offsets", "is_gray"):
        assert getattr(ours, prop) == getattr(ref, prop)


def _freqs():
    rng = np.random.default_rng(8)
    out = [rng.integers(0, 5000, 256), np.r_[np.ones(12, int), np.zeros(244, int)]]
    skew = np.zeros(256, np.int64)
    skew[:40] = 2 ** np.arange(40) % 100003 + 1       # forces length limiting
    return out + [skew, (rng.random(256) < 0.1) * rng.integers(1, 9, 256)]


def test_huffman_module_equals_reference():
    from jpgenc_tpu import huffman as jh
    from jpgenc_tpu_torch import huffman as th
    for freq in _freqs():
        ob, ov = th.optimize_tables(freq)
        rb, rv = jh.optimize_tables(freq)
        pb, pv = th._optimize_tables_py(np.asarray(freq, np.int64))
        np.testing.assert_array_equal(ob, rb)
        np.testing.assert_array_equal(ov, rv)
        np.testing.assert_array_equal(pb, rb)
        np.testing.assert_array_equal(pv, rv)
        a, b = th.build_codes(ob, ov), jh.build_codes(rb, rv)
        for f in ("bits", "vals", "code", "length"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    v = np.arange(-1030, 1031)
    np.testing.assert_array_equal(th.magnitude_category(v),
                                  jh.magnitude_category(v))


def test_tables_from_freq_equals_reference_batch_tables():
    from jpgenc_tpu.parallel.mesh import _build_tables_from_freq
    freq = np.stack(_freqs()).reshape(2, 2, 256)
    for n_tabs in (1, 2):
        ours = teng.tables_from_freq(freq, n_tabs)
        ref = _build_tables_from_freq(freq, n_tabs)
        for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
            np.testing.assert_array_equal(a.code, b.code)
            np.testing.assert_array_equal(a.length, b.length)
        # one optimized set per image, as tables_from_reference carries it
        jl = jeng.luts_from_tables(*ref)
        t = teng.tables_from_reference(
            jeng.qtables_for_quality(75)[0],
            np.stack([np.asarray(jl.dc)] * 3), np.stack([np.asarray(jl.ac)] * 3))
        dev = teng.device_tables([ours[0]] * 3, [ours[1]] * 3, "cpu")
        for name, d in zip(("ac_rows", "dc_rows", "misc"), dev):
            assert d.shape[0] == 3 and torch.equal(t[name], d)


def test_config_equals_reference():
    from jpgenc_tpu.config import EncodeConfig as ref
    from jpgenc_tpu_torch.config import EncodeConfig as ours
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())
    for kw in ({"quality": 0}, {"quality": 101}, {"subsampling": "411"},
               {"restart_interval": -1}, {"dct_method": "fast"}):
        with pytest.raises(ValueError):
            ref(**kw)
        with pytest.raises(ValueError):
            ours(**kw)


def test_mesh_config_equals_reference():
    from jpgenc_tpu.config import MeshConfig as ref
    from jpgenc_tpu_torch.config import MeshConfig as ours
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours(batch=2, stripe=3)) == \
        dataclasses.asdict(ref(batch=2, stripe=3))
    for kw in ({"batch": -1}, {"stripe": 0},
               {"batch_axis": "x", "stripe_axis": "x"}):
        with pytest.raises(ValueError):
            ref(**kw)
        with pytest.raises(ValueError):
            ours(**kw)
    assert hash(ours()) == hash(ours()) and ours.__dataclass_params__.frozen


@pytest.mark.parametrize("h,w,sub,dri", [(48, 62, "444", 0), (120, 120, "420", 3),
                                         (100, 64, "gray", 3)])
def test_container_modules_equal_reference(h, w, sub, dri):
    from jpgenc_tpu.container import jfif as jj, parser as jp
    from jpgenc_tpu_torch.container import jfif as tj, parser as tp
    from jpgenc_tpu_torch.layout import make_layout as port_layout
    dc_t, ac_t = standard_tables()
    n = 1 if sub == "gray" else 2
    qt = list(jeng.qtables_for_quality(60)[0])
    hdr = jj.build_headers(make_layout(h, w, sub, dri), qt, dc_t[:n], ac_t[:n])
    assert tj.build_headers(port_layout(h, w, sub, dri), qt, dc_t[:n],
                            ac_t[:n]) == hdr
    data = hdr + bytes(range(40)) + b"\xff\xd9"
    a, b = tp.parse_jpeg(data), jp.parse_jpeg(data)
    assert (a.height, a.width, a.subsampling, a.restart_interval,
            a.scan_data, a.app0) == (b.height, b.width, b.subsampling,
                                     b.restart_interval, b.scan_data, b.app0)
    assert [dataclasses.astuple(c) for c in a.comps] == \
        [dataclasses.astuple(c) for c in b.comps]
    for i in b.qtables:
        np.testing.assert_array_equal(a.qtables[i], b.qtables[i])
    for ta, tb in ((a.dc_tables, b.dc_tables), (a.ac_tables, b.ac_tables)):
        assert sorted(ta) == sorted(tb)
        for i in tb:
            np.testing.assert_array_equal(ta[i].code, tb[i].code)
            np.testing.assert_array_equal(ta[i].length, tb[i].length)


@pytest.mark.parametrize("sub,dri,optimize", [("420", 0, False), ("422", 3, True),
                                              ("gray", 0, True)])
def test_ref_encoder_and_native_equal_reference(sub, dri, optimize):
    """The numpy reference encoder writes the same file, and the port's own
    C++ library (built into jpgenc_tpu_torch/_build/) decodes and finalizes
    as the reference's does."""
    from jpgenc_tpu import native as jn
    from jpgenc_tpu.config import EncodeConfig as JCfg
    from jpgenc_tpu.ref import encoder as je
    from jpgenc_tpu_torch import native as tn
    from jpgenc_tpu_torch.config import EncodeConfig as TCfg
    from jpgenc_tpu_torch.container.parser import parse_jpeg
    from jpgenc_tpu_torch.layout import make_layout as port_layout
    from jpgenc_tpu_torch.ref import encoder as te
    from jpgenc_tpu_torch.utils.fixtures import synth_frame
    img = synth_frame(40, 56, seed=2)
    mode = sub
    if sub == "gray":
        img, sub = img[..., 0].copy(), "420"
    kw = dict(quality=80, subsampling=sub, restart_interval=dri,
              optimize_huffman=optimize)
    data = je.encode_with_config(img, JCfg(**kw))
    assert te.encode_with_config(img, TCfg(**kw)) == data

    assert tn.available() and jn.available()
    so = tn.library_path()
    assert os.path.dirname(so) == os.path.join(
        os.path.dirname(jpgenc_tpu_torch.__file__), "_build")
    assert os.path.exists(so)
    assert not so.startswith(os.path.dirname(jpgenc_tpu.__file__) + os.sep)
    p = parse_jpeg(data)
    args = ([c.dc_tab for c in p.comps], [c.ac_tab for c in p.comps],
            [p.dc_tables.get(i) for i in range(2)],
            [p.ac_tables.get(i) for i in range(2)])
    ours = tn.decode_scan(p.scan_data, port_layout(40, 56, mode, dri), *args)
    ref = jn.decode_scan(p.scan_data, make_layout(40, 56, mode, dri), *args)
    np.testing.assert_array_equal(ours, ref)
    assert np.abs(ours).sum() > 0


@pytest.mark.parametrize("case", [
    pytest.param((11, 1, 64, None, None, 1, 0), id="1-64"),
    pytest.param((15, 5, 8, None, None, 1, 4), id="5-8"),
    *_STUFFING])
def test_native_finalize_wcompact_equals_reference(case, monkeypatch):
    from jpgenc_tpu import native as jn
    from jpgenc_tpu_torch import native as tn
    seed, n_seg, walign, ff, nbytes, first, n_rst = case
    up, nbits = _stream_case(seed, n_seg, walign, ff, nbytes)
    ref = jn.finalize_wcompact(up, nbits, first, n_rst, walign)
    assert ref is not None
    assert tn.finalize_wcompact(up, nbits, first, n_rst, walign) == ref
    # the codec built without SSE2 stuffs every byte alone: the same bytes
    monkeypatch.setattr(tn, "GXX_FLAGS", [*tn.GXX_FLAGS, "-U__SSE2__"])
    monkeypatch.setattr(tn, "LIB", None)
    assert tn.available()
    assert tn.finalize_wcompact(up, nbits, first, n_rst, walign) == ref


def test_fixtures_and_bitio_equal_reference():
    from jpgenc_tpu.ref import bitio as jb
    from jpgenc_tpu.utils import fixtures as jf
    from jpgenc_tpu_torch.ref import bitio as tb
    from jpgenc_tpu_torch.utils import fixtures as tf
    np.testing.assert_array_equal(tf.synth_frame(33, 47), jf.synth_frame(33, 47))
    np.testing.assert_array_equal(tf.synth_frame(16, 24, channels=1, seed=3),
                                  jf.synth_frame(16, 24, channels=1, seed=3))
    np.testing.assert_array_equal(tf.synth_batch(16, 24, 3),
                                  jf.synth_batch(16, 24, 3))
    raw = np.random.default_rng(6).integers(250, 256, 300).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(tb.stuff_bytes(raw)),
                                  np.asarray(jb.stuff_bytes(raw)))
    wa, wb = tb.BitWriter(), jb.BitWriter()
    for k in range(200):
        wa.put(k * 37 % (1 << (k % 16 + 1)), k % 16 + 1)
        wb.put(k * 37 % (1 << (k % 16 + 1)), k % 16 + 1)
    wa.align()
    wb.align()
    assert wa.getvalue() == wb.getvalue()


# --- the decoder's host tier (jpgenc_tpu_torch/decoder.py, ref/decoder.py,
# utils/metrics.py, utils/lru.py) against its originals -----------------------

def _decoder_modules():
    import jpgenc_tpu.decoder as jd
    from jpgenc_tpu_torch import decoder as td
    return jd, td


def _scan_file(mode, dri, quality=80, seed=3, h=40, w=56, two_level=False):
    """A small file from the reference's numpy encoder, parsed by both
    packages."""
    from jpgenc_tpu.container.parser import parse_jpeg as jparse
    from jpgenc_tpu.ref import encoder as jref
    from jpgenc_tpu_torch.container.parser import parse_jpeg as tparse
    rng = np.random.default_rng(seed)
    if two_level:
        img = (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    else:
        img = np.clip(rng.normal(128, 45, (h, w, 3)), 0, 255).astype(np.uint8)
    if mode == "gray":
        img = img[..., 0].copy()
    data = jref.encode(img, quality, "420" if mode == "gray" else mode,
                       restart_interval=dri)
    return data, jparse(data), tparse(data)


def test_kidct_zz_equals_reference():
    from jpgenc_tpu.ops.transform import _KIDCT_ZZ
    from jpgenc_tpu_torch.ops import transform as tt
    from jpgenc_tpu_torch.ref import decoder as trd
    np.testing.assert_array_equal(tt._KIDCT_ZZ, _KIDCT_ZZ)
    np.testing.assert_array_equal(trd._KIDCT_ZZ, _KIDCT_ZZ)
    assert tt._KIDCT_ZZ.dtype == trd._KIDCT_ZZ.dtype == np.float32


@pytest.mark.parametrize("mode,h,w", [("420", 61, 130), ("422", 47, 58),
                                      ("444", 20, 24), ("gray", 33, 17),
                                      ("411", 32, 96), ("440", 29, 32),
                                      ("410", 48, 64)])
def test_ref_decoder_equals_reference(mode, h, w):
    from jpgenc_tpu.ref import decoder as jrd
    from jpgenc_tpu_torch.layout import make_layout as tmake
    from jpgenc_tpu_torch.ref import decoder as trd
    rng = np.random.default_rng(h * w)
    jl, tl = make_layout(h, w, mode), tmake(h, w, mode)
    n_total = sum(c.n_blocks for c in tl.comps)
    blocks = rng.integers(-200, 200, (n_total, 64)).astype(np.int32)
    qts = [rng.integers(1, 60, 64).astype(np.int32) for _ in tl.comps]
    np.testing.assert_array_equal(trd.reconstruct_ref(tl, blocks, qts),
                                  jrd.reconstruct_ref(jl, blocks, qts))
    by_id = {0: qts[0], 1: qts[-1]}
    np.testing.assert_array_equal(trd.reconstruct_ref(tl, blocks, by_id),
                                  jrd.reconstruct_ref(jl, blocks, by_id))
    a = rng.normal(0, 50, (6, 10))
    for axis in (0, 1):
        np.testing.assert_array_equal(trd.upsample_fancy_ref(a, axis),
                                      jrd.upsample_fancy_ref(a, axis))
        for f in (1, 2, 4):
            np.testing.assert_array_equal(trd._upsample_axis_ref(a, f, axis),
                                          jrd._upsample_axis_ref(a, f, axis))


@pytest.mark.parametrize("mode,dri", [("420", 0), ("422", 3), ("444", 0),
                                      ("gray", 2)])
def test_exact_decode_equals_reference(mode, dri):
    from jpgenc_tpu.ref import decoder as jrd
    from jpgenc_tpu_torch.ref import decoder as trd
    data, _, _ = _scan_file(mode, dri)
    np.testing.assert_array_equal(trd.exact_decode(data),
                                  jrd.exact_decode(data))


def test_metrics_equal_reference():
    from jpgenc_tpu.utils import metrics as jm
    from jpgenc_tpu_torch.utils import metrics as tm
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (20, 30, 3), np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 9, a.shape), 0, 255) \
        .astype(np.uint8)
    assert tm.psnr(a, b) == jm.psnr(a, b)
    assert tm.psnr(a, a) == jm.psnr(a, a) == float("inf")
    assert tm.psnr(a, b, peak=1.0) == jm.psnr(a, b, peak=1.0)
    assert tm.bpp(b"x" * 1234, 20, 30) == jm.bpp(b"x" * 1234, 20, 30)


@pytest.mark.parametrize("h,w,sub,dri", LAYOUTS)
def test_flops_bytes_estimate_equals_reference(h, w, sub, dri):
    from jpgenc_tpu.utils.profiling import flops_bytes_estimate as jfb
    from jpgenc_tpu_torch.layout import make_layout as tmake
    from jpgenc_tpu_torch.utils.profiling import flops_bytes_estimate as tfb
    assert tfb(tmake(h, w, sub, dri)) == jfb(make_layout(h, w, sub, dri))


def test_lru_cache_equals_reference():
    from jpgenc_tpu.utils.lru import LRUCache as J
    from jpgenc_tpu_torch.utils.lru import LRUCache as P
    for cls in (J, P):
        with pytest.raises(ValueError):
            cls(0)
    j, p = J(3), P(3)
    trace = []
    for step, key in enumerate([1, 2, 3, 1, 4, 2, 5, 1, 1, 6, 3]):
        for c in (j, p):
            if step % 3 == 2:
                c.get(key)
            c[key] = step
        trace.append((sorted(k for k in range(8) if k in j),
                      sorted(k for k in range(8) if k in p),
                      len(j), len(p), j.get(key), p.get(key),
                      j.get(99, "miss"), p.get(99, "miss")))
    for jk, pk, jn, pn, jv, pv, jm_, pm in trace:
        assert (jk, jn, jv, jm_) == (pk, pn, pv, pm)
    assert p[6] == j[6]
    with pytest.raises(KeyError):
        p[99]
    p.clear()
    assert len(p) == 0 and 1 not in p


def test_bit_reader_and_symbol_helpers_equal_reference():
    jd, td = _decoder_modules()
    raw = np.random.default_rng(9).integers(0, 256, 64).astype(np.uint8)
    a, b = jd._BitReader(raw), td._BitReader(raw)
    for n in [1, 0, 3, 16, 7, 11, 2, 9] * 6:
        assert a.read_bits(n) == b.read_bits(n)
        assert a.read_bit() == b.read_bit()
        assert a.pos == b.pos
    for rd in (jd._BitReader(raw[:1]), td._BitReader(raw[:1])):
        rd.read_bits(8)
        with pytest.raises(ValueError, match="exhausted"):
            rd.read_bit()
        with pytest.raises(ValueError, match="exhausted"):
            rd.read_bits(3)
    for s in range(0, 12):
        for v in (0, 1, (1 << s) - 1, 1 << max(s - 1, 0)):
            assert td._extend(v, s) == jd._extend(v, s)
    dc_t, ac_t = standard_tables()
    for t in dc_t + ac_t:
        assert td._decode_lut(t) == jd._decode_lut(t)
    lut = td._decode_lut(ac_t[0])
    a, b = jd._BitReader(raw), td._BitReader(raw)
    for _ in range(20):
        try:
            want = jd._read_symbol(a, lut)
        except ValueError:
            with pytest.raises(ValueError, match="invalid Huffman code"):
                td._read_symbol(b, lut)
            break
        assert td._read_symbol(b, lut) == want and a.pos == b.pos
    assert td._tables_by_id({0: "a", 3: "b"}) == \
        jd._tables_by_id({0: "a", 3: "b"}) == ["a", None, None, "b"]


@pytest.mark.parametrize("mode,dri,two_level", [
    ("420", 0, False), ("422", 3, False), ("444", 0, True), ("gray", 2, False),
    ("420", 2, True)])
def test_scan_decoders_equal_reference(mode, dri, two_level, monkeypatch):
    """decode_scan_to_blocks (native and pure Python), scan_pairs,
    scan_packed, _pairs_from_packed, layout_from_parsed, _qts_of and
    decode_to_coefficients on the same file."""
    jd, td = _decoder_modules()
    data, jp, tp = _scan_file(mode, dri, quality=95 if two_level else 80,
                              two_level=two_level, h=24, w=40)
    jl, tl = jd.layout_from_parsed(jp), td.layout_from_parsed(tp)
    assert (tl.height, tl.width, tl.subsampling, tl.restart_interval) == \
        (jl.height, jl.width, jl.subsampling, jl.restart_interval)
    want = jd.decode_scan_to_blocks(jp, jl)
    from jpgenc_tpu_torch import native as tnative
    with monkeypatch.context() as m:
        m.setattr(tnative, "available", lambda: False)
        pure_python = td.decode_scan_to_blocks(tp, tl)
    for got in (td.decode_scan_to_blocks(tp, tl), pure_python,
                td.decode_scan_to_blocks(tp, tl, n_threads=1),
                td.decode_to_coefficients(data)[1]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for a, b in zip(td.scan_pairs(tp, tl), jd.scan_pairs(jp, jl)):
        np.testing.assert_array_equal(a, b)
    pk, jpk = td.scan_packed(tp, tl), jd.scan_packed(jp, jl)
    for a, b in zip(pk, jpk):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if two_level:
        assert pk[1].size > 0
    for a, b in zip(td._pairs_from_packed(pk, tl),
                    jd._pairs_from_packed(jpk, jl)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(td._qts_of(tp), jd._qts_of(jp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(td._inv_scan(tl), jd._inv_scan(jl))
    np.testing.assert_array_equal(td._scan_space_eidx(pk[1], tl),
                                  jd._scan_space_eidx(jpk[1], jl))
    e = np.arange(0, tl.n_scan * 64, 37, dtype=np.int32)
    np.testing.assert_array_equal(td._scan_space_eidx(e, tl),
                                  jd._scan_space_eidx(e, jl))


def test_scan_decode_errors_equal_reference(monkeypatch):
    jd, td = _decoder_modules()
    data, jp, tp = _scan_file("420", 0)
    tl = td.layout_from_parsed(tp)
    for mod, parsed in ((jd, jp), (td, tp)):
        broken = dataclasses.replace(parsed, comps=[
            dataclasses.replace(c, dc_tab=3) for c in parsed.comps])
        with pytest.raises(ValueError, match="undefined DC Huffman table 3"):
            mod.decode_scan_to_blocks(broken, tl)
        broken = dataclasses.replace(parsed, comps=[
            dataclasses.replace(c, qtab=2) for c in parsed.comps])
        with pytest.raises(ValueError, match="undefined quant table 2"):
            mod._qts_of(broken)
    from jpgenc_tpu_torch import native as tnative
    monkeypatch.setattr(tnative, "available", lambda: False)
    dri = dataclasses.replace(tp, restart_interval=2)
    with pytest.raises(ValueError, match="restart segments"):
        td.decode_scan_to_blocks(dri, td.layout_from_parsed(dri))


@pytest.mark.parametrize("sub", ["420", "422", "444", "gray", "411"])
def test_q_rows_equals_reference(sub):
    jd, td = _decoder_modules()
    from jpgenc_tpu_torch.layout import make_layout as tmake
    rng = np.random.default_rng(10)
    jl, tl = make_layout(32, 48, sub), tmake(32, 48, sub)
    for shape in ((64,), (3, 64)):
        qts = [rng.integers(1, 255, shape).astype(np.int32) for _ in tl.comps]
        got = td._q_rows(tl, qts)
        want = np.asarray(jd._q_rows(jl, [jnp.asarray(q) for q in qts]))
        assert got.dtype == np.float32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


def test_sparse_row_helpers_equal_reference():
    jd, td = _decoder_modules()
    rng = np.random.default_rng(11)
    blocks = (rng.integers(-300, 300, (40, 64))
              * (rng.random((40, 64)) < 0.1)).astype(np.int32)
    nz = np.flatnonzero(blocks)
    for size in (blocks.size, 70000):            # idx_hi matters past 65535
        idx = nz.astype(np.int64) * size // blocks.size
        np.testing.assert_array_equal(
            td._rows_from_pairs(idx, blocks.reshape(-1)[nz], size, 4096),
            jd._rows_from_pairs(idx, blocks.reshape(-1)[nz], size, 4096))
    np.testing.assert_array_equal(td._sparsify(blocks, 4096),
                                  jd._sparsify(blocks, 4096))
    np.testing.assert_array_equal(td._sparsify(blocks, 4096),
                                  jd._sparsify(blocks))
    main = rng.integers(0, 256, (50, 2)).astype(np.uint8)
    eidx = rng.integers(0, 2560, 5).astype(np.int32)
    evals = rng.integers(-900, 900, 5).astype(np.int16)
    for a, b in zip(td._pad_packed(main, eidx, evals, 64, 8, 2560),
                    jd._pad_packed(main, eidx, evals, 64, 8, 2560)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for n, n64 in ((1000, 2560), (5000, 2560), (1, 64)):
        assert td._packed_wins(n, 3, n64) == jd._packed_wins(n, 3, n64)
        assert td._sparse_wins(n, n64) == jd._sparse_wins(n, n64)


@pytest.mark.parametrize("mode,dri,two_level", [("420", 0, False),
                                                ("422", 2, True),
                                                ("gray", 0, False)])
def test_flatten_packed_equals_reference(mode, dri, two_level):
    jd, td = _decoder_modules()
    packed = []
    for seed in (1, 2, 3, 4):
        _, _, tp = _scan_file(mode, dri, quality=95 if two_level else 60,
                              seed=seed, two_level=two_level, h=24, w=40)
        tl = td.layout_from_parsed(tp)
        packed.append(td.scan_packed(tp, tl))
    # an empty frame and a frame that starts late force the bridging hops
    packed.insert(2, (np.zeros((0, 2), np.uint8), np.zeros(0, np.int32),
                      np.zeros(0, np.int16)))
    late = packed[0][0].copy()
    late[0, 0] = 255
    packed.append((late, packed[0][1], packed[0][2]))
    n64 = tl.n_scan * 64
    for a, b in zip(td._flatten_packed(packed, n64, n64),
                    jd._flatten_packed(packed, n64, n64)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(td._flatten_packed([], n64, n64),
                    jd._flatten_packed([], n64, n64)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,h,w", [("420", 47, 111), ("422", 17, 23),
                                      ("444", 24, 30), ("gray", 33, 20)])
def test_ref_islow_equals_reference(mode, h, w):
    """ref/islow.py is the port's own copy of the numpy integer tier: same
    constants, same functions, same coefficients from the same pixels."""
    from jpgenc_tpu.ref import islow as jr
    from jpgenc_tpu_torch.layout import make_layout as tmake
    from jpgenc_tpu_torch.ref import islow as tr
    consts = [n for n in dir(jr) if n.isupper() or n.startswith("_F_")]
    assert len(consts) >= 15
    assert consts == [n for n in dir(tr)
                      if n.isupper() or n.startswith("_F_")]
    for n in consts:
        assert getattr(tr, n) == getattr(jr, n), n
    assert [tr._fix(x) for x in (0.299, 0.5, 0.08131)] == \
        [jr._fix(x) for x in (0.299, 0.5, 0.08131)]
    rng = np.random.default_rng(h * w)
    blocks = rng.integers(-128, 128, (20, 8, 8))
    np.testing.assert_array_equal(tr.fdct8x8_islow(blocks),
                                  jr.fdct8x8_islow(blocks))
    img = rng.integers(0, 256, (h, w) if mode == "gray" else (h, w, 3),
                       dtype=np.uint8)
    if mode != "gray":
        np.testing.assert_array_equal(tr.rgb_to_ycbcr_islow(img),
                                      jr.rgb_to_ycbcr_islow(img))
    qt = list(jeng.qtables_for_quality(60)[0])
    np.testing.assert_array_equal(
        tr.image_to_zigzag_islow(img, tmake(h, w, mode, 0), qt),
        jr.image_to_zigzag_islow(img, make_layout(h, w, mode, 0), qt))
