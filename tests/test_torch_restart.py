"""Restart intervals in the port against the JAX package, on the CPU
(device="cpu" runs each kernel's plain version). Inputs come from literal
seeds.

(a) K1A / gray K1A `buf`, `bits` and K1 `zz` against the Pallas kernels in
    interpret mode on the grid of tests/test_pallas_k1a.py (restart
    intervals with short last segments and pad slots included): the
    transform under the knife-edge policy of k1_dct.py:18-24 (|diff| <= 1 on
    at most max(1e-4, 2/size) of the coefficients: two float32 matmul
    libraries sum in their own orders), everything after it exact: the
    port's entropy coding of the REFERENCE's coefficients equals the
    reference's packed words and bit counts, pad slots included.
(b) the multi-segment word compaction against
    `jpgenc_tpu.ops.pack.wcompact_unstuffed`: exact, for every chunk width,
    with empty segments in the middle and at the tail.
(c) whole files against `jpgenc_tpu.api.encode`, with the split assertion of
    tests/test_torch_encode.py: coefficients under the knife-edge policy,
    the reference's own coefficients through the port's entropy path byte
    for byte, and whole-file equality wherever no coefficient differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpgenc_tpu import api as japi
from jpgenc_tpu.container.parser import parse_jpeg
from jpgenc_tpu.engine import luts_from_tables, qtables_for_quality
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.native import decode_scan
from jpgenc_tpu.ops import pack as jpack
from jpgenc_tpu.ops.pallas.block_pack import packed_tables as jax_tables
from jpgenc_tpu.ops.pallas.k1_dct import fused_pixels_to_scan as jax_k1
from jpgenc_tpu.ops.pallas.k1a_fused import fused_pixels_to_pack as jax_k1a
from jpgenc_tpu.ref.encoder import standard_tables
from jpgenc_tpu.utils.fixtures import synth_frame
from jpgenc_tpu_torch import api, engine
from jpgenc_tpu_torch.config import EncodeConfig
from jpgenc_tpu_torch.ops import pack as tpack
from jpgenc_tpu_torch.ops.cuda import k1_dct, k1a_fused
from jpgenc_tpu_torch.parallel import mesh

torch.set_num_threads(1)

# the grid of tests/test_pallas_k1a.py:15-26
K1A_GRID = [
    (120, 120, "420", 3),      # short last segment -> pad slots; pad columns
    (64, 126, "422", 2),
    (48, 62, "444", 0),
    (112, 128, "420", 1),      # every MCU its own segment
    (64, 128, "gray", 0),
    (100, 64, "gray", 3),      # gray + DRI, DC chain crossing MCU rows
    (64, 72, "gray", 0),
]  # its two other 4:2:0 rows without DRI: tests/test_torch_k1a.py has such


def _image(h, w, mode, seed=7):
    if mode == "gray":
        return synth_frame(h, w, channels=1, seed=seed)[..., 0].copy()
    return synth_frame(h, w, seed=seed)


def _knife_edge(ours, ref):
    d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= max(1e-4, 2.0 / d.size)
    return int((d > 0).sum())


@pytest.mark.parametrize("h,w,mode,dri", K1A_GRID)
def test_k1a_and_k1_vs_pallas_interpret(h, w, mode, dri):
    w_blk = 8
    img = _image(h, w, mode)
    lay = make_layout(h, w, mode, dri)
    qt = qtables_for_quality(75)[1]
    ref_zz = np.asarray(jax_k1(jnp.asarray(img), lay, qt, interpret=True))
    ref_buf, ref_bits = jax_k1a(
        jnp.asarray(img), lay, qt,
        jax_tables(luts_from_tables(*standard_tables())), w_blk,
        interpret=True)
    ref_buf, ref_bits = np.asarray(ref_buf), np.asarray(ref_bits)

    plan = engine.get_plan(h, w, mode, 75, "cpu", dri)
    ops = (plan.layout, plan.kdct, plan.q)
    x = torch.from_numpy(img)[None]
    s_pad = lay.n_segments * lay.blocks_per_segment
    zz = k1_dct.fused_pixels_to_scan(x, *ops)
    assert zz.dtype == torch.int16 and tuple(zz.shape) == (1, s_pad, 64) \
        == (1,) + ref_zz.shape
    n_diff = _knife_edge(zz[0].numpy(), ref_zz)
    assert not zz[0, lay.n_scan:].any() and not ref_zz[lay.n_scan:].any()

    # after the transform: the reference's coefficients, the port's coder
    buf, bits = k1a_fused.entropy_plain(
        torch.from_numpy(ref_zz[:lay.n_scan].astype(np.int32)).reshape(
            1, lay.n_mcus, -1), plan.layout, plan.standard_tables, w_blk)
    assert tuple(buf.shape) == (1, s_pad, w_blk) == (1,) + ref_buf.shape
    np.testing.assert_array_equal(bits[0].numpy(), ref_bits)
    np.testing.assert_array_equal(buf[0].numpy().view(np.uint32), ref_buf)
    if n_diff == 0:                       # and from pixels, where they agree
        buf, bits = k1a_fused.fused_pixels_to_pack(
            x, *ops, plan.standard_tables, w_blk)
        np.testing.assert_array_equal(bits[0].numpy(), ref_bits)
        np.testing.assert_array_equal(buf[0].numpy().view(np.uint32), ref_buf)


@pytest.mark.parametrize("mode,dri", [("420", 2), ("gray", 5)])
def test_batch_with_restart_interval_is_per_image(mode, dri):
    imgs = np.stack([_image(40, 72, mode, seed=s) for s in (1, 2, 3)])
    plan = engine.get_plan(40, 72, mode, 75, "cpu", dri)
    ops = (plan.layout, plan.kdct, plan.q)
    buf, bits = k1a_fused.fused_pixels_to_pack(torch.from_numpy(imgs), *ops,
                                               plan.standard_tables, 8)
    for i in range(3):
        b1, n1 = k1a_fused.fused_pixels_to_pack(
            torch.from_numpy(imgs[i:i + 1]), *ops, plan.standard_tables, 8)
        assert torch.equal(buf[i], b1[0]) and torch.equal(bits[i], n1[0])


# --- (b) the multi-segment word compaction -----------------------------------

def _segments(seed, n_img, n_seg, w, empty):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (n_img, n_seg, w), dtype=np.uint64) \
        .astype(np.uint32)
    bits = rng.integers(1, 32 * w + 1, (n_img, n_seg)).astype(np.int32)
    for i, s in empty:
        bits[i, s] = 0
    # words past a segment's content are zero, as kernel B leaves them
    used = (bits.astype(np.int64) + 31) >> 5
    words[np.arange(w)[None, None, :] >= used[..., None]] = 0
    return words, bits


@pytest.mark.parametrize("walign", [8, 16, 32, 64])
@pytest.mark.parametrize("cap_w", [96, 1000, 4096])
def test_wcompact_multi_segment_equals_reference(walign, cap_w):
    """cap 96 overflows (the stream is cut, as the reference cuts it), 1000
    is not a chunk multiple, 4096 holds everything; image 0 has an empty
    segment in the middle and two at the tail, image 1 an empty first one."""
    words, bits = _segments(walign + cap_w, 3, 7, 70,
                            empty=[(0, 2), (0, 5), (0, 6), (1, 0)])
    out, nb = tpack.wcompact_unstuffed(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
        cap_w, walign)
    assert tuple(out.shape) == (3, cap_w) and out.dtype == torch.int32
    for i in range(3):
        ref, rnb = jpack.wcompact_unstuffed(
            jnp.asarray(words[i]), jnp.asarray(bits[i]), cap_w, walign)
        np.testing.assert_array_equal(out[i].numpy().view(np.uint32),
                                      np.asarray(ref))
        np.testing.assert_array_equal(nb[i].numpy(), np.asarray(rnb))


def test_wcompact_stream_is_the_segments_bytes():
    """Independent of the reference: the stream's memory image holds every
    segment's bytes at its aligned start, zeros between."""
    words, bits = _segments(5, 1, 4, 20, empty=[(0, 1)])
    out, _ = tpack.wcompact_unstuffed(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits), 256,
        8)
    stream = out[0].numpy().view(np.uint8)
    expect = np.zeros(4 * 256, np.uint8)
    at = 0
    for s in range(4):
        nw = (int(bits[0, s]) + 31) >> 5
        expect[4 * at:4 * (at + nw)] = words[0, s, :nw].astype(">u4") \
            .view(np.uint8)
        at += int(tpack.seg_nwords_aligned(int(bits[0, s]), 8))
    np.testing.assert_array_equal(stream, expect)


# --- (c) whole files ----------------------------------------------------------

def _coefficients(data):
    p = parse_jpeg(data)
    lay = make_layout(p.height, p.width, p.subsampling, p.restart_interval)
    return p, lay, decode_scan(p.scan_data, lay, [c.dc_tab for c in p.comps],
                               [c.ac_tab for c in p.comps],
                               [p.dc_tables.get(i) for i in range(2)],
                               [p.ac_tables.get(i) for i in range(2)])


def _file_from_reference_coefficients(ref, quality, optimize):
    """The reference file's coefficients through the port's entropy path."""
    _, lay, coef = _coefficients(ref)
    plan = engine.get_plan(lay.height, lay.width, lay.subsampling, quality,
                           "cpu", lay.restart_interval)
    zz = torch.from_numpy(coef.astype(np.int16))[None].index_select(
        1, plan.scan_gather)
    zz[:, lay.n_scan:] = 0
    return engine.EncodeJob(plan, EncodeConfig(
        quality=quality, optimize_huffman=optimize), zz=zz).file()


def _rst_markers(scan):
    return [scan[i + 1] for i in range(len(scan) - 1)
            if scan[i] == 0xFF and 0xD0 <= scan[i + 1] <= 0xD7]


H, W = 40, 72                  # 4:2:0: 3 x 5 MCUs; gray: 5 x 9 blocks
ROW = {"420": 5, "422": 5, "444": 9, "gray": 9}
# every mode x DRI {1, 3, 7, one MCU row}, Q {10, 75, 95} rotating so that
# every (mode, Q) and every (Q, DRI) pair occurs
FILE_GRID = [(mode, (10, 75, 95)[(i + j) % 3], dri, (i + j) % 2 == 1)
             for i, mode in enumerate(("420", "422", "444", "gray"))
             for j, dri in enumerate((1, 3, 7, "row"))]


@pytest.mark.parametrize("mode,quality,dri,optimize", FILE_GRID)
def test_restart_files_equal_reference(mode, quality, dri, optimize):
    dri = ROW[mode] if dri == "row" else dri
    img = _image(H, W, mode, seed=3)
    sub = "420" if mode == "gray" else mode
    kw = dict(quality=quality, subsampling=sub, restart_interval=dri,
              optimize=optimize)
    ref = japi.encode(img, **kw)
    ours = api.encode(img, device="cpu", **kw)
    p, lay, a = _coefficients(ours)
    assert p.restart_interval == dri
    assert _rst_markers(p.scan_data) == \
        [0xD0 + (i & 7) for i in range(lay.n_segments - 1)]
    n_diff = _knife_edge(a, _coefficients(ref)[2])
    assert _file_from_reference_coefficients(ref, quality, optimize) == ref
    if n_diff == 0:
        assert ours == ref
    assert mesh.encode_batch(img[None], device="cpu", **kw) == [ours]


def test_encode_batch_restart_equals_per_image():
    """A batch with a noise frame: the tight tier for the batch, the noise
    frame retried alone at the worst tier, each file the per-image one."""
    frames = [synth_frame(48, 64, seed=s) for s in (1, 2)]
    frames.append(np.random.default_rng(9).integers(0, 256, (48, 64, 3),
                                                    dtype=np.uint8))
    batch = np.stack(frames)
    for kw in (dict(restart_interval=3), dict(restart_interval=4,
                                              optimize=True)):
        out = mesh.encode_batch(batch, 75, device="cpu", **kw)
        assert out == [api.encode(f, 75, device="cpu", **kw) for f in batch]
        ref = japi.encode(batch[2], 75, **kw)
        if _knife_edge(_coefficients(out[2])[2], _coefficients(ref)[2]) == 0:
            assert out[2] == ref


def test_worst_tier_with_restart_interval():
    """Noise at Q100 climbs to the 56-word tier with DRI 1 (130 tiny
    segments); the bytes stay the reference's."""
    noise = np.random.default_rng(77).integers(0, 256, (32, 48, 3),
                                               dtype=np.uint8)
    plan = engine.get_plan(32, 48, "444", 100, "cpu", 1)
    job = engine.EncodeJob(plan, EncodeConfig(quality=100, subsampling="444",
                                              restart_interval=1),
                           torch.from_numpy(noise)[None])
    job.tables()
    assert job.recode(0, *job.tiers[0]) is None
    ref = japi.encode(noise, 100, "444", restart_interval=1)
    ours = api.encode(noise, 100, "444", restart_interval=1, device="cpu")
    if _knife_edge(_coefficients(ours)[2], _coefficients(ref)[2]) == 0:
        assert ours == ref
    assert _file_from_reference_coefficients(ref, 100, False) == ref


def test_get_plan_caches_by_restart_interval():
    a = engine.get_plan(32, 32, "420", 75, "cpu", 0)
    b = engine.get_plan(32, 32, "420", 75, "cpu", 2)
    assert a is not b and b.layout.restart_interval == 2
    assert engine.get_plan(32, 32, "420", 75, "cpu") is a
    assert b.layout.n_segments == 2 and int(b.valid.sum()) == 24
