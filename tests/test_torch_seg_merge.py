"""Kernel B's plain version in the port against the JAX package's Pallas
kernel B (interpret mode) and its jnp reference `segments_from_blocks`, and
the merge tail's plain version (`merge_plain`: kernel B -> word compaction
-> overflow flag) against the JAX package's own tail (`fused_seg_merge` ->
`jpgenc_tpu.ops.pack.wcompact_unstuffed` -> ovf, as
`jpgenc_tpu/parallel/mesh.py:216-227` composes them).

The reference kernel leaves words past each segment's content undefined,
so words are compared within each segment's ceil(bits/32) used words; the
port's own output is zero past them. The tails' streams, nbits and ovf are
compared exactly.
"""
import functools

import numpy as np
import pytest
import torch

from jpgenc_tpu.engine import get_plan, luts_from_tables, qtables_for_quality
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops.entropy import make_pieces
from jpgenc_tpu.ops.pack import block_pack, segments_from_blocks
from jpgenc_tpu.ops.pack import wcompact_unstuffed as jax_wcompact
from jpgenc_tpu.ops.pallas.seg_merge import fused_seg_merge as jax_merge
from jpgenc_tpu.ref.encoder import standard_tables
from jpgenc_tpu.utils.fixtures import synth_frame
from jpgenc_tpu_torch.ops import pack as tpack
from jpgenc_tpu_torch.ops.cuda import seg_merge

torch.set_num_threads(1)

W_BLK = 24


@functools.lru_cache(maxsize=8)
def _blocks(mode, rst, quality=75):
    """Reference per-block words and bits of a synthetic frame."""
    img = synth_frame(120, 136, channels=0 if mode == "gray" else 3)
    layout = make_layout(120, 136, mode, rst)
    plan = get_plan(layout)
    zz = plan.blocks(img, qtables_for_quality(quality)[1])[plan.scan_flat]
    pv, pl_ = make_pieces(zz, plan.plan,
                          luts_from_tables(*standard_tables()))
    buf, bits = block_pack(pv, pl_, W_BLK)
    return layout.n_segments, np.array(buf), np.array(bits)


def _plain(buf, bits, n_seg, cap_words=None):
    w, b = seg_merge.seg_merge_plain(
        torch.from_numpy(buf.view(np.int32)), torch.from_numpy(bits), n_seg,
        buf.shape[1], cap_words=cap_words)
    return w.numpy().view(np.uint32), b.numpy()


def _assert_used_equal(ours, ours_bits, ref, ref_bits):
    np.testing.assert_array_equal(ours_bits, np.asarray(ref_bits))
    ref = np.asarray(ref)
    for s, u in enumerate((np.asarray(ref_bits, np.int64) + 31) // 32):
        np.testing.assert_array_equal(ours[s, :u], ref[s, :u],
                                      err_msg=f"segment {s}")
        assert not ours[s, u:].any(), f"segment {s}: words past content"


@pytest.mark.parametrize("mode,rst", [("420", 0), ("420", 2), ("gray", 3)])
def test_seg_merge_plain_vs_references(mode, rst):
    n_seg, buf, bits = _blocks(mode, rst)
    ours, ours_bits = _plain(buf, bits, n_seg)
    assert ours.shape == (n_seg, buf.shape[0] // n_seg * W_BLK + 2)
    ref_w, ref_b = segments_from_blocks(buf, bits, n_seg, ours.shape[1])
    _assert_used_equal(ours, ours_bits, ref_w, ref_b)
    pal_w, pal_b = jax_merge(buf, bits, n_seg, W_BLK, interpret=True)
    _assert_used_equal(ours, ours_bits, pal_w, pal_b)


@pytest.mark.parametrize("mode,rst", [("420", 2)])
def test_seg_merge_plain_capped(mode, rst):
    """cap_words bounds the allocation; content that fits is unchanged, and
    words past the cap are dropped, never written out of bounds."""
    n_seg, buf, bits = _blocks(mode, rst)
    full, full_b = _plain(buf, bits, n_seg)
    used = (full_b.astype(np.int64) + 31) // 32
    cap = int(used.max()) + 8
    capped, cap_b = _plain(buf, bits, n_seg, cap_words=cap)
    assert capped.shape == (n_seg, cap)
    np.testing.assert_array_equal(capped, full[:, :cap])
    pal_w, pal_b = jax_merge(buf, bits, n_seg, W_BLK, interpret=True,
                             cap_words=cap)
    _assert_used_equal(capped, cap_b, pal_w, pal_b)
    tiny, _ = _plain(buf, bits, n_seg, cap_words=int(used.max()) // 2)
    np.testing.assert_array_equal(tiny, full[:, :tiny.shape[1]])


def test_seg_merge_plain_clamps_overflowing_blocks():
    """A block past 32*w_blk bits is clamped in the offset prologue, as the
    reference kernel does (seg_merge.py:157)."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 256, 32).astype(np.int32)
    bits[5] = 400                                    # overflowed its tier
    # random content, MSB-first, zero past each block's (clamped) length
    pos = np.arange(8 * 32)[None, :]
    on = (pos < np.minimum(bits, 256)[:, None]) & \
        (rng.random((32, 8 * 32)) < 0.5)
    buf = np.packbits(on, axis=1).view(">u4").astype(np.uint32)
    ours, ours_b = _plain(buf, bits, 2)
    pal_w, pal_b = jax_merge(buf, bits, 2, 8, interpret=True)
    _assert_used_equal(ours, ours_b, pal_w, pal_b)
    assert ours_b[0] == np.minimum(bits[:16], 256).sum()


def _batch(mode, rst):
    """Two images of per-block words: the frame's, and the same with block
    5 past its tier (full random words, true bits 32*W_BLK + 50)."""
    n_seg, buf, bits = _blocks(mode, rst)
    buf2, bits2 = buf.copy(), bits.copy()
    buf2[5] = np.random.default_rng(8).integers(0, 2**32, W_BLK,
                                                dtype=np.uint32)
    bits2[5] = 32 * W_BLK + 50
    return n_seg, np.stack([buf, buf2]), np.stack([bits, bits2])


def _jax_tail(buf, bits, n_seg, cap_w, walign):
    """The JAX package's merge tail, image by image (the Pallas kernel once
    over both images' segments)."""
    b = buf.shape[0]
    sw, sb = jax_merge(buf.reshape(-1, W_BLK), bits.reshape(-1), b * n_seg,
                       W_BLK, interpret=True, cap_words=cap_w)
    sw = np.asarray(sw).reshape(b, n_seg, -1)
    sb = np.asarray(sb).reshape(b, n_seg)
    out = [jax_wcompact(sw[i], sb[i], cap_w, walign) for i in range(b)]
    return (np.stack([np.asarray(o[0]) for o in out]),
            np.stack([np.asarray(o[1]) for o in out]),
            bits.max(axis=1) > 32 * W_BLK)


@pytest.mark.parametrize("mode,rst,capped", [("420", 0, False),
                                             ("420", 2, False),
                                             ("420", 2, True),
                                             ("gray", 3, False)])
def test_merge_plain_vs_jax_tail(mode, rst, capped):
    """merge_plain's stream, nbits and ovf equal the JAX package's tail
    exactly; capped, the stream is cut where the reference cuts it."""
    n_seg, buf, bits = _batch(mode, rst)
    walign = tpack.walign_for(buf.shape[1] // n_seg)
    need = tpack.seg_nwords_aligned(
        np.minimum(bits, 32 * W_BLK).reshape(2, n_seg, -1).sum(-1)
        .astype(np.int64), walign).sum(-1)
    cap_w = int(need.max()) // 2 if capped else int(need.max()) + 16
    ws, nb, ovf = seg_merge.merge_plain(
        torch.from_numpy(buf.view(np.int32)), torch.from_numpy(bits), n_seg,
        W_BLK, cap_w, walign)
    ref_ws, ref_nb, ref_ovf = _jax_tail(buf, bits, n_seg, cap_w, walign)
    assert tuple(ws.shape) == (2, cap_w) and ws.dtype == torch.int32
    np.testing.assert_array_equal(ws.numpy().view(np.uint32), ref_ws)
    np.testing.assert_array_equal(nb.numpy(), ref_nb)
    np.testing.assert_array_equal(ovf.numpy(), ref_ovf)
    assert ovf.tolist() == [False, True]


def test_fused_seg_merge_wrapper_on_cpu():
    """The merge tail's wrapper on CPU tensors runs merge_plain and nothing
    else."""
    n_seg, buf, bits = _batch("420", 2)
    args = (torch.from_numpy(buf.view(np.int32)), torch.from_numpy(bits))
    launches, calls = seg_merge.launches, seg_merge.plain_calls
    ws, nb, ovf = seg_merge.fused_merge(*args, n_seg, W_BLK, 3000, 8)
    assert (seg_merge.launches, seg_merge.plain_calls) == (launches,
                                                           calls + 1)
    for got, want in zip((ws, nb, ovf),
                         seg_merge.merge_plain(*args, n_seg, W_BLK, 3000, 8)):
        assert torch.equal(got, want)


def test_fused_merge_checks_its_operands():
    n_seg, buf, bits = _batch("420", 2)
    b, t = torch.from_numpy(buf.view(np.int32)), torch.from_numpy(bits)
    with pytest.raises(ValueError, match="segments"):
        seg_merge.fused_merge(b, t, n_seg + 1, W_BLK, 3000, 8)
    with pytest.raises(ValueError, match="segments"):
        seg_merge.fused_merge(b, t[:, :-1], n_seg, W_BLK, 3000, 8)
    with pytest.raises(ValueError, match="segments"):
        seg_merge.fused_merge(b.reshape(-1, W_BLK), t.reshape(-1), n_seg,
                              W_BLK, 3000, 8)
    with pytest.raises(ValueError, match="power of two"):
        seg_merge.fused_merge(b, t, n_seg, W_BLK, 3000, 12)
    with pytest.raises(ValueError, match="power of two"):
        seg_merge.fused_merge(b, t, n_seg, W_BLK, 0, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        seg_merge.fused_merge(b.to("meta"), t.to("meta"), n_seg, W_BLK,
                              3000, 8)
