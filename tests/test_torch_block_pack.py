"""Kernel A's wrapper in the port (`ops/cuda/block_pack.fused_block_pack` on
CPU tensors, i.e. its plain version) and its torch prologue against the JAX
package's `slot_metadata` + `fused_block_pack(interpret=True)`, on the same
synthetic coefficients made from literal seeds.

Everything here is integer bit manipulation: the tolerance is exact, words
and bit counts, for the standard tables and for per-image optimized tables,
at w_blk 8 / 24 / 56, with blocks that overflow the small tiers and with
valid == 0 padding slots (a restart-interval layout pads its last segment).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpgenc_tpu import engine as jeng
from jpgenc_tpu.huffman import build_codes, optimize_tables
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops.entropy import symbol_histogram
from jpgenc_tpu.ops.pallas.block_pack import (fused_block_pack as jax_pack,
                                              packed_tables as jax_tables,
                                              slot_metadata as jax_meta)
from jpgenc_tpu.ref.encoder import standard_tables
from jpgenc_tpu_torch import engine
from jpgenc_tpu_torch.ops.cuda import block_pack

torch.set_num_threads(1)

#: (h, w, mode, restart interval): the DRI layouts pad 18 and 3 slots
LAYOUTS = [(40, 56, "420", 5), (24, 40, "444", 0), (24, 40, "gray", 4)]


def _blocks(seed, n_img, n_slots):
    """Sparse quantized-looking zigzag blocks: a decaying spectrum, a few
    long zero runs (ZRL), some dense large blocks (overflow at w_blk 8)."""
    rng = np.random.default_rng(seed)
    scale = 60.0 / (1.0 + np.arange(64)) ** 1.3
    zz = np.round(rng.normal(0, 1, (n_img, n_slots, 64)) * scale)
    zz[:, ::7, 40:] = 0
    zz[:, ::7, 60] = rng.integers(-3, 4, (n_img, len(zz[0, ::7])))
    dense = rng.integers(-1023, 1024, (n_img, n_slots, 64))
    pick = rng.random((n_img, n_slots)) < 0.08
    zz[pick] = dense[pick]
    zz[..., 0] = rng.integers(-1000, 1001, (n_img, n_slots))
    return zz.astype(np.int16)


def _setup(h, w, mode, dri, n_img=2, seed=3):
    lay = make_layout(h, w, mode, dri)
    sp = engine.make_symbol_plan(lay)
    zz = _blocks(seed, n_img, sp.valid.size)
    zz[:, ~sp.valid] = 0                    # padding slots hold zero blocks
    return lay, sp, zz


def _plan_tensors(sp):
    return (torch.from_numpy(sp.ac_tab), torch.from_numpy(sp.dc_tab),
            torch.from_numpy(sp.valid.astype(np.int32)))


@pytest.mark.parametrize("h,w,mode,dri", LAYOUTS)
def test_symbol_plan_and_slot_metadata_equal_reference(h, w, mode, dri):
    lay, sp, zz = _setup(h, w, mode, dri)
    jp = jeng.make_symbol_plan(lay)
    for name in ("prev_same", "dc_tab", "ac_tab", "valid"):
        np.testing.assert_array_equal(getattr(sp, name),
                                      np.asarray(getattr(jp, name)))
    np.testing.assert_array_equal(engine.make_scan_gather(lay),
                                  jeng.make_scan_gather(lay))
    ours = block_pack.slot_metadata(
        torch.from_numpy(sp.prev_same.astype(np.int64)), torch.from_numpy(zz))
    for i in range(zz.shape[0]):
        diff = jax_meta(jp, jnp.asarray(zz[i]))[0]
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(diff))


@pytest.mark.parametrize("tables", ["standard", "optimized"])
@pytest.mark.parametrize("w_blk", [8, 24, 56])
@pytest.mark.parametrize("h,w,mode,dri", LAYOUTS)
def test_block_pack_plain_vs_pallas_interpret(h, w, mode, dri, w_blk, tables):
    lay, sp, zz = _setup(h, w, mode, dri)
    jp = jeng.make_symbol_plan(lay)
    n_tabs = 1 if lay.is_gray else 2
    if tables == "standard":
        dc_t, ac_t = standard_tables()
        per_img = [(dc_t[:n_tabs], ac_t[:n_tabs])] * zz.shape[0]
        luts = engine.luts_from_tables(*per_img[0])
        ours_tabs = block_pack.packed_tables(luts)
    else:
        per_img = []
        for i in range(zz.shape[0]):
            freq = np.asarray(symbol_histogram(
                jnp.asarray(zz[i].astype(np.int32)), jp))
            per_img.append(tuple(
                [build_codes(*optimize_tables(freq[k, t].astype(np.int64)))
                 for t in range(n_tabs)] for k in (0, 1)))
        ours_tabs = engine.device_tables(*zip(*per_img), "cpu")
    dcdiff = block_pack.slot_metadata(
        torch.from_numpy(sp.prev_same.astype(np.int64)), torch.from_numpy(zz))
    calls = block_pack.plain_calls
    buf, bits = block_pack.fused_block_pack(
        torch.from_numpy(zz), dcdiff, *_plan_tensors(sp), ours_tabs, w_blk)
    assert block_pack.plain_calls == calls + 1
    assert buf.dtype == torch.int32 and bits.dtype == torch.int32
    overflowed = False
    for i, (dc_i, ac_i) in enumerate(per_img):
        zi = jnp.asarray(zz[i].astype(np.int32))
        ref_buf, ref_bits = jax_pack(
            zi, *jax_meta(jp, zi),
            tables=jax_tables(jeng.luts_from_tables(dc_i, ac_i)),
            w_blk=w_blk, interpret=True)
        np.testing.assert_array_equal(bits[i].numpy(), np.asarray(ref_bits))
        np.testing.assert_array_equal(buf[i].numpy().view(np.uint32),
                                      np.asarray(ref_buf))
        overflowed |= int(np.asarray(ref_bits).max()) > 32 * w_blk
    assert overflowed == (w_blk < 56)       # the dense blocks pass 24 words
    pad = ~sp.valid
    assert int(bits[:, pad].abs().sum()) == 0
    assert int(buf[:, pad].abs().sum()) == 0


def _hand_blocks():
    """Hand-made zigzag blocks: zero runs of 15, 16, 31, 32, 47 and 48 before
    a nonzero (0-3 ZRLs), a nonzero at position 63 (no EOB), the all-nonzero
    block, AC +-1023, DC differences +-2047, an empty block, a padding slot;
    then random dense blocks (which overflow w_blk 1 and 8)."""
    rng = np.random.default_rng(21)
    zz = np.zeros((40, 64), np.int64)
    for k, run in enumerate((15, 16, 31, 32, 47, 48)):
        zz[k, 1 + run] = 3 - 6 * (k & 1)
    zz[6, 63] = 1
    zz[7, 1:] = rng.integers(1, 1024, 63) * rng.choice([-1, 1], 63)
    zz[8, 1:] = 1023
    zz[9, [1, 63]] = -1023
    zz[12:] = rng.integers(-1023, 1024, (28, 64))
    dcdiff = np.zeros(40, np.int64)
    dcdiff[:12] = [0, 2047, -2047, 0, 2047, -2047, 5, -5, 1000, -1000, 0, 0]
    dcdiff[12:] = rng.integers(-2047, 2048, 28)
    tab = np.arange(40) % 2
    valid = np.ones(40, np.int64)
    valid[10] = 0
    return zz, dcdiff, tab, valid


@pytest.mark.parametrize("w_blk", [1, 8, 56])
def test_block_pack_plain_on_hand_made_blocks(w_blk):
    """pack_blocks_plain against the Pallas kernel A (interpret mode) on the
    hand-made blocks: words and true bit counts exact, the padding slot
    empty, blocks past w_blk truncated."""
    zz, dcdiff, tab, valid = _hand_blocks()
    luts = engine.luts_from_tables(*standard_tables())
    buf, bits = block_pack.pack_blocks_plain(
        torch.from_numpy(zz), torch.from_numpy(dcdiff),
        torch.from_numpy(tab), block_pack.packed_tables(luts), w_blk,
        valid=torch.from_numpy(valid))
    i32 = [jnp.asarray(a.astype(np.int32)) for a in (zz, dcdiff, tab, tab,
                                                     valid)]
    ref_buf, ref_bits = jax_pack(
        *i32, tables=jax_tables(jeng.luts_from_tables(*standard_tables())),
        w_blk=w_blk, interpret=True)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_bits))
    np.testing.assert_array_equal(buf.numpy().view(np.uint32),
                                  np.asarray(ref_buf))
    assert int(bits[10]) == 0 and not buf[10].any()
    assert (int(bits[7]) > 32 * w_blk) == (w_blk < 56)


def test_block_pack_wrapper_checks_its_operands():
    lay, sp, zz = _setup(24, 40, "444", 0)
    tabs = block_pack.packed_tables(
        engine.luts_from_tables(*standard_tables()))
    dcdiff = torch.zeros(zz.shape[:2], dtype=torch.int32)
    with pytest.raises(ValueError, match="do not agree"):
        block_pack.fused_block_pack(torch.from_numpy(zz), dcdiff[:, :-1],
                                    *_plan_tensors(sp), tabs, 8)
    three = tuple(t[None].repeat(3, *[1] * t.dim()) for t in tabs)
    with pytest.raises(ValueError, match="table sets"):
        block_pack.fused_block_pack(torch.from_numpy(zz), dcdiff,
                                    *_plan_tensors(sp), three, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        block_pack.fused_block_pack(torch.from_numpy(zz).to("meta"),
                                    dcdiff.to("meta"),
                                    *(t.to("meta") for t in _plan_tensors(sp)),
                                    tabs, 8)
