"""K1A's plain version in the port against the JAX package's Pallas kernels
run in interpret mode, on the same numpy inputs.

- transform_plain vs k1_dct.fused_pixels_to_scan: the knife-edge policy of
  k1_dct.py:18-24 (|diff| <= 1 on at most 1e-4 of the coefficients: the
  reference multiplies by its dense operator, the port runs the shared
  per-block transform), and vs jpgenc_tpu.engine.pixels_to_scan, the same
  formulation: 0 differing coefficients;
- entropy_plain on the JAX zz vs slot_metadata + fused_block_pack: bit for
  bit, including overflowing blocks;
- pixels_to_pack_plain vs fused_pixels_to_pack: bit for bit, colour and
  gray (`_fused_gray`, the gray K1A kernel).

Inputs are made from literal seeds in this file.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpgenc_tpu.engine import get_plan as jax_plan, qtables_for_quality
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops.pallas.block_pack import (fused_block_pack, slot_metadata,
                                              packed_tables as jax_tables)
from jpgenc_tpu.ops.pallas.k1_dct import fused_pixels_to_scan
from jpgenc_tpu.ops.pallas.k1a_fused import fused_pixels_to_pack
from jpgenc_tpu.utils.fixtures import synth_frame
from jpgenc_tpu_torch import engine
from jpgenc_tpu_torch.ops.cuda import k1a_fused

torch.set_num_threads(1)

KNIFE_EDGE_FRAC = 1e-4


def _setup(h, w, sub, quality=75):
    lay = make_layout(h, w, sub, 0)
    plan = engine.get_plan(h, w, sub, quality, "cpu")
    return lay, plan, (lay, plan.kdct, plan.q), \
        (plan.ac_rows, plan.dc_rows, plan.misc)


def _jax_luts():
    from jpgenc_tpu.engine import luts_from_tables
    from jpgenc_tpu.ref.encoder import standard_tables
    return jax_tables(luts_from_tables(*standard_tables()))


@pytest.mark.parametrize("h,w,sub,quality", [
    (120, 136, "420", 50), (64, 126, "422", 75), (96, 120, "444", 95)])
def test_transform_plain_vs_k1_interpret(h, w, sub, quality):
    img = synth_frame(h, w, seed=21)
    lay, _, ops, _ = _setup(h, w, sub, quality)
    zz = k1a_fused.transform_plain(torch.from_numpy(img)[None], *ops)
    ref = np.asarray(fused_pixels_to_scan(
        jnp.asarray(img), lay, qtables_for_quality(quality)[1],
        interpret=True)).astype(np.int32)
    d = np.abs(zz.reshape(-1, 64).numpy() - ref)
    assert d.max() <= 1
    assert (d > 0).mean() <= KNIFE_EDGE_FRAC
    from jpgenc_tpu.engine import pixels_to_scan
    np.testing.assert_array_equal(
        zz.reshape(-1, 64).numpy(),
        np.asarray(pixels_to_scan(jnp.asarray(img), lay,
                                  qtables_for_quality(quality)[1])))


@functools.lru_cache(maxsize=8)
def _jax_zz(key, quality):
    """JAX K1 (interpret mode) zz of the rgb fixture or of a noise frame."""
    img = _IMAGES[key]
    lay = make_layout(img.shape[0], img.shape[1], key[1], 0)
    return img, lay, fused_pixels_to_scan(
        jnp.asarray(img), lay, qtables_for_quality(quality)[1],
        interpret=True)


_IMAGES = {}


def _jax_split_pipeline(key, quality, w_blk):
    img, lay, zz = _jax_zz(key, quality)
    meta = slot_metadata(jax_plan(lay).plan, zz)
    buf, bits = fused_block_pack(zz, *meta, tables=_jax_luts(), w_blk=w_blk,
                                 interpret=True)
    return lay, np.asarray(zz), np.asarray(buf), np.asarray(bits)


def _entropy_case(key, quality, w_blk):
    lay, zz, ref_buf, ref_bits = _jax_split_pipeline(key, quality, w_blk)
    _, _, _, tabs = _setup(lay.height, lay.width, lay.subsampling, quality)
    buf, bits = k1a_fused.entropy_plain(
        torch.from_numpy(zz.astype(np.int32)).reshape(1, lay.n_mcus, -1),
        lay, tabs, w_blk)
    np.testing.assert_array_equal(bits[0].numpy(), ref_bits)
    np.testing.assert_array_equal(buf[0].numpy().view(np.uint32), ref_buf)
    return ref_bits


@pytest.mark.parametrize("sub,w_blk", [("420", 8), ("420", 56), ("422", 12),
                                       ("444", 24)])
def test_entropy_plain_vs_block_pack_interpret(sub, w_blk):
    _IMAGES[("rgb", sub)] = synth_frame(120, 136, seed=1234)
    _entropy_case(("rgb", sub), 75, w_blk)


@pytest.mark.parametrize("w_blk", [8])
def test_entropy_plain_overflowing_blocks(w_blk):
    """Uniform noise at Q100 overflows the 8-word tier: every block keeps
    its first w_blk words and its true bit count, exactly as kernel A."""
    _IMAGES[("noise", "420")] = np.random.default_rng(11).integers(
        0, 256, (32, 48, 3), np.uint8)
    assert _entropy_case(("noise", "420"), 100, w_blk).max() > 32 * w_blk


@pytest.mark.parametrize("h,w,sub,w_blk", [(32, 136, "420", 8),
                                           (16, 62, "444", 12)])
def test_pixels_to_pack_plain_vs_k1a_interpret(h, w, sub, w_blk):
    img = synth_frame(h, w)
    lay, _, ops, tabs = _setup(h, w, sub)
    ref_buf, ref_bits = fused_pixels_to_pack(
        jnp.asarray(img), lay, qtables_for_quality(75)[1], _jax_luts(),
        w_blk, interpret=True)
    buf, bits = k1a_fused.pixels_to_pack_plain(torch.from_numpy(img)[None],
                                               *ops, tabs, w_blk)
    np.testing.assert_array_equal(bits[0].numpy(), np.asarray(ref_bits))
    np.testing.assert_array_equal(buf[0].numpy().view(np.uint32),
                                  np.asarray(ref_buf))


@pytest.mark.parametrize("h,w,quality,w_blk", [(40, 50, 75, 8),
                                                (17, 23, 95, 16)])
def test_gray_pixels_to_pack_plain_vs_k1a_gray_interpret(h, w, quality, w_blk):
    """Gray K1A: one 8x8 block per MCU, luma tables, raster DPCM across MCU
    rows. Words and bits exact wherever the coefficients agree, which the
    transform's knife-edge policy does not promise but these sizes give."""
    img = synth_frame(h, w, channels=1, seed=5)[..., 0].copy()
    lay, _, ops, tabs = _setup(h, w, "gray", quality)
    ref_buf, ref_bits = fused_pixels_to_pack(
        jnp.asarray(img), lay, qtables_for_quality(quality)[1], _jax_luts(),
        w_blk, interpret=True)
    buf, bits = k1a_fused.pixels_to_pack_plain(torch.from_numpy(img)[None],
                                               *ops, tabs, w_blk)
    np.testing.assert_array_equal(bits[0].numpy(), np.asarray(ref_bits))
    np.testing.assert_array_equal(buf[0].numpy().view(np.uint32),
                                  np.asarray(ref_buf))


def test_batch_dpcm_resets_per_image():
    """Images of a batch are independent: each one's DC chain restarts at its
    MCU 0, so a batch equals its images coded one by one."""
    imgs = np.stack([synth_frame(48, 64, seed=s) for s in (1, 2, 3)])
    _, _, ops, tabs = _setup(48, 64, "420")
    buf, bits = k1a_fused.pixels_to_pack_plain(torch.from_numpy(imgs), *ops,
                                               tabs, 8)
    for i in range(3):
        b1, n1 = k1a_fused.pixels_to_pack_plain(
            torch.from_numpy(imgs[i:i + 1]), *ops, tabs, 8)
        assert torch.equal(buf[i], b1[0]) and torch.equal(bits[i], n1[0])


def test_wrapper_takes_plain_version_only_on_cpu():
    img = torch.from_numpy(synth_frame(32, 32))[None]
    _, _, ops, tabs = _setup(32, 32, "420")
    launches, calls = k1a_fused.launches, k1a_fused.plain_calls
    buf, bits = k1a_fused.fused_pixels_to_pack(img, *ops, tabs, 8)
    assert (k1a_fused.launches, k1a_fused.plain_calls) == (launches,
                                                           calls + 1)
    buf2, bits2, zz = k1a_fused.fused_pixels_to_pack(img, *ops, tabs, 8,
                                                     return_zz=True)
    assert torch.equal(buf, buf2) and torch.equal(bits, bits2)
    assert zz.dtype == torch.int16
    assert torch.equal(zz.to(torch.int32),
                       k1a_fused.transform_plain(img, *ops))
    with pytest.raises(ValueError, match="unsupported device"):
        k1a_fused.fused_pixels_to_pack(img.to("meta"), *ops, tabs, 8)
    # a restart interval resets the predictor at each segment start: with
    # DRI 1 every MCU codes its DCs against 0
    buf_r, bits_r, _ = k1a_fused.fused_pixels_to_pack(
        img, make_layout(32, 32, "420", 1), *ops[1:], tabs, 8, return_zz=True)
    assert tuple(bits_r.shape) == tuple(bits.shape)
    assert torch.equal(bits_r[0, :6], bits[0, :6])       # MCU 0: as without
    assert not torch.equal(bits_r, bits)
