"""K1's plain version in the port (`ops/cuda/k1_dct.fused_pixels_to_scan` on
CPU tensors, colour and gray) against the JAX package, on the same numpy
inputs made from literal seeds.

- vs `jpgenc_tpu.ops.pallas.k1_dct.fused_pixels_to_scan(interpret=True)`, the
  Pallas K1 kernels run as the JAX package's own CPU tests run them. Colour:
  the reference multiplies by its dense operator, the port runs the shared
  per-block transform (BT.601, box mean, - 128, each block times KDCT_ZZ);
  gray: both are (x - 128) @ KDCT_ZZ. Then the same divide-then-round, so the
  tolerance is the knife-edge policy of k1_dct.py:18-24 (|diff| <= 1 on at
  most max(1e-4, 2/size) of the coefficients);
- vs `jpgenc_tpu.engine.pixels_to_scan` (the reference's own path off the
  TPU, the same formulation as the port's plain version): 0 differing
  coefficients, asserted as such, on this file's grid, on the six inputs on
  which the dense-operator plain version rounded one coefficient apart, on
  frames whose height and width are no multiples of the MCU and whose row
  pitch 3*W is no multiple of 16 or of 4, and on the one 16 x 8208 frame;
- the box mean's order of additions in 4:2:2 and 4:2:0, on an image made so
  that the order shows;
- shape, dtype and scan order ([B, n_slots, 64] int16), batch independence
  and the wrapper's device rule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpgenc_tpu import engine as jeng
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops.pallas.k1_dct import fused_pixels_to_scan as jax_k1
from jpgenc_tpu.utils.fixtures import synth_frame
from jpgenc_tpu_torch import engine
from jpgenc_tpu_torch.ops.cuda import k1_dct

torch.set_num_threads(1)

CASES = [(40, 56, "420", 75), (24, 62, "422", 90), (16, 30, "444", 50),
         (40, 50, "gray", 75), (17, 23, "gray", 95)]


def _image(h, w, mode, seed=7):
    if mode == "gray":
        return synth_frame(h, w, channels=1, seed=seed)[..., 0].copy()
    return synth_frame(h, w, seed=seed)


def _ours(imgs, mode, quality):
    h, w = imgs.shape[1:3]
    plan = engine.get_plan(h, w, mode, quality, "cpu")
    return plan, k1_dct.fused_pixels_to_scan(
        torch.from_numpy(imgs), plan.layout, plan.kdct, plan.q)


def _knife_edge(ours, ref):
    d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= max(1e-4, 2.0 / d.size)


@pytest.mark.parametrize("h,w,mode,quality", CASES)
def test_k1_plain_vs_pallas_interpret(h, w, mode, quality):
    img = _image(h, w, mode)
    plan, zz = _ours(img[None], mode, quality)
    lay = make_layout(h, w, mode, 0)
    ref = np.asarray(jax_k1(jnp.asarray(img), lay,
                            jeng.qtables_for_quality(quality)[1],
                            interpret=True))
    assert zz.dtype == torch.int16 and ref.dtype == np.int16
    assert tuple(zz.shape) == (1, lay.n_scan, 64) == (1,) + ref.shape
    _knife_edge(zz[0].numpy(), ref)


def _engine_zz(img, mode, quality):
    h, w = img.shape[:2]
    return np.asarray(jeng.pixels_to_scan(
        jnp.asarray(img), make_layout(h, w, mode, 0),
        jeng.qtables_for_quality(quality)[1]))


@pytest.mark.parametrize("h,w,mode,quality", CASES)
def test_k1_plain_vs_engine_pixels_to_scan(h, w, mode, quality):
    """0 differing coefficients: the two are one formulation."""
    img = _image(h, w, mode, seed=11)
    _, zz = _ours(img[None], mode, quality)
    np.testing.assert_array_equal(zz[0].numpy(),
                                  _engine_zz(img, mode, quality))


@pytest.mark.parametrize("h,w,mode,quality", [
    (128, 128, "420", 75), (128, 128, "422", 75), (128, 128, "444", 75),
    (128, 128, "420", 90), (128, 256, "420", 95), (128, 256, "444", 95)])
def test_k1_plain_equals_engine_on_recorded_knife_edges(h, w, mode, quality):
    """The six synth_frame inputs on which the earlier plain version (one
    f32 matmul with the TPU kernel's dense operator) differed from
    engine.pixels_to_scan on one coefficient each: 0 now."""
    img = synth_frame(h, w)
    _, zz = _ours(img[None], mode, quality)
    np.testing.assert_array_equal(zz[0].numpy(),
                                  _engine_zz(img, mode, quality))


@pytest.mark.parametrize("h,w,mode,quality", [
    (96, 136, "420", 75), (61, 130, "422", 85), (37, 53, "444", 50),
    (33, 75, "420", 90), (16, 8208, "420", 75)])
def test_k1_plain_equals_engine_on_edge_tiles(h, w, mode, quality):
    """Heights and widths that are no multiples of the MCU (the replicate
    pad), row pitches 3*W that are a multiple of 8 only (136), of 2 only
    (130) or odd (53, 75), and the frame wider than the reference's row gate:
    0 differing coefficients."""
    img = synth_frame(h, w, seed=3)
    _, zz = _ours(img[None], mode, quality)
    np.testing.assert_array_equal(zz[0].numpy(),
                                  _engine_zz(img, mode, quality))


@pytest.mark.parametrize("mode", ["422", "420"])
def test_box_mean_order_in_the_samples(mode):
    """The chroma box is summed in row-major order, one float32 rounding per
    add, scaled by the exact 1 / (hs*vs), then level-shifted. On noise the
    Cb samples the transform multiplies (k1_dct.mcu_samples) equal the same
    steps written out here in numpy float32 with that order, bit for bit,
    and so do the coefficients at Q100; in 4:2:0 the column-major order
    gives other samples, so the case can tell the orders apart (in 4:2:2
    the box is one commutative add)."""
    hs, vs = (2, 2) if mode == "420" else (2, 1)
    img = np.random.default_rng(17).integers(0, 256, (48, 80, 3), np.uint8)
    plan, zz = _ours(img[None], mode, 100)
    f = np.float32
    r, g, b = (img[..., c].astype(f) for c in range(3))
    cb = f(-0.168735892) * r + f(-0.331264108) * g + f(0.5) * b + f(128.0)

    def cb_blocks(order):
        p = cb.reshape(48 // vs, vs, 40, hs)
        total = None
        for i, j in order:
            total = p[:, i, :, j] if total is None else total + p[:, i, :, j]
        m = total * f(1.0 / (hs * vs)) - f(128.0)
        return (m.reshape(48 // vs // 8, 8, 5, 8).transpose(0, 2, 1, 3)
                .reshape(-1, 64))

    nb = hs * vs
    samples = k1_dct.mcu_samples(torch.from_numpy(img)[None], plan.layout)
    ours_cb = samples[0, :, nb].numpy()
    row_major = cb_blocks([(i, j) for i in range(vs) for j in range(hs)])
    np.testing.assert_array_equal(ours_cb, row_major)
    if mode == "420":
        col_major = cb_blocks([(i, j) for j in range(hs) for i in range(vs)])
        assert (ours_cb != col_major).any()
    out = row_major @ plan.kdct.numpy() / plan.q.numpy()[-64:]
    np.testing.assert_array_equal(
        zz[0].numpy().reshape(-1, nb + 2, 64)[:, nb],
        np.trunc(out + np.copysign(f(0.5), out)).astype(np.int16))


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_k1_batch_is_per_image(mode):
    imgs = np.stack([_image(24, 40, mode, seed=s) for s in (1, 2, 3)])
    _, zz = _ours(imgs, mode, 75)
    for i in range(3):
        assert torch.equal(zz[i], _ours(imgs[i:i + 1], mode, 75)[1][0])


def test_k1_wrapper_takes_plain_version_only_on_cpu():
    img = torch.from_numpy(_image(16, 16, "420"))[None]
    plan = engine.get_plan(16, 16, "420", 75, "cpu")
    ops = (plan.layout, plan.kdct, plan.q)
    before = (k1_dct.launches, k1_dct.launches_gray, k1_dct.plain_calls)
    zz = k1_dct.fused_pixels_to_scan(img, *ops)
    assert (k1_dct.launches, k1_dct.launches_gray, k1_dct.plain_calls) == \
        (before[0], before[1], before[2] + 1)
    assert torch.equal(zz.reshape(1, plan.layout.n_mcus, -1).to(torch.int32),
                       k1_dct.transform_plain(img, *ops))
    with pytest.raises(ValueError, match="unsupported device"):
        k1_dct.fused_pixels_to_scan(img.to("meta"), *ops)
    # a restart interval pads the slots to whole segments with zero blocks:
    # one MCU of 6 blocks in a segment of 2 MCUs, then 3 MCUs in 2 segments
    dri = k1_dct.fused_pixels_to_scan(img, make_layout(16, 16, "420", 2),
                                      *ops[1:])
    assert tuple(dri.shape) == (1, 12, 64)
    assert torch.equal(dri[:, :6], zz) and not dri[:, 6:].any()
    plan3 = engine.get_plan(16, 48, "420", 75, "cpu", 2)
    img3 = torch.from_numpy(_image(16, 48, "420"))[None]
    zz3 = k1_dct.fused_pixels_to_scan(img3, plan3.layout, plan3.kdct,
                                      plan3.q)
    assert tuple(zz3.shape) == (1, 24, 64) and plan3.layout.n_scan == 18
    assert not zz3[:, 18:].any() and zz3[:, :18].any()


# The gray kernels' tile edges: one tile row (8 * GRAY_TILE px), one tile
# plus one block, a width that is a multiple of 4 only and one that is odd,
# heights that are no multiple of 8, and a single block smaller than 8 x 8
# (the shapes the GPU lane holds the gray kernels at)
GRAY_EDGES = [(24, 8 * k1_dct.GRAY_TILE), (24, 8 * k1_dct.GRAY_TILE + 8),
              (17, 8 * k1_dct.GRAY_TILE + 4), (37, 61), (5, 7), (8, 8)]


@pytest.mark.parametrize("h,w", GRAY_EDGES)
def test_gray_plain_equals_engine_on_tile_edges(h, w):
    """The gray plain version, which the gray kernels are held to on the
    card, against the reference's own path off the TPU: a coefficient may
    differ only where its float64 value lies within 1e-4 of a rounding
    boundary (the two sum the 64 products in other orders; the single 8 x 8
    block holds one at 0.49999997, where the port rounds to 0 and the
    reference to 1)."""
    img = _image(h, w, "gray", seed=5)
    plan, zz = _ours(img[None], "gray", 75)
    zz = zz[0].numpy().astype(np.int32)
    ref = _engine_zz(img, "gray", 75).astype(np.int32)
    d = zz != ref
    assert np.abs(zz - ref).max() <= 1 and d.sum() <= 1
    exact = k1_dct.scaled_coefficients(
        torch.from_numpy(img)[None], plan.layout, plan.kdct, plan.q,
        dtype=torch.float64)[0].numpy()
    assert (np.abs(exact - np.floor(exact) - 0.5)[d] < 1e-4).all()


def test_gray_tile_is_the_kernel_sources_default():
    """k1_dct.GRAY_TILE, by which the GPU lane and the sweep size their
    frames, is 16 blocks times the JPGENC_GRAY_BPT that csrc/common.cuh
    compiles with."""
    import os
    import re

    from jpgenc_tpu_torch.kernels import build
    src = open(os.path.join(build._CSRC, "common.cuh")).read()
    bpt = re.search(r"#define JPGENC_GRAY_BPT (\d+)", src)
    assert bpt and 16 * int(bpt.group(1)) == k1_dct.GRAY_TILE
    assert "constexpr int kGrayTile = 16 * kGrayBpt;" in src
