"""The libjpeg-exact integer path (dct_method="islow") of the port, on the
CPU. The path is integer arithmetic end to end, so every comparison here is
exact, from pixels:

- `jpgenc_tpu_torch.ops.islow` (torch int32 ops over a batch) against
  `jpgenc_tpu.ops.islow` (jnp) and against the numpy reference tier
  `ref.islow`, function by function and for the whole pixels -> zigzag
  pipeline, odd sizes and every sampling;
- whole files byte-identical to `jpgenc_tpu.api.encode(dct_method="islow")`
  and to Pillow (libjpeg-turbo) on the grid of tests/test_islow_parity.py;
- `encode_batch` equals per-image `encode`.

Inputs are made from literal seeds.
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jpgenc_tpu import api as japi
from jpgenc_tpu import engine as jeng
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops import islow as jislow
from jpgenc_tpu.utils.fixtures import synth_frame
from jpgenc_tpu_torch import api, engine
from jpgenc_tpu_torch.ops import islow as tislow
from jpgenc_tpu_torch.parallel import mesh
from jpgenc_tpu_torch.ref import encoder as ref_encoder
from jpgenc_tpu_torch.ref import islow as ref_islow

torch.set_num_threads(1)

_PIL_SUBS = {"444": 0, "422": 1, "420": 2}


def _pillow(img, quality, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality,
                              **({} if mode == "gray"
                                 else {"subsampling": _PIL_SUBS[mode]}),
                              **kw)
    return buf.getvalue()


def _ours(img, quality, mode, **kw):
    return api.encode(img, quality, "420" if mode == "gray" else mode,
                      dct_method="islow", device="cpu", **kw)


def _frame(h, w, mode, seed=0):
    img = synth_frame(h, w, seed=seed)
    return img[:, :, 0].copy() if mode == "gray" else img


# --- ops.islow, function by function ------------------------------------------

def test_fdct_and_quantize_equal_reference():
    rng = np.random.default_rng(41)
    blocks = rng.integers(-128, 128, (3, 50, 8, 8)).astype(np.int32)
    blocks[0, 0] = 127                     # the extremes: largest intermediates
    blocks[0, 1] = -128
    blocks[0, 2] = np.where(np.indices((8, 8)).sum(0) % 2, 127, -128)
    ours = tislow.fdct8x8_islow(torch.from_numpy(blocks))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(),
                                  ref_islow.fdct8x8_islow(blocks))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jislow.fdct8x8_islow(jnp.asarray(blocks))))
    for quality in (10, 75, 100):
        qt = jeng.qtables_for_quality(quality)[0][0]
        q = tislow.quantize_islow(ours, torch.from_numpy(qt.astype(np.int32)))
        np.testing.assert_array_equal(
            q.numpy(), ref_islow.quantize_islow(ours.numpy(), qt))
        np.testing.assert_array_equal(
            q.numpy(), np.asarray(jislow.quantize_islow(
                jnp.asarray(ours.numpy()), jnp.asarray(qt))))


def test_color_and_downsample_equal_reference():
    rng = np.random.default_rng(42)
    rgb = rng.integers(0, 256, (2, 14, 22, 3), dtype=np.uint8)
    rgb[0, 0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
    planes = tislow.rgb_to_ycbcr_islow(torch.from_numpy(rgb))
    np.testing.assert_array_equal(torch.stack(planes, -1).numpy(),
                                  ref_islow.rgb_to_ycbcr_islow(rgb))
    for p, j in zip(planes, jislow.rgb_to_ycbcr_islow(jnp.asarray(rgb))):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    cb = planes[1]
    np.testing.assert_array_equal(
        tislow._downsample(cb, 2, 2)[1].numpy(),
        ref_islow.downsample_h2v2_islow(cb[1].numpy().astype(np.uint8)))
    np.testing.assert_array_equal(
        tislow._downsample(cb, 2, 1)[0].numpy(),
        ref_islow.downsample_h2v1_islow(cb[0].numpy().astype(np.uint8)))
    for rx, ry in ((2, 2), (2, 1)):
        np.testing.assert_array_equal(
            tislow._downsample(cb, rx, ry)[1].numpy(),
            np.asarray(jislow._downsample(jnp.asarray(cb[1].numpy()), rx,
                                          ry)))


@pytest.mark.parametrize("h,w,mode", [(17, 23, "420"), (47, 111, "420"),
                                      (121, 130, "422"), (60, 62, "444"),
                                      (17, 23, "gray"), (64, 80, "420")])
def test_image_to_zigzag_equals_reference(h, w, mode):
    """Dummy rows and columns, odd sizes, every sampling; a batch of two."""
    imgs = np.stack([_frame(h, w, mode, seed=s) for s in (1, 2)])
    lay = make_layout(h, w, mode, 0)
    tlay = engine.L.make_layout(h, w, mode, 0)
    qt_host, qt_dev = jeng.qtables_for_quality(80)
    for a, b in zip(tislow._dummy_maps(tlay), jislow._dummy_maps(lay)):
        assert a[:4] == b[:4]
        np.testing.assert_array_equal(a[4], b[4])
        np.testing.assert_array_equal(a[5], b[5])
    zz = tislow.image_to_zigzag_islow(
        torch.from_numpy(imgs), tlay,
        torch.from_numpy(qt_host.astype(np.int32)))
    assert zz.dtype == torch.int32 and \
        tuple(zz.shape) == (2, sum(c.n_blocks for c in lay.comps), 64)
    for i in range(2):
        np.testing.assert_array_equal(
            zz[i].numpy(),
            ref_islow.image_to_zigzag_islow(imgs[i], tlay, list(qt_host)))
        np.testing.assert_array_equal(
            zz[i].numpy(), np.asarray(jislow.image_to_zigzag_islow(
                jnp.asarray(imgs[i]), lay, qt_dev)))


def test_plan_zz_islow_is_scan_ordered_int16():
    plan = engine.get_plan(47, 111, "420", 75, "cpu", 4)
    lay = plan.layout
    x = torch.from_numpy(np.stack([synth_frame(47, 111, seed=s)
                                   for s in (3, 4)]))
    zz, dcdiff = plan.zz_islow(x)
    s_pad = lay.n_segments * lay.blocks_per_segment
    assert zz.dtype == torch.int16 and tuple(zz.shape) == (2, s_pad, 64)
    assert s_pad > lay.n_scan and tuple(dcdiff.shape) == (2, s_pad)
    raster = ref_islow.image_to_zigzag_islow(
        x[1].numpy(), lay, list(engine.qtables_for_quality(75)))
    np.testing.assert_array_equal(zz[1, :lay.n_scan].numpy(),
                                  raster[lay.scan_flat])
    zz2, dc2, hist = plan.zz_islow_and_histogram(x)
    assert torch.equal(zz2, zz) and torch.equal(dc2, dcdiff)
    np.testing.assert_array_equal(hist[1].numpy(),
                                  ref_encoder.symbol_histogram(lay, raster))


# --- whole files: the grid of tests/test_islow_parity.py:51-99 ----------------

@pytest.mark.parametrize("mode", ["gray", "444", "422", "420"])
@pytest.mark.parametrize("q", [50, 75, 90])
def test_whole_file_byte_parity(mode, q):
    img = _frame(120, 136, mode)
    assert _ours(img, q, mode) == _pillow(img, q, mode)


@pytest.mark.parametrize("hw", [(16, 16), (17, 23), (60, 60), (121, 130),
                                (47, 111), (128, 144)])
def test_byte_parity_sizes_420(hw):
    img = synth_frame(*hw)
    assert _ours(img, 75, "420") == _pillow(img, 75, "420")


@pytest.mark.parametrize("hw", [(17, 23), (60, 62), (121, 130)])
def test_byte_parity_sizes_422_gray(hw):
    img = synth_frame(*hw)
    assert _ours(img, 80, "422") == _pillow(img, 80, "422")
    g = img[:, :, 0].copy()
    assert _ours(g, 85, "gray") == _pillow(g, 85, "gray")


def test_byte_parity_noise():
    """Noise exercises every SSSS bucket and run pattern, and climbs the
    capacity ladder from the cached coefficients."""
    img = np.random.default_rng(3).integers(0, 256, (64, 80, 3),
                                            dtype=np.uint8)
    assert _ours(img, 75, "420") == _pillow(img, 75, "420")
    assert _ours(img, 95, "444") == _pillow(img, 95, "444")


def test_byte_parity_restart_markers():
    """Pillow restart_marker_rows=1 -> DRI = MCUs per row (80/16 = 5)."""
    img = synth_frame(64, 80)
    assert _ours(img, 75, "420", restart_interval=5) == \
        _pillow(img, 75, "420", restart_marker_rows=1)
    g = img[:, :, 1].copy()
    assert _ours(g, 75, "gray", restart_interval=10) == \
        _pillow(g, 75, "gray", restart_marker_rows=1)


@pytest.mark.parametrize("mode", ["420", "444", "gray"])
def test_byte_parity_optimized_huffman(mode):
    img = _frame(64, 80, mode)
    assert _ours(img, 75, mode, optimize=True) == \
        _pillow(img, 75, mode, optimize=True)


def test_byte_parity_optimized_with_restart_markers():
    img = synth_frame(47, 111)                     # 7 MCUs per row
    assert _ours(img, 80, "420", optimize=True, restart_interval=7) == \
        _pillow(img, 80, "420", optimize=True, restart_marker_rows=1)


@pytest.mark.parametrize("mode,kw", [
    ("420", {}), ("422", {"restart_interval": 3}),
    ("444", {"optimize": True}),
    ("gray", {"optimize": True, "restart_interval": 7})])
def test_files_equal_reference_api(mode, kw):
    img = _frame(61, 130, mode, seed=9)
    sub = "420" if mode == "gray" else mode
    assert _ours(img, 75, mode, **kw) == japi.encode(
        img, 75, sub, dct_method="islow", **kw)


def test_encode_batch_islow_equals_per_image():
    imgs = np.stack([synth_frame(47, 111, seed=7 + i) for i in range(3)]
                    + [np.random.default_rng(5).integers(
                        0, 256, (47, 111, 3), dtype=np.uint8)])
    outs = mesh.encode_batch(imgs, 75, dct_method="islow", device="cpu")
    assert outs == [_pillow(f, 75, "420") for f in imgs]
    assert outs == [_ours(f, 75, "420") for f in imgs]
    for kw in (dict(optimize=True), dict(restart_interval=7),
               dict(optimize=True, restart_interval=3)):
        outs = mesh.encode_batch(torch.from_numpy(imgs), 80,
                                 dct_method="islow", device="cpu", **kw)
        assert outs == [_ours(f, 80, "420", **kw) for f in imgs]
    g = np.ascontiguousarray(imgs[..., 1])
    assert mesh.encode_batch(g, 85, dct_method="islow", device="cpu") == \
        [_pillow(f, 85, "gray") for f in g]
