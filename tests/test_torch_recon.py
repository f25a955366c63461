"""The port's reconstruction (ops/cuda/recon.py, ops/transform.py,
ops/color.py) against the JAX package on the CPU.

The same random coefficient tensors and quant tables, made with numpy from
literal seeds, go through `recon_plain` (the plain version every CUDA kernel
of csrc/recon.cu is held against on the card), through the reference's jnp
reconstruction `decoder.pixel_fn`, through its Pallas kernel in interpret
mode, and through the float64 anchor `ref.decoder.reconstruct_ref`.

Tolerances: the three float32 versions reassociate one 64-term sum, so they
agree except where a value lands within an ulp of a rounding boundary:
max |diff| <= 1 on fewer than 1e-3 of the bytes
(tests/test_pallas_recon.py:24-30). Against float64 the limit is the
reference's own, max |diff| <= 3 (two roundings in a row).
"""
import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpgenc_tpu.decoder as JD
from jpgenc_tpu.layout import make_layout as j_make_layout
from jpgenc_tpu.ops import color as JC
from jpgenc_tpu.ops import transform as JX
from jpgenc_tpu.ops.pallas import recon as jrecon
from jpgenc_tpu.ref.decoder import reconstruct_ref as j_reconstruct_ref
from jpgenc_tpu_torch import decoder as D
from jpgenc_tpu_torch.layout import make_layout
from jpgenc_tpu_torch.ops import color as C
from jpgenc_tpu_torch.ops import transform as X
from jpgenc_tpu_torch.ops.cuda import recon
from jpgenc_tpu_torch.ref.decoder import reconstruct_ref

# (sampling, h, w, coefficient amplitude): the grid of
# tests/test_pallas_recon.py:39-43 without its 257 x 1920 case, gray, and
# one case whose samples overshoot [0, 255] so that the range limit matters
CASES = [("420", 32, 128, 30), ("420", 61, 128, 30), ("420", 64, 130, 30),
         ("422", 16, 128, 30), ("422", 47, 250, 30), ("444", 100, 64, 30),
         ("gray", 61, 130, 30), ("gray", 64, 72, 30), ("420", 48, 64, 300),
         ("422", 24, 40, 300)]
IDS = [f"{s}-{h}x{w}-a{a}" for s, h, w, a in CASES]


def _parity(out, ref, max_frac=1e-3):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.uint8
    d = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1, f"max diff {d.max()}"
    frac = (d > 0).sum() / d.size
    assert frac < max_frac, f"mismatch fraction {frac}"


@functools.lru_cache(maxsize=None)
def _case(sub, h, w, amp):
    """(layout, blocks [n_total, 64] int32, qts, x4, q_rows, recon_plain's
    pixels) for one case, from a seed derived from its name."""
    lay = make_layout(h, w, sub)
    n_total = sum(c.n_blocks for c in lay.comps)
    rng = np.random.default_rng(zlib.crc32(f"{sub}-{h}-{w}-{amp}".encode()))
    blocks = rng.integers(-amp, amp, (n_total, 64)).astype(np.int32)
    qts = [np.clip(rng.integers(1, 40, 64), 1, 255).astype(np.int32)
           for _ in lay.comps]
    x4, q_rows = D.coefficients_from_reference(lay, blocks, qts)
    out = recon.recon_plain(x4, q_rows, lay)[0].numpy()
    return lay, blocks, qts, x4, q_rows, out


@pytest.mark.parametrize("sub,h,w,amp", CASES, ids=IDS)
def test_recon_plain_vs_reference_pixel_fn(sub, h, w, amp):
    lay, blocks, qts, _, _, out = _case(sub, h, w, amp)
    ref = np.asarray(JD.pixel_fn(j_make_layout(h, w, sub))(
        jnp.asarray(blocks), [jnp.asarray(q) for q in qts]))
    if amp > 255:
        assert ref.min() == 0 and ref.max() == 255     # the limit matters
    _parity(out, ref)


@pytest.mark.parametrize("sub,h,w,amp", CASES, ids=IDS)
def test_recon_plain_vs_pallas_kernel_interpreted(sub, h, w, amp):
    lay, _, _, x4, q_rows, out = _case(sub, h, w, amp)
    jlay = j_make_layout(h, w, sub)
    assert jrecon.recon_applicable(jlay) and recon.recon_applicable(lay)
    ref = np.asarray(jrecon.fused_recon_rgb(
        jnp.asarray(x4.numpy()), jnp.asarray(q_rows.numpy()), jlay,
        interpret=True))[0]
    _parity(out, ref)


@pytest.mark.parametrize("sub,h,w,amp", CASES, ids=IDS)
def test_recon_plain_vs_float64(sub, h, w, amp):
    lay, blocks, qts, _, _, out = _case(sub, h, w, amp)
    for ref in (reconstruct_ref(lay, blocks, qts),
                j_reconstruct_ref(j_make_layout(h, w, sub), blocks, qts)):
        d = np.abs(out.astype(np.int64) - ref.astype(np.int64))
        assert out.shape == ref.shape and d.max() <= 3, d.max()


@pytest.mark.parametrize("sub,h,w,amp", CASES[:1] + CASES[3:4] + CASES[6:7],
                         ids=IDS[:1] + IDS[3:4] + IDS[6:7])
def test_wrapper_on_a_cpu_tensor_is_the_plain_version(sub, h, w, amp):
    lay, _, _, x4, q_rows, out = _case(sub, h, w, amp)
    before = (recon.plain_calls, recon.launches, recon.launches_gray)
    got = recon.fused_recon_rgb(x4, q_rows, lay)
    assert (recon.plain_calls, recon.launches, recon.launches_gray) == \
        (before[0] + 1, before[1], before[2])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got[0].numpy(), out)


@pytest.mark.parametrize("sub,h,w", [("420", 61, 130), ("422", 47, 58),
                                     ("444", 20, 24), ("gray", 33, 17)])
def test_batched_reconstruction_equals_per_image(sub, h, w):
    """A batch with one quant row per image gives each image's own
    pixels."""
    lay = make_layout(h, w, sub)
    n_total = sum(c.n_blocks for c in lay.comps)
    rng = np.random.default_rng(41)
    blocks = rng.integers(-40, 40, (3, n_total, 64)).astype(np.int32)
    qts = [rng.integers(1, 30, (3, 64)).astype(np.int32) for _ in lay.comps]
    x4, q_rows = D.coefficients_from_reference(lay, blocks, qts)
    assert x4.shape[0] == q_rows.shape[0] == 3
    out = recon.recon_plain(x4, q_rows, lay)
    for i in range(3):
        xi, qi = D.coefficients_from_reference(lay, blocks[i],
                                               [q[i] for q in qts])
        np.testing.assert_array_equal(
            out[i].numpy(), recon.recon_plain(xi, qi, lay)[0].numpy())
        np.testing.assert_array_equal(
            out[i].numpy(),
            D.pixel_fn(lay)(torch.from_numpy(blocks[i]),
                            [torch.from_numpy(q[i]) for q in qts]).numpy())


@pytest.mark.parametrize("h,w,sub,dri,takes", [
    (64, 64, "gray", 0, True), (64, 130, "420", 0, True),
    (3024, 4032, "420", 0, True), (64, 72, "gray", 0, True),
    (47, 250, "422", 3, True), (9, 9, "444", 0, True),
    (64, 96, "411", 0, False), (61, 64, "440", 0, False),
    (48, 64, "410", 0, False)])
def test_recon_applicable_gate(h, w, sub, dri, takes):
    """A static function of the layout: gray and the three encoder
    samplings at any size take the kernel, the rarer samplings do not (as
    in the reference, whose extra VMEM limit is a TPU model)."""
    lay = make_layout(h, w, sub, dri)
    assert recon.recon_applicable(lay) is takes
    if not takes:
        assert not jrecon.recon_applicable(j_make_layout(h, w, sub, dri))
        x4 = torch.zeros((1, lay.mcus_y, lay.mcus_x,
                          lay.blocks_per_mcu * 64), dtype=torch.int16)
        with pytest.raises(ValueError, match="no reconstruction kernel"):
            recon.check_operands(x4, torch.ones((1, x4.shape[-1])), lay)


@pytest.mark.parametrize("what", ["dtype", "shape", "strides", "q_shape",
                                  "q_dtype", "device", "misaligned"])
def test_wrapper_rejects_what_the_kernel_does_not_take(what):
    lay = make_layout(32, 48, "420")
    x4 = torch.zeros((2, 2, 3, 384), dtype=torch.int16)
    q = torch.ones((2, 384))
    if what == "dtype":
        x4 = x4.to(torch.int32)
    elif what == "shape":
        x4 = x4[:, :, :2].contiguous()
    elif what == "strides":
        x4 = torch.zeros((2, 2, 384, 3), dtype=torch.int16).transpose(2, 3)
    elif what == "q_shape":
        q = q[:1]
    elif what == "q_dtype":
        q = q.double()
    elif what == "misaligned":          # contiguous, but 2 bytes past 16
        x4 = torch.zeros(x4.numel() + 1, dtype=torch.int16)[1:].view(
            x4.shape)
        assert x4.is_contiguous() and x4.data_ptr() % 16
    if what == "device":
        with pytest.raises(ValueError, match="unsupported device"):
            recon.fused_recon_rgb(x4.to("meta"), q.to("meta"), lay)
    else:
        with pytest.raises(ValueError):
            recon.check_operands(x4, q, lay)


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (2, 2), (4, 1), (1, 2),
                                   (4, 2)])
def test_upsamples_equal_reference(hs, vs):
    """Samples are integers in [0, 255] and the weights are 3/4 and 1/4, so
    the triangle filter is exact in float32: bit equality."""
    a = np.random.default_rng(5).integers(0, 256, (3, 16, 24)) \
        .astype(np.float32)
    for fn, ref in ((C.upsample_fancy, JC.upsample_fancy),
                    (C.upsample, JC.upsample)):
        got = fn(torch.from_numpy(a), hs, vs).numpy()
        assert got.shape == (3, 16 * vs, 24 * hs)
        for i in range(3):
            np.testing.assert_array_equal(
                got[i], np.asarray(ref(jnp.asarray(a[i]), hs, vs)))


def test_ycbcr_to_rgb_equals_reference():
    ycc = np.random.default_rng(6).uniform(0, 255, (40, 50, 3)) \
        .astype(np.float32)
    ycc[..., 1:] = np.round(ycc[..., 1:] * 4) / 4
    np.testing.assert_array_equal(
        C.ycbcr_to_rgb(torch.from_numpy(ycc)).numpy(),
        np.asarray(JC.ycbcr_to_rgb(jnp.asarray(ycc))))


@pytest.mark.parametrize("h,w", [(8, 8), (16, 40), (64, 24)])
def test_deblockify_and_zigzag_to_plane_equal_reference(h, w):
    rng = np.random.default_rng(7)
    n = (h // 8) * (w // 8)
    blocks = rng.normal(0, 1, (2, n, 8, 8)).astype(np.float32)
    got = X.deblockify(torch.from_numpy(blocks), h, w).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], np.asarray(JX.deblockify(jnp.asarray(blocks[i]), h, w)))
    zz = rng.integers(-50, 50, (2, n, 64)).astype(np.int32)
    q = rng.integers(1, 40, (2, 64)).astype(np.int32)
    plane = X.zigzag_to_plane(torch.from_numpy(zz), torch.from_numpy(q),
                              h, w).numpy()
    for i in range(2):
        ref = np.asarray(JX.zigzag_to_plane(jnp.asarray(zz[i]),
                                            jnp.asarray(q[i]), h, w))
        np.testing.assert_allclose(plane[i], ref, rtol=0, atol=2e-3)


def test_build_compiles_recon_and_names_the_library_by_its_sources(
        tmp_path, monkeypatch):
    """kernels/build.py compiles every csrc/*.cu, recon.cu among them, and
    the library's name follows the sources: a new or a changed file gives
    another name, so a library built without it is never loaded."""
    import shutil

    from jpgenc_tpu_torch.kernels import build
    names = [p.rsplit("/", 1)[-1] for p in build._sources()]
    assert "recon.cu" in names and "k1a_fused.cu" in names
    assert {"recon_launch", "recon_gray_launch"} <= set(build.SIGNATURES)
    assert len(build.SIGNATURES["recon_launch"]) == 12
    assert len(build.SIGNATURES["recon_gray_launch"]) == 10
    src = tmp_path / "csrc"
    shutil.copytree(build._CSRC, src)
    monkeypatch.setattr(build, "_CSRC", str(src))
    whole = build.library_path()
    (src / "recon.cu").write_text((src / "recon.cu").read_text() + "\n// x\n")
    changed = build.library_path()
    (src / "recon.cu").unlink()
    without = build.library_path()
    assert len({whole, changed, without}) == 3


def _product_terms_numpy(x4, layout):
    """product_terms counted block by block with loops: a tile's blocks in
    scan order, 8 to a warp, each warp's terms 4 for every nibble of k that
    holds a nonzero coefficient of one of its blocks."""
    b, my, mx, lanes = x4.shape
    nb2 = lanes // 64
    tile = recon.GRAY_TILE if layout.is_gray else recon.TILE
    nz = x4.reshape(b, my, mx, nb2, 64) != 0
    terms_sum = fmas = 0
    for img in range(b):
        for i in range(my):
            for x0 in range(0, mx, tile):
                blocks = [nz[img, i, m, k] for m in range(x0, min(x0 + tile, mx))
                          for k in range(nb2)]
                for w0 in range(0, len(blocks), recon.WARP_BLOCKS):
                    warp = blocks[w0:w0 + recon.WARP_BLOCKS]
                    union = np.logical_or.reduce(warp)
                    n = 4 * sum(union[k:k + 4].any() for k in range(0, 64, 4))
                    terms_sum += n * len(warp)
                    fmas += n * recon.WARP_BLOCKS * 64
    n_blocks = b * my * mx * nb2
    return {"nonzero_frac": int(nz.sum()) / (n_blocks * 64),
            "terms_per_block": int(nz.sum()) / n_blocks,
            "terms_per_sample": terms_sum / n_blocks, "fmas": fmas}


@pytest.mark.parametrize("sub,h,w,density", [
    ("420", 61, 130, 0.05), ("420", 16, 272, 0.5), ("422", 47, 250, 0.02),
    ("444", 9, 71, 0.1), ("gray", 61, 130, 0.03), ("gray", 17, 520, 1.0)])
def test_product_terms_counts_like_numpy(sub, h, w, density):
    """The helper that reports the kernels' product terms equals a count
    made block by block, on sparse inputs with widths that are not a
    multiple of the tile and on an input with every coefficient set."""
    lay = make_layout(h, w, sub)
    lanes = lay.blocks_per_mcu * 64
    rng = np.random.default_rng(int(density * 1000) + h + w)
    x4 = (rng.integers(-5, 6, (2, lay.mcus_y, lay.mcus_x, lanes))
          * (rng.random((2, lay.mcus_y, lay.mcus_x, lanes)) < density)
          ).astype(np.int16)
    if density == 1.0:
        x4[x4 == 0] = 1
    got = recon.product_terms(torch.from_numpy(x4), lay)
    want = _product_terms_numpy(x4, lay)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 <= got["terms_per_block"] <= got["terms_per_sample"] <= 64
    if density == 1.0:
        assert got["terms_per_sample"] == 64 and got["nonzero_frac"] == 1


def test_tiles_are_the_kernel_sources_defaults():
    """recon.TILE and GRAY_TILE, which product_terms mirrors, are the
    defaults csrc/recon.cu compiles with."""
    import os
    import re

    from jpgenc_tpu_torch.kernels import build
    src = open(os.path.join(build._CSRC, "recon.cu")).read()
    tiles = dict(re.findall(r"#define (JPGENC_RECON_\w*TILE) (\d+)", src))
    assert int(tiles["JPGENC_RECON_TILE"]) == recon.TILE
    assert int(tiles["JPGENC_RECON_GRAY_TILE"]) == recon.GRAY_TILE


@pytest.mark.parametrize("lanes", [64, 256, 384])
def test_dense_coefficients_fixture(lanes):
    """Every coefficient nonzero, |value| 1..3, quant 4..12, deterministic
    in its seed; the plain reconstruction of it stays off the clamps."""
    from jpgenc_tpu_torch.utils import fixtures
    x4, qts = fixtures.dense_coefficients(2, 3, 5, lanes, 11)
    assert x4.shape == (2, 3, 5, lanes) and x4.dtype == np.int16
    assert qts.shape == (2, 64) and qts.min() >= 4 and qts.max() <= 12
    assert (x4 != 0).all() and np.abs(x4).max() <= 3
    again = fixtures.dense_coefficients(2, 3, 5, lanes, 11)
    assert np.array_equal(again[0], x4) and np.array_equal(again[1], qts)
    sub = {64: "gray", 256: "422", 384: "420"}[lanes]
    lay = make_layout(3 * 8 * (2 if sub == "420" else 1),
                      5 * 8 * (1 if sub == "gray" else 2), sub)
    per_comp = [qts[0]] if sub == "gray" else [qts[0], qts[1], qts[1]]
    q_rows = np.repeat(D._q_rows(lay, per_comp), 2, axis=0)
    px = recon.recon_plain(torch.from_numpy(x4), torch.from_numpy(q_rows),
                           lay)
    assert float(((px == 0) | (px == 255)).double().mean()) < 0.01
    blocks = np.empty((lay.n_scan, 64), np.int32)
    blocks[np.asarray(lay.scan_flat)] = x4[1].reshape(-1, 64)
    ref = reconstruct_ref(lay, blocks, per_comp)
    assert np.abs(px[1].numpy().astype(int) - ref.astype(int)).max() <= 3
