"""K1's plain version in the port (`ops/cuda/k1_dct.fused_pixels_to_scan` on
CPU tensors, colour and gray) against the JAX package, on the same numpy
inputs made from literal seeds.

- vs `jpgenc_tpu.ops.pallas.k1_dct.fused_pixels_to_scan(interpret=True)`, the
  Pallas K1 kernels run as the JAX package's own CPU tests run them: both
  sides are the same f32 operator (dense for colour, KDCT_ZZ for gray) and
  the same divide-then-round, summed by two matmul libraries in their own
  orders, so the tolerance is the knife-edge policy of k1_dct.py:18-24
  (|diff| <= 1 on at most max(1e-4, 2/size) of the coefficients); the
  sizes here measured zero differing coefficients;
- vs `jpgenc_tpu.engine.pixels_to_scan` (the separable jnp path): the same
  policy;
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
        torch.from_numpy(imgs), plan.layout, plan.m, plan.bias, plan.q)


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


@pytest.mark.parametrize("h,w,mode,quality", CASES)
def test_k1_plain_vs_engine_pixels_to_scan(h, w, mode, quality):
    img = _image(h, w, mode, seed=11)
    _, zz = _ours(img[None], mode, quality)
    ref = np.asarray(jeng.pixels_to_scan(
        jnp.asarray(img), make_layout(h, w, mode, 0),
        jeng.qtables_for_quality(quality)[1]))
    _knife_edge(zz[0].numpy(), ref)


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_k1_batch_is_per_image(mode):
    imgs = np.stack([_image(24, 40, mode, seed=s) for s in (1, 2, 3)])
    _, zz = _ours(imgs, mode, 75)
    for i in range(3):
        assert torch.equal(zz[i], _ours(imgs[i:i + 1], mode, 75)[1][0])


def test_k1_wrapper_takes_plain_version_only_on_cpu():
    img = torch.from_numpy(_image(16, 16, "420"))[None]
    plan = engine.get_plan(16, 16, "420", 75, "cpu")
    ops = (plan.layout, plan.m, plan.bias, plan.q)
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
    zz3 = k1_dct.fused_pixels_to_scan(img3, plan3.layout, plan3.m, plan3.bias,
                                      plan3.q)
    assert tuple(zz3.shape) == (1, 24, 64) and plan3.layout.n_scan == 18
    assert not zz3[:, 18:].any() and zz3[:, :18].any()
