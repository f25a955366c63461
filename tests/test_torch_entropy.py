"""The port's symbol histogram (`ops/entropy.symbol_histogram`, torch ops)
against `jpgenc_tpu.ops.entropy.symbol_histogram`, on the same synthetic
coefficients made from literal seeds. Counting is integer work: the
tolerance is exact, including the ZRL multiplicity (one 0xF0 per 16 zeros of
a run), the EOB counts, the per-image split and valid == 0 padding slots;
and the numpy reference encoder's loop-level count agrees on real
coefficients.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpgenc_tpu import engine as jeng
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops.entropy import symbol_histogram as jax_histogram
from jpgenc_tpu.utils.fixtures import synth_frame
from jpgenc_tpu_torch import engine
from jpgenc_tpu_torch.ops import entropy
from jpgenc_tpu_torch.ops.cuda import block_pack
from jpgenc_tpu_torch.ref import encoder as ref_encoder

from test_torch_block_pack import LAYOUTS, _plan_tensors, _setup

torch.set_num_threads(1)


def _ours(sp, zz):
    zt = torch.from_numpy(zz)
    dcdiff = block_pack.slot_metadata(
        torch.from_numpy(sp.prev_same.astype(np.int64)), zt)
    return entropy.symbol_histogram(zt, dcdiff, *_plan_tensors(sp))


@pytest.mark.parametrize("h,w,mode,dri", LAYOUTS + [(32, 48, "422", 0)])
def test_histogram_equals_reference(h, w, mode, dri):
    lay, sp, zz = _setup(h, w, mode, dri, n_img=3, seed=5)
    hist = _ours(sp, zz)
    assert hist.dtype == torch.int32 and tuple(hist.shape) == (3, 2, 2, 256)
    jp = jeng.make_symbol_plan(lay)
    for i in range(3):
        ref = np.asarray(jax_histogram(jnp.asarray(zz[i].astype(np.int32)),
                                       jp))
        np.testing.assert_array_equal(hist[i].numpy(), ref)
    assert int(hist[:, 1, :, 0xF0].sum()) > 0       # ZRLs were counted
    if lay.is_gray:
        assert int(hist[:, :, 1].sum()) == 0        # one table only


def test_long_zero_runs_count_their_zrls():
    """A lone coefficient at zigzag 63 after 62 zeros: three ZRLs (48 zeros)
    and run 14; a block with a zero tail counts one EOB, a full one none."""
    lay = make_layout(8, 24, "gray", 0)
    sp = engine.make_symbol_plan(lay)
    zz = np.zeros((1, 3, 64), np.int16)
    zz[0, 0, 63] = 5
    zz[0, 1, 1:] = 1
    zz[0, 2, 17] = -2
    hist = _ours(sp, zz)[0].numpy()
    assert hist[1, 0, 0xF0] == 3 + 1                # block 0: 3, block 2: 1
    assert hist[1, 0, (14 << 4) | 3] == 1
    assert hist[1, 0, (0 << 4) | 2] == 1            # run 16 -> ZRL + run 0
    assert hist[1, 0, 0x01] == 63
    assert hist[1, 0, 0x00] == 1                    # only block 2 has an EOB
    assert hist[0, 0, 0] == 3                       # three zero DC diffs


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_plan_pass1_histogram_equals_ref_encoder(mode):
    """EncodePlan.zz_and_histogram on real pixels against the numpy
    reference encoder's symbol_histogram of the same coefficients."""
    img = synth_frame(40, 56, seed=3)
    img = img[..., 1].copy() if mode == "gray" else img
    plan = engine.get_plan(40, 56, mode, 75, "cpu")
    zz, _, hist = plan.zz_and_histogram(torch.from_numpy(img)[None])
    lay = plan.layout
    raster = np.empty((lay.n_scan, 64), np.int32)
    raster[lay.scan_flat] = zz[0].numpy()
    np.testing.assert_array_equal(hist[0].numpy(),
                                  ref_encoder.symbol_histogram(lay, raster))
