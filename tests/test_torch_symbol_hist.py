"""The symbol histogram's wrapper (`ops/cuda/symbol_hist.py`) on the CPU: a
CPU tensor takes the plain version, which equals
`jpgenc_tpu.ops.entropy.symbol_histogram` exactly; the operand checks run
before the device branch; and the constants the wrapper mirrors are the
kernel source's. The kernel itself is held against the plain version in the
GPU lane (tests/test_torch_gpu.py).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpgenc_tpu import engine as jeng
from jpgenc_tpu.ops.entropy import symbol_histogram as jax_histogram
from jpgenc_tpu_torch.kernels import build
from jpgenc_tpu_torch.ops import entropy
from jpgenc_tpu_torch.ops.cuda import block_pack, symbol_hist

from test_torch_block_pack import LAYOUTS, _plan_tensors, _setup

torch.set_num_threads(1)


def _operands(h=40, w=56, mode="420", dri=5, n_img=2):
    lay, sp, zz = _setup(h, w, mode, dri, n_img=n_img, seed=7)
    zt = torch.from_numpy(zz)
    dcdiff = block_pack.slot_metadata(
        torch.from_numpy(sp.prev_same.astype(np.int64)), zt)
    return lay, zz, (zt, dcdiff, *_plan_tensors(sp))


@pytest.mark.parametrize("h,w,mode,dri", LAYOUTS + [(32, 48, "422", 0)])
def test_cpu_tensor_takes_the_plain_version(h, w, mode, dri):
    lay, zz, args = _operands(h, w, mode, dri, n_img=3)
    before = (symbol_hist.launches, symbol_hist.plain_calls)
    hist = entropy.symbol_histogram(*args)
    assert (symbol_hist.launches, symbol_hist.plain_calls) == \
        (before[0], before[1] + 1)
    assert hist.dtype == torch.int32 and tuple(hist.shape) == (3, 2, 2, 256)
    assert torch.equal(hist, symbol_hist.histogram_plain(*args))
    jp = jeng.make_symbol_plan(lay)
    for i in range(3):
        ref = np.asarray(jax_histogram(jnp.asarray(zz[i].astype(np.int32)),
                                       jp))
        np.testing.assert_array_equal(hist[i].numpy(), ref)


def test_operands_are_checked_before_the_device_branch():
    _, _, (zz, dcdiff, actab, dctab, valid) = _operands()
    plan = (actab, dctab, valid)
    with pytest.raises(ValueError, match="expected"):
        symbol_hist.fused_symbol_histogram(zz.to(torch.int32), dcdiff, *plan)
    with pytest.raises(ValueError, match="expected"):
        symbol_hist.fused_symbol_histogram(zz[:, :-1], dcdiff, *plan)
    with pytest.raises(ValueError, match="expected"):
        symbol_hist.fused_symbol_histogram(zz[..., :32], dcdiff, *plan)
    with pytest.raises(ValueError, match="expected"):
        symbol_hist.fused_symbol_histogram(zz, dcdiff[:1], *plan)
    with pytest.raises(ValueError, match="expected"):
        symbol_hist.fused_symbol_histogram(zz, dcdiff.to(torch.int64), *plan)
    with pytest.raises(ValueError, match="expected"):
        symbol_hist.fused_symbol_histogram(zz, dcdiff, actab[:-1], dctab,
                                           valid)
    with pytest.raises(ValueError, match="expected"):
        symbol_hist.fused_symbol_histogram(zz, dcdiff, actab, dctab,
                                           valid.bool())
    with pytest.raises(ValueError, match="unsupported device"):
        symbol_hist.fused_symbol_histogram(
            *(t.to("meta") for t in (zz, dcdiff, actab, dctab, valid)))
    calls = symbol_hist.plain_calls
    with pytest.raises(ValueError, match="expected"):
        entropy.symbol_histogram(zz.to("meta"), dcdiff, *plan)
    assert symbol_hist.plain_calls == calls


def test_constants_are_the_kernel_sources():
    """TABLES and BINS (the output's last two dimensions) and TILE (the
    slots a thread block counts, by which the GPU lane sizes its ragged
    cases) are csrc/symbol_hist.cu's; its launcher is in build.SIGNATURES
    with its nine arguments."""
    src = open(os.path.join(build._CSRC, "symbol_hist.cu")).read()
    for name, value in (("kSlots", symbol_hist.TILE),
                        ("kBins", symbol_hist.BINS),
                        ("kTables", symbol_hist.TABLES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert len(build.SIGNATURES["symbol_hist_launch"]) == 9
    assert "extern \"C\" int symbol_hist_launch(" in src
