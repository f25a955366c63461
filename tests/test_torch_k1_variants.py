"""The two K1 variants this file covers, on the CPU through their plain
versions, against the JAX package's Pallas kernels in interpret mode on the
same numpy inputs (literal seeds):

(d) the repack variant (`_dense_kernel` in the reference): frames one MCU
    row past the reference's row gate go through its `_dense_kernel` branch;
    the port takes "repack" for the same frames. The reference multiplies by
    its dense operator, the port runs the shared per-block transform: the
    knife-edge policy of k1_dct.py:18-24 (|diff| <= 1 on at most
    max(1e-4, 2/size) of the coefficients). Against the reference's own
    path off the TPU, engine.pixels_to_scan, the wide frames give 0
    differing coefficients.
(e) the separable variant (`_color_kernel`): `color_plain` against the
    reference with its module switch `K1_DENSE` set to False at run time;
    the operators (`build_operators`, `_subsample_matrix`) exact, sc's rows
    equal to the scaled KDCT_ZZ rows the CUDA kernel multiplies by in its
    place, the coefficients under the same policy.

Also the selection rule, the explicit `variant=` argument, the wrapper's
device rule and what `tables_from_reference` carries across.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpgenc_tpu import api as japi
from jpgenc_tpu import engine as jeng
from jpgenc_tpu.container.parser import parse_jpeg
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.native import decode_scan
from jpgenc_tpu.ops.pallas import k1_dct as jk1
from jpgenc_tpu.ref.encoder import standard_tables
from jpgenc_tpu.utils.fixtures import synth_frame
from jpgenc_tpu_torch import api, engine
from jpgenc_tpu_torch.ops.cuda import k1_dct

torch.set_num_threads(1)

WIDE = [(16, 8208, "420"), (8, 8200, "444")]     # one MCU row past the gate
SMALL = [(40, 56, "420"), (24, 62, "422"), (16, 30, "444"), (61, 130, "420")]


def _knife_edge(ours, ref):
    d = np.abs(np.asarray(ours, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= max(1e-4, 2.0 / d.size)
    return int((d > 0).sum())


def _plan(h, w, sub, quality=75, dri=0):
    plan = engine.get_plan(h, w, sub, quality, "cpu", dri)
    return plan, (plan.layout, plan.kdct, plan.q)


# --- (d) the repack variant ---------------------------------------------------

@pytest.mark.parametrize("h,w,sub", WIDE)
def test_wide_frame_vs_dense_kernel_interpret(h, w, sub, monkeypatch):
    img = synth_frame(h, w, seed=31)
    lay = make_layout(h, w, sub, 0)
    ran = []
    real = jk1._dense_kernel
    monkeypatch.setattr(jk1, "_dense_kernel",
                        lambda *a: (ran.append(1), real(*a))[1])
    ref = np.asarray(jk1.fused_pixels_to_scan(
        jnp.asarray(img), lay, jeng.qtables_for_quality(75)[1],
        interpret=True))
    assert ran, "the reference did not take its _dense_kernel branch"
    plan, ops = _plan(h, w, sub)
    assert k1_dct.k1_variant(plan.layout) == "repack"
    zz = k1_dct.fused_pixels_to_scan(torch.from_numpy(img)[None], *ops)
    assert tuple(zz.shape) == (1,) + ref.shape and zz.dtype == torch.int16
    _knife_edge(zz[0].numpy(), ref)
    np.testing.assert_array_equal(zz[0].numpy(), np.asarray(
        jeng.pixels_to_scan(jnp.asarray(img), lay,
                            jeng.qtables_for_quality(75)[1])))


def test_mcu_bytes_is_the_reference_word_repack():
    """The port's MCU repack viewed as int32 equals mcu_pack_words: each
    MCU's bytes in memory order, what the repack kernel's loader reads."""
    from jpgenc_tpu.ops import color as jcolor
    for h, w, sub in [(40, 56, "420"), (24, 62, "422"), (16, 30, "444")]:
        img = synth_frame(h, w, seed=2)
        lay = make_layout(h, w, sub, 0)
        c0 = lay.comps[0]
        ref = np.asarray(jk1.mcu_pack_words(
            jcolor.pad_replicate(jnp.asarray(img), c0.plane_h, c0.plane_w),
            lay))
        ours = k1_dct.mcu_bytes(torch.from_numpy(img)[None], lay)[0]
        np.testing.assert_array_equal(
            ours.contiguous().numpy().view(np.int32), ref)


@pytest.mark.parametrize("h,w,sub", SMALL)
def test_variant_argument_runs_either_dense_variant_on_any_frame(h, w, sub):
    """rows and repack share one plain version: same values; the default is
    rows below the gate."""
    plan, ops = _plan(h, w, sub, dri=3)
    x = torch.from_numpy(np.stack([synth_frame(h, w, seed=s)
                                   for s in (1, 2)]))
    assert k1_dct.k1_variant(plan.layout) == "rows"
    rows = k1_dct.fused_pixels_to_scan(x, *ops, variant="rows")
    assert torch.equal(rows, k1_dct.fused_pixels_to_scan(x, *ops,
                                                         variant="repack"))
    assert torch.equal(rows, k1_dct.fused_pixels_to_scan(x, *ops))
    with pytest.raises(ValueError, match="variant"):
        k1_dct.fused_pixels_to_scan(x, *ops, variant="dense")


def test_row_gate_is_the_reference_gate():
    """4:2:0 switches past 8192 px, 4:4:4 past 8192 px, 4:2:2 past 16384."""
    for w, sub, want in [(8192, "420", "rows"), (8208, "420", "repack"),
                         (8192, "444", "rows"), (8200, "444", "repack"),
                         (16384, "422", "rows"), (16400, "422", "repack")]:
        lay = engine.L.make_layout(16, w, sub, 0)
        c0 = lay.comps[0]
        assert k1_dct.k1_variant(lay) == want
        assert (8 * c0.vs * lay.mcus_x * 128 * 4 <= (4 << 20)) == \
            (want == "rows")


def _coefficients(data):
    p = parse_jpeg(data)
    lay = make_layout(p.height, p.width, p.subsampling, p.restart_interval)
    return decode_scan(p.scan_data, lay, [c.dc_tab for c in p.comps],
                       [c.ac_tab for c in p.comps],
                       [p.dc_tables.get(i) for i in range(2)],
                       [p.ac_tables.get(i) for i in range(2)])


@pytest.mark.parametrize("optimize", [False, True])
def test_wide_frame_file_equals_reference(optimize):
    """A frame wider than 8192 px through api.encode: fused (K1A serves it)
    and optimize (pass 1 takes the repack variant)."""
    h, w = 16, 8208
    img = synth_frame(h, w, seed=5)
    before = k1_dct.plain_calls
    ours = api.encode(img, 75, optimize=optimize, device="cpu")
    assert k1_dct.plain_calls == before + int(optimize)
    ref = japi.encode(img, 75, optimize=optimize)
    if _knife_edge(_coefficients(ours), _coefficients(ref)) == 0:
        assert ours == ref


# --- (e) the separable variant ------------------------------------------------

@pytest.mark.parametrize("sub", ["420", "422", "444"])
def test_separable_operators_equal_reference(sub):
    lay = make_layout(32, 48, sub, 0)
    qt_host, qt_dev = jeng.qtables_for_quality(90)
    ref = [np.asarray(a) for a in jk1.build_operators(lay, qt_dev)]
    ours = k1_dct.build_operators(engine.L.make_layout(32, 48, sub, 0),
                                  qt_host)
    for a, b in zip(ours, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    c0 = lay.comps[0]
    nb = c0.hs * c0.vs
    np.testing.assert_array_equal(
        k1_dct._subsample_matrix(nb, c0.hs, c0.vs),
        jk1._subsample_matrix(nb, c0.hs, c0.vs))
    sep = k1_dct.separable_operator(*ours[:2])
    assert sep.shape == ((1 + nb) * 64, 64)
    np.testing.assert_array_equal(sep[:64], ref[0][:64, :64])
    np.testing.assert_array_equal(sep[64:], ref[1])
    # what tables_from_reference carries across
    jl = jeng.luts_from_tables(*standard_tables())
    t = engine.tables_from_reference(qt_host, np.asarray(jl.dc),
                                     np.asarray(jl.ac), separable=ref)
    np.testing.assert_array_equal(t["sep"].numpy(), sep)
    np.testing.assert_array_equal(t["q_out"].numpy(), ref[2].reshape(-1))
    np.testing.assert_array_equal(t["qnat"].numpy(), qt_host)
    assert t["qnat"].dtype == torch.int32
    plan = engine.EncodePlan(engine.L.make_layout(32, 48, sub, 0), t, "cpu")
    np.testing.assert_array_equal(plan.sep.numpy(), sep)
    np.testing.assert_array_equal(plan.q.numpy(), ref[2].reshape(-1))


def test_mcu_planar_is_the_reference_mcu_pack():
    from jpgenc_tpu.ops import color as jcolor
    for h, w, sub in [(40, 56, "420"), (24, 62, "422"), (16, 30, "444")]:
        img = synth_frame(h, w, seed=2)
        lay = make_layout(h, w, sub, 0)
        c0 = lay.comps[0]
        ref = np.asarray(jk1.mcu_pack(
            jcolor.pad_replicate(jnp.asarray(img), c0.plane_h, c0.plane_w),
            lay))
        ours = k1_dct.mcu_planar(torch.from_numpy(img)[None], lay)[0]
        np.testing.assert_array_equal(ours.reshape(ref.shape).numpy(), ref)


@pytest.mark.parametrize("sub", ["420", "422", "444"])
def test_separable_chroma_rows_are_scaled_kdct_rows(sub):
    """The separable kernel never reads sc: it multiplies each chroma sample,
    scaled by 1/(hs*vs), by row cpos(k) of KDCT_ZZ, cpos as
    csrc/common.cuh's plane_products computes it (4:4:4: block_products,
    cpos(k) = k). That is the reference's product exactly only if row k of
    sc is KDCT_ZZ[cpos(k)] * (1/(hs*vs)) bit for bit, as here."""
    lay = make_layout(32, 48, sub, 0)
    c0 = lay.comps[0]
    hs, vs = c0.hs, c0.vs
    k = np.arange(hs * vs * 64)
    if hs == 1:
        cpos = k
    else:
        blk, py, px = k >> 6, (k >> 3) & 7, k & 7
        cpos = ((blk >> 1) * (8 // vs) + py // vs) * 8 + (blk & 1) * 4 \
            + px // 2
    kdct = k1_dct._KDCT_ZZ
    want = kdct[cpos] * np.float32(1.0 / (hs * vs))
    assert want.dtype == np.float32
    ref_sc = np.asarray(jk1.build_operators(
        lay, jeng.qtables_for_quality(75)[1])[1])
    ours = k1_dct.build_operators(engine.L.make_layout(32, 48, sub, 0),
                                  jeng.qtables_for_quality(75)[0])
    sep = k1_dct.separable_operator(*ours[:2])
    for sc in (ref_sc, sep[64:], k1_dct._sep_on(hs, vs, "cpu")[64:].numpy()):
        np.testing.assert_array_equal(sc.view(np.uint32),
                                      want.view(np.uint32))
    np.testing.assert_array_equal(sep[:64].view(np.uint32),
                                  kdct.view(np.uint32))


def test_separable_tile_is_the_kernel_sources_default():
    """k1_dct.SEP_TILE, by which the tests size the separable kernel's tile
    edges, is the JPGENC_SEP_TILE that csrc/common.cuh compiles with."""
    import os
    import re

    from jpgenc_tpu_torch.kernels import build
    src = open(os.path.join(build._CSRC, "common.cuh")).read()
    tile = re.search(r"#define JPGENC_SEP_TILE (\d+)", src)
    assert tile and int(tile.group(1)) == k1_dct.SEP_TILE
    assert "static constexpr int T = JPGENC_SEP_TILE * 4 / NB;" in src


# every small frame at Q75 and Q95, and one 4:2:0 row of a separable tile
# and one MCU (the kernel's tile edge)
COLOR_CASES = [(q, h, w, sub) for q in (75, 95) for h, w, sub in
               SMALL + WIDE[:1]] + [(75, 16, 16 * k1_dct.SEP_TILE + 16,
                                     "420")]


@pytest.mark.parametrize("quality,h,w,sub", COLOR_CASES)
def test_color_plain_vs_color_kernel_interpret(h, w, sub, quality,
                                               monkeypatch):
    img = synth_frame(h, w, seed=13)
    lay = make_layout(h, w, sub, 0)
    monkeypatch.setattr(jk1, "K1_DENSE", False)
    ran = []
    real = jk1._color_kernel
    monkeypatch.setattr(jk1, "_color_kernel",
                        lambda *a, **k: (ran.append(1), real(*a, **k))[1])
    ref = np.asarray(jk1.fused_pixels_to_scan(
        jnp.asarray(img), lay, jeng.qtables_for_quality(quality)[1],
        interpret=True))
    assert ran, "the reference did not take its _color_kernel branch"
    plan, ops = _plan(h, w, sub, quality)
    x = torch.from_numpy(img)[None]
    zz = k1_dct.color_plain(x, plan.layout, plan.sep, plan.q)
    assert tuple(zz.shape) == (1,) + ref.shape and zz.dtype == torch.int16
    _knife_edge(zz[0].numpy(), ref)
    # and against the dense formulation, the policy the reference states
    _knife_edge(zz.numpy(), k1_dct.fused_pixels_to_scan(x, *ops).numpy())


def test_k1_dense_switch_selects_the_separable_variant(monkeypatch):
    plan, ops = _plan(40, 56, "420", dri=5)
    x = torch.from_numpy(synth_frame(40, 56, seed=4))[None]
    want = k1_dct.color_plain(x, plan.layout, plan.sep, plan.q)
    assert tuple(want.shape) == (1, 90, 64) and not want[:, 72:].any()
    assert torch.equal(k1_dct.fused_pixels_to_scan(
        x, *ops, variant="separable"), want)       # sep built for the layout
    monkeypatch.setattr(k1_dct, "K1_DENSE", False)
    assert k1_dct.k1_variant(plan.layout) == "separable"
    assert torch.equal(plan.zz_scan(x)[0], want)
    # a whole file through the switch: it decodes to these coefficients
    data = api.encode(x[0].numpy(), 75, restart_interval=5, optimize=True,
                      device="cpu")
    got = _coefficients(data)
    np.testing.assert_array_equal(got[plan.layout.scan_flat],
                                  want[0, :72].numpy())
    # gray has no colour variant: the switch changes nothing
    gplan, gops = _plan(40, 56, "gray")
    g = x[..., 1].contiguous()
    assert torch.equal(k1_dct.fused_pixels_to_scan(g, *gops),
                       k1_dct.pixels_to_scan_plain(g, *gops))


def test_variant_wrappers_take_the_plain_version_only_on_cpu():
    plan, ops = _plan(16, 32, "420")
    x = torch.from_numpy(synth_frame(16, 32))[None]
    for variant in k1_dct.VARIANTS:
        before = (k1_dct.launches, k1_dct.launches_repack,
                  k1_dct.launches_color, k1_dct.plain_calls)
        k1_dct.fused_pixels_to_scan(x, *ops, variant=variant, sep=plan.sep)
        assert (k1_dct.launches, k1_dct.launches_repack,
                k1_dct.launches_color, k1_dct.plain_calls) == \
            before[:3] + (before[3] + 1,)
        with pytest.raises(ValueError, match="unsupported device"):
            k1_dct.fused_pixels_to_scan(x.to("meta"), *ops, variant=variant,
                                        sep=plan.sep)
