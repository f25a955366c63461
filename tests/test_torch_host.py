"""The port's copies of the reference's host tier equal their originals.

The port imports nothing of `jpgenc_tpu`, so it keeps its own copy of every
host module it needs (tables, layout, huffman, config, container, native,
ref, utils.fixtures) and of the helpers it took out of JAX-importing modules
(ops/pack, engine, ops/transform, ops/color, ops/pallas/k1_dct,
ops/pallas/block_pack). Each copy is pinned here against the original on
the same inputs: this file is where the two packages meet.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpgenc_tpu
import jpgenc_tpu_torch
from jpgenc_tpu import engine as jeng
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.ops import pack as jpack
from jpgenc_tpu.ref.encoder import standard_tables
from jpgenc_tpu_torch import engine as teng
from jpgenc_tpu_torch.ops import pack as tpack

LAYOUTS = [(1080, 1920, "420", 0), (120, 136, "420", 0), (64, 126, "422", 0),
           (48, 62, "444", 0), (120, 120, "420", 3), (100, 64, "gray", 3),
           (2160, 3840, "422", 8)]


def test_kdct_zz_and_rounding():
    from jpgenc_tpu.ops.transform import _KDCT_ZZ, round_half_away
    from jpgenc_tpu_torch.ops import transform as tt
    np.testing.assert_array_equal(tt._KDCT_ZZ, _KDCT_ZZ)
    x = np.array([0.5, -0.5, 1.5, -1.5, 0.49999997, -0.49999997, 2.4999998,
                  -0.0, 0.0, 445.49994, -1023.5, 7.0], np.float32)
    x = np.concatenate([x, np.random.default_rng(0).normal(0, 50, 4096)
                        .astype(np.float32)])
    np.testing.assert_array_equal(
        tt.round_half_away(torch.from_numpy(x)).numpy(),
        np.asarray(round_half_away(jnp.asarray(x))))


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("basis", ["byte_slot", "row_major"])
def test_dense_operator_equals_reference(hs, vs, basis):
    from jpgenc_tpu.ops.pallas.k1_dct import _dense_operator as ref
    from jpgenc_tpu_torch.ops.cuda.k1_dct import _dense_operator
    m, b = _dense_operator(hs, vs, basis)
    rm, rb = ref(hs, vs, basis)
    np.testing.assert_array_equal(m, rm)
    np.testing.assert_array_equal(b, rb)


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (2, 2)])
def test_natural_basis_is_a_row_permutation(hs, vs):
    """The natural byte order basis holds row_major's f32 values, row
    (r*4 + kb)*wpr + j moved to r*4*wpr + 4*j + kb."""
    from jpgenc_tpu.ops.pallas.k1_dct import _dense_operator as ref
    from jpgenc_tpu_torch.ops.cuda.k1_dct import _dense_operator
    m, b = _dense_operator(hs, vs, "natural")
    rm, rb = ref(hs, vs, "row_major")
    wpr = 8 * hs * 3 // 4
    perm = np.empty(m.shape[0], np.int64)
    for r in range(8 * vs):
        for j in range(wpr):
            for kb in range(4):
                perm[r * 4 * wpr + 4 * j + kb] = (r * 4 + kb) * wpr + j
    np.testing.assert_array_equal(m, rm[perm])
    np.testing.assert_array_equal(b, rb)


def test_packed_tables_and_luts_equal_reference():
    from jpgenc_tpu.ops.pallas.block_pack import packed_tables as ref_pt
    from jpgenc_tpu_torch.ops.cuda.block_pack import packed_tables
    dc_t, ac_t = standard_tables()
    jl = jeng.luts_from_tables(dc_t, ac_t)
    tl = teng.luts_from_tables(dc_t, ac_t)
    np.testing.assert_array_equal(tl.dc, np.asarray(jl.dc))
    np.testing.assert_array_equal(tl.ac, np.asarray(jl.ac))
    one = teng.luts_from_tables(dc_t[:1], ac_t[:1])       # one table set
    np.testing.assert_array_equal(one.ac,
                                  np.asarray(jeng.luts_from_tables(
                                      dc_t[:1], ac_t[:1]).ac))
    ours = packed_tables(tl)
    theirs = ref_pt(jl)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).reshape(-1)
                                      if a.dim() == 1 else np.asarray(b))


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 81, 90, 91, 95, 96, 100])
def test_quality_helpers(quality):
    np.testing.assert_array_equal(teng.qtables_for_quality(quality),
                                  jeng.qtables_for_quality(quality)[0])
    assert tpack.w_blk_for_quality(quality) == jpack.w_blk_for_quality(quality)


def test_pack_constants_and_alignment():
    assert tpack.MAX_BLOCK_BITS == jpack.MAX_BLOCK_BITS
    for spb in (1, 6, 15, 16, 63, 64, 255, 256, 48960):
        assert tpack.walign_for(spb) == jpack.walign_for(spb)
        assert tpack.words_per_segment(spb) == jpack.words_per_segment(spb)
    bits = np.arange(0, 5000, 7, dtype=np.int64)
    for wal in (8, 16, 32, 64):
        np.testing.assert_array_equal(tpack.seg_nwords_aligned(bits, wal),
                                      jpack.seg_nwords_aligned(bits, wal))
        assert tpack.seg_nwords_aligned(12345, wal) == \
            jpack.seg_nwords_aligned(12345, wal)


@pytest.mark.parametrize("h,w,sub,dri", LAYOUTS)
def test_scan_caps_over_layouts_and_tiers(h, w, sub, dri):
    lay = make_layout(h, w, sub, dri)
    for tier in ("tight", "safe", "worst"):
        for q in (10, 75, 85, 92, 93, 100):
            assert teng.scan_caps(lay, q, tier) == jeng.scan_caps(lay, q, tier)


def test_tiers_follow_the_reference_ladder():
    """api.py:51-55: tight -> safe with max(w, 24) -> worst with 56,
    duplicates dropped."""
    lay = make_layout(120, 136, "420", 0)
    for q in (50, 75, 90, 95, 100):
        w = jpack.w_blk_for_quality(q)
        ref = [(jeng.scan_caps(lay, q, "tight")[0], w),
               (jeng.scan_caps(lay, q, "safe")[0], max(w, 24)),
               (jeng.scan_caps(lay, q, "worst")[0], 56)]
        ref = [t for i, t in enumerate(ref) if t not in ref[:i]]
        assert teng.tiers_for(lay, q) == ref


def test_pad_replicate_equals_reference():
    from jpgenc_tpu.ops.color import pad_replicate as ref
    from jpgenc_tpu_torch.ops.color import pad_replicate
    img = np.random.default_rng(3).integers(0, 256, (13, 21, 3), np.uint8)
    out = pad_replicate(torch.from_numpy(img)[None], 16, 32)[0].numpy()
    np.testing.assert_array_equal(out, np.asarray(ref(jnp.asarray(img), 16,
                                                      32)))


def _stream_case(seed, n_seg, walign):
    rng = np.random.default_rng(seed)
    nbits = rng.integers(0, 3000, n_seg).astype(np.int32)
    nw = int(tpack.seg_nwords_aligned(nbits.astype(np.int64), walign).sum())
    words = rng.integers(0, 2 ** 32, nw + 3, dtype=np.uint64)
    words[::5] = 0xFFFFFFFF                          # force FF stuffing
    return words.astype(np.uint32).view(np.int32), nbits


@pytest.mark.parametrize("n_seg,walign", [(1, 64), (5, 8), (3, 16)])
def test_finalize_host_w_equals_reference(n_seg, walign, monkeypatch):
    up, nbits = _stream_case(n_seg, n_seg, walign)
    ref = jeng.finalize_host_w(up, nbits, 2, n_seg - 1, walign)
    assert teng.finalize_host_w(up, nbits, 2, n_seg - 1, walign) == ref
    # the numpy fallback (no C++ library) writes the same bytes
    monkeypatch.setattr(teng.native, "available", lambda: False)
    assert teng.finalize_host_w(up, nbits, 2, n_seg - 1, walign) == ref


def test_fetch_split_equals_reference():
    wstream = torch.arange(2 * 40, dtype=torch.int32).reshape(2, 40)
    nbits = torch.tensor([[77], [1200]], dtype=torch.int32)
    ovf = torch.tensor([False, True])
    arr, k = teng.combined_fetch(wstream, nbits, ovf, 16)
    assert k == 16 and arr.shape == (2, 16 + 1 + 1)
    ours = teng.split_fetch(arr, k, 1)
    theirs = jeng.split_fetch(arr, k, 1)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[0], wstream[:, :16].numpy())
    np.testing.assert_array_equal(ours[2], [False, True])


def test_tables_from_reference_carries_the_reference_tables():
    qt_host, _ = jeng.qtables_for_quality(75)
    jl = jeng.luts_from_tables(*standard_tables())
    t = teng.tables_from_reference(qt_host, np.asarray(jl.dc),
                                   np.asarray(jl.ac))
    from jpgenc_tpu import tables as T
    np.testing.assert_array_equal(
        t["qzz"].numpy(), qt_host.astype(np.float32)[:, np.asarray(T.ZIGZAG)])
    np.testing.assert_array_equal(t["ac_rows"].numpy().reshape(2, 256),
                                  np.asarray(jl.ac))
    assert t["misc"].tolist() == [int(jl.ac[0, 0xF0]), int(jl.ac[1, 0xF0]),
                                  int(jl.ac[0, 0]), int(jl.ac[1, 0])]


def test_wcompact_single_segment_is_a_bswapped_prefix():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2 ** 32, (2, 1, 50), dtype=np.uint64) \
        .astype(np.uint32)
    bits = np.array([[1500], [40]], np.int32)
    for cap in (32, 64):
        out, nb = tpack.wcompact_unstuffed(
            torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
            cap, 8)
        for b in range(2):
            ref, rnb = jpack.wcompact_unstuffed(jnp.asarray(words[b]),
                                                jnp.asarray(bits[b]), cap, 8)
            np.testing.assert_array_equal(out[b].numpy().view(np.uint32),
                                          np.asarray(ref))
            np.testing.assert_array_equal(nb[b].numpy(), np.asarray(rnb))
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tpack.wcompact_unstuffed(torch.zeros((3, 8), dtype=torch.int32),
                                 torch.zeros(3, dtype=torch.int32), 16, 8)


# --- the copied host modules --------------------------------------------------

def test_tables_module_equals_reference():
    from jpgenc_tpu import tables as jt
    from jpgenc_tpu_torch import tables as tt
    names = [n for n in dir(jt) if n.isupper()]
    assert len(names) >= 12 and names == [n for n in dir(tt) if n.isupper()]
    for n in names:
        np.testing.assert_array_equal(getattr(tt, n), getattr(jt, n), n)
    for q in (1, 25, 50, 75, 90, 100):
        for base in (jt.QTABLE_LUMA, jt.QTABLE_CHROMA):
            np.testing.assert_array_equal(tt.scale_qtable(base, q),
                                          jt.scale_qtable(base, q))


@pytest.mark.parametrize("h,w,sub,dri", LAYOUTS)
def test_layout_module_equals_reference(h, w, sub, dri):
    from jpgenc_tpu_torch.layout import make_layout as port_layout
    ours, ref = port_layout(h, w, sub, dri), make_layout(h, w, sub, dri)
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "comps":
            assert [dataclasses.astuple(c) for c in a] == \
                [dataclasses.astuple(c) for c in b]
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, f.name)
        else:
            assert a == b, f.name
    for prop in ("n_mcus", "n_scan", "n_segments", "blocks_per_segment",
                 "comp_offsets", "is_gray"):
        assert getattr(ours, prop) == getattr(ref, prop)


def _freqs():
    rng = np.random.default_rng(8)
    out = [rng.integers(0, 5000, 256), np.r_[np.ones(12, int), np.zeros(244, int)]]
    skew = np.zeros(256, np.int64)
    skew[:40] = 2 ** np.arange(40) % 100003 + 1       # forces length limiting
    return out + [skew, (rng.random(256) < 0.1) * rng.integers(1, 9, 256)]


def test_huffman_module_equals_reference():
    from jpgenc_tpu import huffman as jh
    from jpgenc_tpu_torch import huffman as th
    for freq in _freqs():
        ob, ov = th.optimize_tables(freq)
        rb, rv = jh.optimize_tables(freq)
        pb, pv = th._optimize_tables_py(np.asarray(freq, np.int64))
        np.testing.assert_array_equal(ob, rb)
        np.testing.assert_array_equal(ov, rv)
        np.testing.assert_array_equal(pb, rb)
        np.testing.assert_array_equal(pv, rv)
        a, b = th.build_codes(ob, ov), jh.build_codes(rb, rv)
        for f in ("bits", "vals", "code", "length"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    v = np.arange(-1030, 1031)
    np.testing.assert_array_equal(th.magnitude_category(v),
                                  jh.magnitude_category(v))


def test_tables_from_freq_equals_reference_batch_tables():
    from jpgenc_tpu.parallel.mesh import _build_tables_from_freq
    freq = np.stack(_freqs()).reshape(2, 2, 256)
    for n_tabs in (1, 2):
        ours = teng.tables_from_freq(freq, n_tabs)
        ref = _build_tables_from_freq(freq, n_tabs)
        for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
            np.testing.assert_array_equal(a.code, b.code)
            np.testing.assert_array_equal(a.length, b.length)
        # one optimized set per image, as tables_from_reference carries it
        jl = jeng.luts_from_tables(*ref)
        t = teng.tables_from_reference(
            jeng.qtables_for_quality(75)[0],
            np.stack([np.asarray(jl.dc)] * 3), np.stack([np.asarray(jl.ac)] * 3))
        dev = teng.device_tables([ours[0]] * 3, [ours[1]] * 3, "cpu")
        for name, d in zip(("ac_rows", "dc_rows", "misc"), dev):
            assert d.shape[0] == 3 and torch.equal(t[name], d)


def test_config_equals_reference():
    from jpgenc_tpu.config import EncodeConfig as ref
    from jpgenc_tpu_torch.config import EncodeConfig as ours
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())
    for kw in ({"quality": 0}, {"quality": 101}, {"subsampling": "411"},
               {"restart_interval": -1}, {"dct_method": "fast"}):
        with pytest.raises(ValueError):
            ref(**kw)
        with pytest.raises(ValueError):
            ours(**kw)


@pytest.mark.parametrize("h,w,sub,dri", [(48, 62, "444", 0), (120, 120, "420", 3),
                                         (100, 64, "gray", 3)])
def test_container_modules_equal_reference(h, w, sub, dri):
    from jpgenc_tpu.container import jfif as jj, parser as jp
    from jpgenc_tpu_torch.container import jfif as tj, parser as tp
    from jpgenc_tpu_torch.layout import make_layout as port_layout
    dc_t, ac_t = standard_tables()
    n = 1 if sub == "gray" else 2
    qt = list(jeng.qtables_for_quality(60)[0])
    hdr = jj.build_headers(make_layout(h, w, sub, dri), qt, dc_t[:n], ac_t[:n])
    assert tj.build_headers(port_layout(h, w, sub, dri), qt, dc_t[:n],
                            ac_t[:n]) == hdr
    data = hdr + bytes(range(40)) + b"\xff\xd9"
    a, b = tp.parse_jpeg(data), jp.parse_jpeg(data)
    assert (a.height, a.width, a.subsampling, a.restart_interval,
            a.scan_data, a.app0) == (b.height, b.width, b.subsampling,
                                     b.restart_interval, b.scan_data, b.app0)
    assert [dataclasses.astuple(c) for c in a.comps] == \
        [dataclasses.astuple(c) for c in b.comps]
    for i in b.qtables:
        np.testing.assert_array_equal(a.qtables[i], b.qtables[i])
    for ta, tb in ((a.dc_tables, b.dc_tables), (a.ac_tables, b.ac_tables)):
        assert sorted(ta) == sorted(tb)
        for i in tb:
            np.testing.assert_array_equal(ta[i].code, tb[i].code)
            np.testing.assert_array_equal(ta[i].length, tb[i].length)


@pytest.mark.parametrize("sub,dri,optimize", [("420", 0, False), ("422", 3, True),
                                              ("gray", 0, True)])
def test_ref_encoder_and_native_equal_reference(sub, dri, optimize):
    """The numpy reference encoder writes the same file, and the port's own
    C++ library (built into jpgenc_tpu_torch/_build/) decodes and finalizes
    as the reference's does."""
    from jpgenc_tpu import native as jn
    from jpgenc_tpu.config import EncodeConfig as JCfg
    from jpgenc_tpu.ref import encoder as je
    from jpgenc_tpu_torch import native as tn
    from jpgenc_tpu_torch.config import EncodeConfig as TCfg
    from jpgenc_tpu_torch.container.parser import parse_jpeg
    from jpgenc_tpu_torch.layout import make_layout as port_layout
    from jpgenc_tpu_torch.ref import encoder as te
    from jpgenc_tpu_torch.utils.fixtures import synth_frame
    img = synth_frame(40, 56, seed=2)
    mode = sub
    if sub == "gray":
        img, sub = img[..., 0].copy(), "420"
    kw = dict(quality=80, subsampling=sub, restart_interval=dri,
              optimize_huffman=optimize)
    data = je.encode_with_config(img, JCfg(**kw))
    assert te.encode_with_config(img, TCfg(**kw)) == data

    assert tn.available() and jn.available()
    so = tn.library_path()
    assert os.path.dirname(so) == os.path.join(
        os.path.dirname(jpgenc_tpu_torch.__file__), "_build")
    assert os.path.exists(so)
    assert not so.startswith(os.path.dirname(jpgenc_tpu.__file__) + os.sep)
    p = parse_jpeg(data)
    args = ([c.dc_tab for c in p.comps], [c.ac_tab for c in p.comps],
            [p.dc_tables.get(i) for i in range(2)],
            [p.ac_tables.get(i) for i in range(2)])
    ours = tn.decode_scan(p.scan_data, port_layout(40, 56, mode, dri), *args)
    ref = jn.decode_scan(p.scan_data, make_layout(40, 56, mode, dri), *args)
    np.testing.assert_array_equal(ours, ref)
    assert np.abs(ours).sum() > 0


@pytest.mark.parametrize("n_seg,walign", [(1, 64), (5, 8)])
def test_native_finalize_wcompact_equals_reference(n_seg, walign):
    from jpgenc_tpu import native as jn
    from jpgenc_tpu_torch import native as tn
    up, nbits = _stream_case(10 + n_seg, n_seg, walign)
    ref = jn.finalize_wcompact(up, nbits, 1, n_seg - 1, walign)
    assert ref is not None
    assert tn.finalize_wcompact(up, nbits, 1, n_seg - 1, walign) == ref


def test_fixtures_and_bitio_equal_reference():
    from jpgenc_tpu.ref import bitio as jb
    from jpgenc_tpu.utils import fixtures as jf
    from jpgenc_tpu_torch.ref import bitio as tb
    from jpgenc_tpu_torch.utils import fixtures as tf
    np.testing.assert_array_equal(tf.synth_frame(33, 47), jf.synth_frame(33, 47))
    np.testing.assert_array_equal(tf.synth_frame(16, 24, channels=1, seed=3),
                                  jf.synth_frame(16, 24, channels=1, seed=3))
    np.testing.assert_array_equal(tf.synth_batch(16, 24, 3),
                                  jf.synth_batch(16, 24, 3))
    raw = np.random.default_rng(6).integers(250, 256, 300).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(tb.stuff_bytes(raw)),
                                  np.asarray(jb.stuff_bytes(raw)))
    wa, wb = tb.BitWriter(), jb.BitWriter()
    for k in range(200):
        wa.put(k * 37 % (1 << (k % 16 + 1)), k % 16 + 1)
        wb.put(k * 37 % (1 << (k % 16 + 1)), k % 16 + 1)
    wa.align()
    wb.align()
    assert wa.getvalue() == wb.getvalue()
