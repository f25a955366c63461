"""GPU lane: the CUDA kernels against their plain PyTorch versions on the
card, at the CPU tests' sizes. Every test here is marked `gpu` and skips
without CUDA. The card's machine has no JAX, and tests/conftest.py imports
it, so run this file there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

This file imports no JAX and no conftest fixture.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jpgenc_tpu_torch import api, engine, native
from jpgenc_tpu_torch import decoder as D
from jpgenc_tpu_torch.container import parser
from jpgenc_tpu_torch.layout import make_layout
from jpgenc_tpu_torch.ops import entropy, pack
from jpgenc_tpu_torch.ops.cuda import (block_pack, k1_dct, k1a_fused, recon,
                                       seg_merge, symbol_hist)
from jpgenc_tpu_torch.parallel import mesh
from jpgenc_tpu_torch.ref import decoder as ref_decoder
from jpgenc_tpu_torch.ref import encoder as ref_encoder
from jpgenc_tpu_torch.utils import fixtures

pytestmark = pytest.mark.gpu

KNIFE_EDGE_FRAC = 1e-4
CASES = [(120, 136, "420"), (128, 256, "420"), (64, 126, "422"),
         (48, 62, "444")]
GRAY_CASES = [(128, 128), (100, 62), (17, 23)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _ops(h, w, sub, quality, device):
    plan = engine.get_plan(h, w, sub, quality, device)
    return (plan.layout, plan.kdct, plan.q), \
        (plan.ac_rows, plan.dc_rows, plan.misc)


def _knife_edge(a, b):
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    assert int(d.max()) <= 1
    assert float((d > 0).double().mean()) <= max(KNIFE_EDGE_FRAC,
                                                 1.0 / d.numel())


@pytest.mark.parametrize("h,w,sub", CASES)
@pytest.mark.parametrize("w_blk", [8, 12, 56])
def test_k1a_kernel_vs_plain(cuda, h, w, sub, w_blk):
    imgs = np.stack([fixtures.synth_frame(h, w, seed=s) for s in (1, 2)])
    ops, tabs = _ops(h, w, sub, 75, "cuda")
    x = torch.from_numpy(imgs).to(cuda)
    buf, bits, zz = k1a_fused.fused_pixels_to_pack(x, *ops, tabs, w_blk,
                                                   return_zz=True)
    torch.cuda.synchronize()
    _knife_edge(zz, k1a_fused.transform_plain(x, *ops))
    ebuf, ebits = k1a_fused.entropy_plain(zz.to(torch.int32), ops[0], tabs,
                                          w_blk)
    assert torch.equal(ebits, bits) and torch.equal(ebuf, buf)


@pytest.mark.parametrize("w_blk", [8, 16])
def test_k1a_kernel_overflowing_blocks(cuda, w_blk):
    """Noise at Q100 overflows the tier: words truncated, bits true."""
    noise = np.random.default_rng(11).integers(0, 256, (2, 32, 48, 3),
                                               np.uint8)
    ops, tabs = _ops(32, 48, "420", 100, "cuda")
    x = torch.from_numpy(noise).to(cuda)
    buf, bits, zz = k1a_fused.fused_pixels_to_pack(x, *ops, tabs, w_blk,
                                                   return_zz=True)
    assert int(bits.max()) > 32 * w_blk
    ebuf, ebits = k1a_fused.entropy_plain(zz.to(torch.int32), ops[0], tabs,
                                          w_blk)
    assert torch.equal(ebits, bits) and torch.equal(ebuf, buf)


def _random_blocks(n_blocks, w_blk, seed):
    """Random MSB-first block streams, zero past each block's length, with
    one block past its tier (the prologue clamps it)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 32 * w_blk, n_blocks).astype(np.int32)
    bits[3] = 32 * w_blk + 100
    on = (np.arange(32 * w_blk)[None, :] <
          np.minimum(bits, 32 * w_blk)[:, None]) & \
        (rng.random((n_blocks, 32 * w_blk)) < 0.5)
    buf = np.packbits(on, axis=1).view(">u4").astype(np.uint32)
    return torch.from_numpy(buf.view(np.int32)), torch.from_numpy(bits)


def _prefix_equal(kernel, plain, walign, cap_w):
    """The merge tail's outputs against merge_plain's: nbits and ovf exact,
    and each image's stream within its aligned prefix (capped at cap_w)."""
    kw, kn, ko = (t.cpu() for t in kernel)
    pw, pn, po = plain
    assert torch.equal(kn, pn) and torch.equal(ko, po)
    need = pack.seg_nwords_aligned(kn.to(torch.int64), walign).sum(dim=1)
    for i, k in enumerate(need.clamp(max=cap_w).tolist()):
        assert torch.equal(kw[i, :k], pw[i, :k]), f"image {i}"


@pytest.mark.parametrize("n_seg,spb", [(1, 700), (3, 200), (2, 1300),
                                       (2000, 1), (7, 513), (4, 512)])
@pytest.mark.parametrize("w_blk", [8, 24])
@pytest.mark.parametrize("capped", [False, True])
def test_seg_merge_kernel_vs_plain(cuda, n_seg, spb, w_blk, capped):
    """The merge tail (kernel B, the compaction, ovf) on random block
    streams with one block past its tier: segments cut into tiles, tiles of
    whole segments, thousands of one-block segments, capped streams."""
    n_img, walign = 2, pack.walign_for(spb)
    buf, bits = _random_blocks(n_img * n_seg * spb, w_blk,
                               seed=n_seg + spb + w_blk)
    buf = buf.reshape(n_img, n_seg * spb, w_blk)
    bits = bits.reshape(n_img, -1)
    full = int(pack.seg_nwords_aligned(
        bits.clamp(max=32 * w_blk).reshape(n_img, n_seg, spb).sum(-1)
        .to(torch.int64), walign).sum(-1).max())
    cap = full // 2 if capped else full + 40
    plain = seg_merge.merge_plain(buf, bits, n_seg, w_blk, cap, walign)
    before = (seg_merge.launches, seg_merge.plain_calls)
    out = seg_merge.fused_merge(buf.to(cuda), bits.to(cuda), n_seg, w_blk,
                                cap, walign)
    torch.cuda.synchronize()
    assert (seg_merge.launches, seg_merge.plain_calls) == \
        (before[0] + 1, before[1])
    assert out[2].tolist() == [True, False]      # block 3 overflowed
    _prefix_equal(out, plain, walign, cap)


@pytest.mark.parametrize("dri", [1, 7, 120])
@pytest.mark.parametrize("tables", ["standard", "optimized"])
def test_merge_tail_on_kernel_a_words(cuda, dri, tables):
    """Kernel A's words (per-image tables too) through the merge tail at
    restart intervals 1, 7 and 120, uncapped and capped at the tight tier,
    against merge_plain; no plain version runs on the card."""
    lay = make_layout(72, 264, "420", dri)
    sp = engine.make_symbol_plan(lay)
    n_img = 3
    zz = _blocks(dri, n_img, sp.valid.size)
    zz[:, ~sp.valid] = 0
    zt = torch.from_numpy(zz).to(cuda)
    prev = torch.from_numpy(sp.prev_same.astype(np.int64)).to(cuda)
    slot_plan = tuple(torch.from_numpy(a.astype(np.int32)).to(cuda)
                      for a in (sp.ac_tab, sp.dc_tab, sp.valid))
    dcdiff = block_pack.slot_metadata(prev, zt)
    if tables == "standard":
        dc_t, ac_t = ref_encoder.standard_tables()
        tabs = tuple(t.to(cuda) for t in block_pack.packed_tables(
            engine.luts_from_tables(dc_t, ac_t)))
    else:
        hist = entropy.symbol_histogram(zt, dcdiff, *slot_plan)
        tabs = engine.device_tables(
            *zip(*[engine.tables_from_freq(f, 2) for f in hist.cpu().numpy()]),
            cuda)
    walign = pack.walign_for(lay.blocks_per_segment)
    for w_blk in (8, 56):
        buf, bits = block_pack.fused_block_pack(zt, dcdiff, *slot_plan, tabs,
                                                w_blk)
        for cap in (engine.scan_caps(lay, 75, "worst")[0] // 4,
                    engine.scan_caps(lay, 75, "tight")[0] // 4):
            plain_before = (block_pack.plain_calls, seg_merge.plain_calls)
            out = seg_merge.fused_merge(buf, bits, lay.n_segments, w_blk,
                                        cap, walign)
            torch.cuda.synchronize()
            assert (block_pack.plain_calls, seg_merge.plain_calls) == \
                plain_before
            assert bool(out[2].any()) == (w_blk == 8)
            _prefix_equal(out, seg_merge.merge_plain(
                buf.cpu(), bits.cpu(), lay.n_segments, w_blk, cap, walign),
                walign, cap)


def _decode(data, layout):
    """Scan-decode a file with its own tables."""
    p = parser.parse_jpeg(data)
    coef = native.decode_scan(p.scan_data, layout,
                              [c.dc_tab for c in p.comps],
                              [c.ac_tab for c in p.comps],
                              [p.dc_tables.get(i) for i in range(2)],
                              [p.ac_tables.get(i) for i in range(2)])
    assert coef is not None, "native scan decoder unavailable"
    return coef


def _only_knife_edges(zz, x, ops):
    """The kernel's coefficients against its plain version and against the
    same transform in float64: |diff| <= 1, and a coefficient may differ
    from the plain version only where the float64 value lies within 1e-4 of
    a rounding boundary (and on at most 1e-3 of the coefficients).
    Replicate-padded edge blocks of small frames put coefficients exactly on
    a boundary (measured: two of 19968 at 100x62 gray Q75, float64 values
    +-0.49999997), so the fraction alone would be a flaky bound here."""
    plain = k1_dct.transform_plain(x, *ops)
    zz = zz.reshape(plain.shape).to(torch.int32)
    d = zz != plain
    assert int((zz - plain).abs().max()) <= 1
    assert int(d.sum()) <= 1e-3 * d.numel()
    exact = k1_dct.scaled_coefficients(x, *ops, dtype=torch.float64)
    dist = ((exact - exact.floor()) - 0.5).abs()
    assert bool((dist[d] < 1e-4).all())


def _frame(h, w, mode, seed=7):
    img = fixtures.synth_frame(h, w, seed=seed)
    return img[..., 1].copy() if mode == "gray" else img


@pytest.mark.parametrize("quality", [50, 75, 90, 95])
@pytest.mark.parametrize("h,w,sub", CASES)
def test_encode_on_cuda_holds_kernel_coefficients(cuda, h, w, sub, quality):
    """The file decodes to the kernel's coefficients exactly, and equals the
    CPU encode's bytes wherever the coefficients agree."""
    img = fixtures.synth_frame(h, w)
    data = api.encode(img, quality, sub, device="cuda")
    ops, tabs = _ops(h, w, sub, quality, "cuda")
    _, _, zz = k1a_fused.fused_pixels_to_pack(
        torch.from_numpy(img)[None].to(cuda), *ops, tabs, 8, return_zz=True)
    lay = ops[0]
    expect = np.empty((lay.n_scan, 64), np.int32)
    expect[lay.scan_flat] = zz[0].reshape(-1, 64).cpu().numpy()
    np.testing.assert_array_equal(_decode(data, lay), expect)
    cpu_zz = k1a_fused.transform_plain(torch.from_numpy(img)[None],
                                       *_ops(h, w, sub, quality, "cpu")[0])
    if torch.equal(cpu_zz.to(torch.int16), zz.cpu()):
        assert data == api.encode(img, quality, sub, device="cpu")


def test_encode_batch_on_cuda(cuda):
    """Tight tier for the batch, the noise frame retried alone at the worst
    tier; the launch counters move and the plain versions are not called."""
    frames = [fixtures.synth_frame(64, 96, seed=s) for s in (1, 2, 3)]
    frames.append(np.random.default_rng(9).integers(0, 256, (64, 96, 3),
                                                    dtype=np.uint8))
    batch = np.stack(frames)
    before = (k1a_fused.launches, seg_merge.launches,
              k1a_fused.plain_calls, seg_merge.plain_calls)
    out = mesh.encode_batch(torch.from_numpy(batch).to(cuda), 75,
                            device="cuda")
    after = (k1a_fused.launches, seg_merge.launches,
             k1a_fused.plain_calls, seg_merge.plain_calls)
    assert after[0] >= before[0] + 2 and after[1] >= before[1] + 2
    assert after[2:] == before[2:]
    assert out == [api.encode(f, 75, device="cuda") for f in frames]
    assert mesh.encode_batch(batch, 75, device="cuda") == out


# --- the split path: K1, kernel A, the gray kernels ---------------------------

@pytest.mark.parametrize("h,w,sub", CASES + [(h, w, "gray")
                                             for h, w in GRAY_CASES])
def test_k1_kernel_vs_plain_and_k1a(cuda, h, w, sub):
    """K1 (colour and gray) within the knife-edge policy of its plain
    version, and equal to the K1A kernel's coefficients exactly."""
    imgs = np.stack([_frame(h, w, sub, seed=s) for s in (1, 2, 3)])
    ops, tabs = _ops(h, w, sub, 75, "cuda")
    x = torch.from_numpy(imgs).to(cuda)
    before = (k1_dct.launches, k1_dct.launches_gray, k1_dct.plain_calls)
    zz = k1_dct.fused_pixels_to_scan(x, *ops)
    torch.cuda.synchronize()
    gray = int(sub == "gray")
    assert (k1_dct.launches, k1_dct.launches_gray, k1_dct.plain_calls) == \
        (before[0] + 1 - gray, before[1] + gray, before[2])
    assert zz.dtype == torch.int16 and \
        tuple(zz.shape) == (3, ops[0].n_scan, 64)
    _only_knife_edges(zz, x, ops)
    _, _, zz_a = k1a_fused.fused_pixels_to_pack(x, *ops, tabs, 8,
                                                return_zz=True)
    assert torch.equal(zz.reshape(-1), zz_a.reshape(-1))


@pytest.mark.parametrize("h,w", GRAY_CASES)
@pytest.mark.parametrize("w_blk", [8, 56])
def test_k1a_gray_kernel_vs_plain(cuda, h, w, w_blk):
    imgs = np.stack([_frame(h, w, "gray", seed=s) for s in (1, 2)])
    ops, tabs = _ops(h, w, "gray", 90, "cuda")
    x = torch.from_numpy(imgs).to(cuda)
    buf, bits, zz = k1a_fused.fused_pixels_to_pack(x, *ops, tabs, w_blk,
                                                   return_zz=True)
    torch.cuda.synchronize()
    _only_knife_edges(zz, x, ops)
    ebuf, ebits = k1a_fused.entropy_plain(zz.to(torch.int32), ops[0], tabs,
                                          w_blk)
    assert torch.equal(ebits, bits) and torch.equal(ebuf, buf)


def _blocks(seed, n_img, n_slots):
    """Sparse quantized-looking zigzag blocks with long zero runs and some
    dense large blocks (overflow below the 56-word tier)."""
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


@pytest.mark.parametrize("tables", ["standard", "optimized"])
@pytest.mark.parametrize("w_blk", [8, 24, 56])
@pytest.mark.parametrize("h,w,mode,dri", [(40, 56, "420", 5),
                                          (24, 40, "444", 0),
                                          (24, 40, "gray", 4)])
def test_block_pack_kernel_vs_plain(cuda, h, w, mode, dri, w_blk, tables):
    """Kernel A: words and bits exact, shared and per-image tables, padding
    slots (valid == 0) zeroed, overflowing blocks truncated with true bits."""
    lay = make_layout(h, w, mode, dri)
    sp = engine.make_symbol_plan(lay)
    n_img = 3
    zz = _blocks(3, n_img, sp.valid.size)
    zz[:, ~sp.valid] = 0
    zt = torch.from_numpy(zz).to(cuda)
    prev = torch.from_numpy(sp.prev_same.astype(np.int64)).to(cuda)
    slot_plan = tuple(torch.from_numpy(a.astype(np.int32)).to(cuda)
                      for a in (sp.ac_tab, sp.dc_tab, sp.valid))
    dcdiff = block_pack.slot_metadata(prev, zt)
    n_tabs = 1 if lay.is_gray else 2
    if tables == "standard":
        dc_t, ac_t = ref_encoder.standard_tables()
        tabs = tuple(t.to(cuda) for t in block_pack.packed_tables(
            engine.luts_from_tables(dc_t[:n_tabs], ac_t[:n_tabs])))
        img = None
    else:
        hist = entropy.symbol_histogram(zt, dcdiff, *slot_plan)
        per_img = [engine.tables_from_freq(f, n_tabs)
                   for f in hist.cpu().numpy()]
        tabs = engine.device_tables(*zip(*per_img), cuda)
        img = torch.arange(n_img, device=cuda).repeat_interleave(
            sp.valid.size)
    before = (block_pack.launches, block_pack.plain_calls)
    buf, bits = block_pack.fused_block_pack(zt, dcdiff, *slot_plan, tabs,
                                            w_blk)
    torch.cuda.synchronize()
    assert (block_pack.launches, block_pack.plain_calls) == \
        (before[0] + 1, before[1])
    pbuf, pbits = block_pack.pack_blocks_plain(
        zt.reshape(-1, 64), dcdiff.reshape(-1), slot_plan[0].repeat(n_img),
        tabs, w_blk, dctab=slot_plan[1].repeat(n_img),
        valid=slot_plan[2].repeat(n_img), img=img)
    assert torch.equal(bits.reshape(-1), pbits)
    assert torch.equal(buf.reshape(-1, w_blk), pbuf)
    assert (int(bits.max()) > 32 * w_blk) == (w_blk < 56)
    pad = torch.from_numpy(~sp.valid).to(cuda)
    assert int(bits[:, pad].abs().sum()) == 0
    assert int(buf[:, pad].abs().sum()) == 0


def _hand_blocks(n_slots):
    """Hand-made zigzag blocks (tests/test_torch_block_pack.py's): zero runs
    of 15, 16, 31, 32, 47 and 48 before a nonzero (0-3 ZRLs), a nonzero at
    position 63 (no EOB), the all-nonzero block, AC +-1023 and DC
    differences +-2047, an empty block; then random dense blocks."""
    rng = np.random.default_rng(21)
    zz = np.zeros((n_slots, 64), np.int64)
    for k, run in enumerate((15, 16, 31, 32, 47, 48)):
        zz[k, 1 + run] = 3 - 6 * (k & 1)
    zz[6, 63] = 1
    zz[7, 1:] = rng.integers(1, 1024, 63) * rng.choice([-1, 1], 63)
    zz[8, 1:] = 1023
    zz[9, [1, 63]] = -1023
    zz[:12, 0] = [0, 2047, -2047, 0, 2047, -2047, 5, -5, 1000, -1000, 0, 0]
    zz[12:] = rng.integers(-1023, 1024, (n_slots - 12, 64))
    return zz.astype(np.int16)


@pytest.mark.parametrize("w_blk", [1, 8, 56])
def test_block_pack_kernel_on_hand_made_blocks(cuda, w_blk):
    """Kernel A against pack_blocks_plain on the hand-made blocks, with the
    DC differences taken as the blocks' own DC (prev_same -1), a padding
    slot and blocks that overflow the tier."""
    n = 45
    zz = torch.from_numpy(_hand_blocks(n))[None].repeat(2, 1, 1)
    zz[1] = zz[1].flip(0)
    dcdiff = zz[..., 0].to(torch.int32).contiguous()
    tab = torch.tensor([k % 2 for k in range(n)], dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.int32)
    valid[10] = 0
    tabs = block_pack.packed_tables(engine.luts_from_tables(
        *ref_encoder.standard_tables()))
    pbuf, pbits = block_pack.pack_blocks_plain(
        zz.reshape(-1, 64), dcdiff.reshape(-1), tab.repeat(2), tabs, w_blk,
        valid=valid.repeat(2))
    before = (block_pack.launches, block_pack.plain_calls)
    buf, bits = block_pack.fused_block_pack(
        zz.to(cuda), dcdiff.to(cuda), tab.to(cuda), tab.to(cuda),
        valid.to(cuda), tuple(t.to(cuda) for t in tabs), w_blk)
    torch.cuda.synchronize()
    assert (block_pack.launches, block_pack.plain_calls) == \
        (before[0] + 1, before[1])
    assert torch.equal(bits.cpu().reshape(-1), pbits)
    assert torch.equal(buf.cpu().reshape(-1, w_blk), pbuf)
    assert (int(bits.max()) > 32 * w_blk) == (w_blk < 56)
    assert int(bits[:, 10].abs().sum()) == 0


def test_histogram_on_cuda_equals_cpu(cuda):
    lay = make_layout(40, 56, "420", 0)
    sp = engine.make_symbol_plan(lay)
    zz = torch.from_numpy(_blocks(5, 3, sp.valid.size))
    args = (torch.from_numpy(sp.ac_tab), torch.from_numpy(sp.dc_tab),
            torch.from_numpy(sp.valid.astype(np.int32)))
    prev = torch.from_numpy(sp.prev_same.astype(np.int64))
    cpu = entropy.symbol_histogram(zz, block_pack.slot_metadata(prev, zz),
                                   *args)
    zc = zz.to(cuda)
    before = (symbol_hist.launches, symbol_hist.plain_calls)
    gpu = entropy.symbol_histogram(
        zc, block_pack.slot_metadata(prev.to(cuda), zc),
        *(a.to(cuda) for a in args))
    assert (symbol_hist.launches, symbol_hist.plain_calls) == \
        (before[0] + 1, before[1])
    assert torch.equal(gpu.cpu(), cpu)


def _kernel_equals_plain(cuda, zz, sp):
    """The histogram kernel on zz [B, S, 64] (numpy int16) under the symbol
    plan sp, against histogram_plain on the same card tensors: every count
    equal, one launch, no plain call. Returns the counts."""
    zt = torch.from_numpy(zz).to(cuda)
    dcdiff = block_pack.slot_metadata(
        torch.from_numpy(sp.prev_same.astype(np.int64)).to(cuda), zt)
    plan = tuple(torch.from_numpy(a.astype(np.int32)).to(cuda)
                 for a in (sp.ac_tab, sp.dc_tab, sp.valid))
    before = (symbol_hist.launches, symbol_hist.plain_calls)
    hist = entropy.symbol_histogram(zt, dcdiff, *plan)
    torch.cuda.synchronize()
    assert (symbol_hist.launches, symbol_hist.plain_calls) == \
        (before[0] + 1, before[1])
    plain = symbol_hist.histogram_plain(zt, dcdiff, *plan)
    assert hist.dtype == torch.int32 and torch.equal(hist, plain)
    return hist.cpu()


def test_symbol_hist_kernel_hand_made_blocks(cuda):
    """All-zero, DC only, position 63 alone (no EOB), zero runs of 15, 16,
    17, 31, 32, 47 and 62 (ZRLs), AC values of SSSS 1-11 and +-2047, DC
    differences up to +-4094, all-nonzero blocks; the rest random."""
    sp = engine.make_symbol_plan(make_layout(48, 64, "420", 0))
    zz = _blocks(21, 2, sp.valid.size)
    zz[0, :40] = 0
    zz[0, 1, 0] = 9                                  # DC only
    zz[0, 2, 63] = 3                                 # position 63 alone
    for i, r in enumerate((15, 16, 17, 31, 32, 47, 62)):
        zz[0, 3 + i, r + 1] = -5 + 2 * i             # one run of r zeros
    for s in range(1, 12):
        zz[0, 9 + s, 1] = (1 << s) - 1
        zz[0, 9 + s, 2] = -(1 << (s - 1))
        zz[0, 9 + s, 0] = (-1) ** s * min((1 << s) - 1, 2047)
    zz[0, 21, 1:3] = (2047, -2047)
    zz[0, 22:24, 0] = (2047, -2047)
    zz[0, 24] = (np.arange(64) % 7 - 3) | 1          # every position odd
    zz[0, 25] = np.where(np.arange(64) % 2, 2047, -2047)
    zz[0, 26, [1, 17, 34, 63]] = (1, -1, 2, -2)
    hist = _kernel_equals_plain(cuda, zz, sp)
    assert int(hist[0, 1, :, 0xF0].sum()) > 0        # ZRLs counted
    assert int(hist[0, 0, :, 12].sum()) > 0          # DC SSSS 12
    assert int(hist[0, 1, :, 0x0B].sum()) > 0        # AC SSSS 11


@pytest.mark.parametrize("n_img", [1, 3, 16])
@pytest.mark.parametrize("dri", [0, 7])
@pytest.mark.parametrize("h,w,mode", [(200, 264, "420"), (200, 264, "422"),
                                      (200, 264, "444"), (264, 296, "gray")])
def test_symbol_hist_kernel_vs_plain(cuda, h, w, mode, dri, n_img):
    """Random slots (_blocks) in every sampling, with and without pad slots
    (DRI 7: valid == 0, their random blocks count nothing), over more than
    one tile of slots and a ragged last tile."""
    sp = engine.make_symbol_plan(make_layout(h, w, mode, dri))
    assert sp.valid.size > symbol_hist.TILE and \
        sp.valid.size % symbol_hist.TILE
    assert bool(sp.valid.all()) == (dri == 0)
    hist = _kernel_equals_plain(cuda, _blocks(dri + n_img, n_img,
                                              sp.valid.size), sp)
    if mode == "gray":
        assert int(hist[:, :, 1].sum()) == 0


def test_symbol_hist_kernel_on_4k_frames(cuda):
    """K1 rows' coefficients of two 4K photographic frames (the benchmark's
    content, its first and last level), through EncodePlan.histogram."""
    from portbench import frames as bench_frames
    x = bench_frames.frames(2, 2160, 3840, 3,
                            bench_frames.generator(2**31 + 7, cuda), cuda,
                            [1.98, 17.83])
    plan = engine.get_plan(2160, 3840, "420", 75, "cuda")
    zz, dcdiff = plan.zz_scan(x)
    before = (symbol_hist.launches, symbol_hist.plain_calls)
    hist = plan.histogram(zz, dcdiff)
    torch.cuda.synchronize()
    assert (symbol_hist.launches, symbol_hist.plain_calls) == \
        (before[0] + 1, before[1])
    assert torch.equal(hist, symbol_hist.histogram_plain(
        zz, dcdiff, plan.ac_tab, plan.dc_tab, plan.valid))


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("h,w,sub", CASES[:1] + CASES[2:] +
                         [(128, 128, "gray"), (17, 23, "gray")])
def test_encode_split_and_gray_on_cuda(cuda, h, w, sub, quality, optimize):
    """optimize=True (every mode) and gray: the file decodes, with its own
    tables, to the K1 kernel's coefficients exactly; optimized files are
    smaller; and the bytes equal the CPU encode's wherever the coefficients
    agree."""
    img = _frame(h, w, sub)
    kw = dict(subsampling="420" if sub == "gray" else sub, optimize=optimize)
    data = api.encode(img, quality, device="cuda", **kw)
    ops, _ = _ops(h, w, sub, quality, "cuda")
    lay = ops[0]
    zz = k1_dct.fused_pixels_to_scan(torch.from_numpy(img)[None].to(cuda),
                                     *ops)
    expect = np.empty((lay.n_scan, 64), np.int32)
    expect[lay.scan_flat] = zz[0].cpu().numpy()
    np.testing.assert_array_equal(_decode(data, lay), expect)
    if optimize:
        assert len(data) < len(api.encode(img, quality, device="cuda",
                                          subsampling=kw["subsampling"]))
    cpu_zz = k1_dct.fused_pixels_to_scan(torch.from_numpy(img)[None],
                                         *_ops(h, w, sub, quality, "cpu")[0])
    if torch.equal(cpu_zz, zz.cpu()):
        assert data == api.encode(img, quality, device="cpu", **kw)


@pytest.mark.parametrize("gray", [False, True])
def test_encode_batch_optimize_on_cuda(cuda, gray):
    """Per-image tables for the batch, the noise frame retried alone at the
    worst tier from the cached coefficients; no plain version is called."""
    frames = [fixtures.synth_frame(64, 96, seed=s) for s in (1, 2, 3)]
    frames.append(np.random.default_rng(9).integers(0, 256, (64, 96, 3),
                                                    dtype=np.uint8))
    batch = np.stack(frames)
    if gray:
        batch = np.ascontiguousarray(batch[..., 1])
    mods = (k1a_fused, seg_merge, k1_dct, block_pack)
    plain = [m.plain_calls for m in mods]
    a0, k0 = block_pack.launches, k1_dct.launches + k1_dct.launches_gray
    out = mesh.encode_batch(torch.from_numpy(batch).to(cuda), 75,
                            optimize=True, device="cuda")
    assert block_pack.launches == a0 + 2
    assert k1_dct.launches + k1_dct.launches_gray == k0 + 1
    assert [m.plain_calls for m in mods] == plain
    assert out == [api.encode(f, 75, optimize=True, device="cuda")
                   for f in batch]


def test_encode_batch_optimize_at_4k_on_cuda(cuda, monkeypatch):
    """The benchmark's two-pass batch at its size: a 3840 x 2160
    photographic frame and a uniform-noise frame on the card, the noise over
    the tight tier (its blocks over w_blk) and retried with its own tables.
    One K1 rows launch, one kernel A launch for the batch and one a retry,
    no plain version; the files are api.encode's."""
    from portbench import frames as bench_frames
    gen = bench_frames.generator(2**31 + 4, cuda)
    photo = bench_frames.frames(1, 2160, 3840, 3, gen, cuda, [1.98])
    noise = torch.randint(0, 256, (1, 2160, 3840, 3), generator=gen,
                          dtype=torch.uint8, device=cuda)
    x = torch.cat([photo, noise])
    retried = []
    real_recode = engine.EncodeJob.recode

    def recode(self, j, *args, **kwargs):
        retried.append(j)
        return real_recode(self, j, *args, **kwargs)

    monkeypatch.setattr(engine.EncodeJob, "recode", recode)
    mods = (k1a_fused, seg_merge, k1_dct, block_pack)
    plain = [m.plain_calls for m in mods]
    a0, k0 = block_pack.launches, k1_dct.launches
    out = mesh.encode_batch(x, 75, optimize=True, device="cuda")
    assert retried and k1_dct.launches == k0 + 1
    assert block_pack.launches == a0 + 1 + len(retried)
    assert [m.plain_calls for m in mods] == plain
    assert out == [api.encode(f, 75, optimize=True, device="cuda")
                   for f in x]


def test_photographs_fit_the_tight_tier_on_cuda(cuda, monkeypatch):
    """The benchmark cells' content at their geometry, at the first and the
    last detail level: two 1080p frames with the standard tables and two
    4K frames with optimize, each batch coded at the tight tier with no
    row re-coded; the files are api.encode's."""
    from portbench import frames as bench_frames
    root = Path(__file__).resolve().parent.parent / "portbench" / "configs"
    recoded = []
    real_recode = engine.EncodeJob.recode

    def recode(self, j, *args, **kwargs):
        recoded.append(j)
        return real_recode(self, j, *args, **kwargs)

    monkeypatch.setattr(engine.EncodeJob, "recode", recode)
    for name in ("rgb1080p_420_q75", "rgb4k_420_q75_optimized_batch"):
        cfg = json.loads((root / f"{name}.json").read_text())
        amps = cfg["content"]["amplitude"]
        x = bench_frames.frames(2, cfg["height"], cfg["width"],
                                cfg["channels"],
                                bench_frames.generator(2**31 + 21, cuda),
                                cuda, [amps[0], amps[-1]])
        kw = dict(quality=cfg["quality"], subsampling=cfg["subsampling"],
                  optimize=cfg["optimize"], device="cuda")
        out = mesh.encode_batch(x, **kw)
        assert recoded == [], name
        assert out == [api.encode(f, **kw) for f in x], name


# --- the decoder: the reconstruction kernels and the decode paths ----------

RECON_CASES = [("420", 61, 130), ("420", 32, 128), ("420", 17, 9),
               ("422", 47, 250), ("422", 16, 18), ("444", 100, 64),
               ("444", 9, 71), ("gray", 61, 130), ("gray", 100, 257),
               ("gray", 7, 5)]


def _pixel_parity(out, ref, max_frac=1e-3):
    """max |diff| <= 1 on fewer than 1e-3 of the bytes (at least 4 bytes:
    the smallest cases have few)."""
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.uint8
    d = (out.to(torch.int32) - ref.to(torch.int32)).abs()
    assert int(d.max()) <= 1
    assert float((d > 0).double().mean()) <= max(max_frac, 4 / d.numel())


def _coefficients(sub, h, w, batch, amp, seed):
    lay = make_layout(h, w, sub)
    n_total = sum(c.n_blocks for c in lay.comps)
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-amp, amp, (batch, n_total, 64)).astype(np.int32)
    qts = [rng.integers(1, 40, (batch, 64)).astype(np.int32)
           for _ in lay.comps]
    return lay, blocks, qts, D.coefficients_from_reference(lay, blocks, qts)


@pytest.mark.parametrize("sub,h,w", RECON_CASES)
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("amp", [30, 300])
def test_recon_kernel_vs_plain(cuda, sub, h, w, batch, amp):
    """Both kernels of csrc/recon.cu against recon_plain on the card, with
    TF32 off (the package switches it off), and the few bytes that differ
    against the float64 anchor: neither side may be further than 3."""
    assert not torch.backends.cuda.matmul.allow_tf32
    lay, blocks, qts, (x4, q_rows) = _coefficients(sub, h, w, batch, amp,
                                                   h * 1000 + w + batch)
    x4, q_rows = x4.to(cuda), q_rows.to(cuda)
    before = (recon.launches, recon.launches_gray, recon.plain_calls)
    out = recon.fused_recon_rgb(x4, q_rows, lay)
    torch.cuda.synchronize()
    gray = sub == "gray"
    assert (recon.launches, recon.launches_gray, recon.plain_calls) == \
        (before[0] + (not gray), before[1] + gray, before[2])
    plain = recon.recon_plain(x4, q_rows, lay)
    _pixel_parity(out, plain)
    assert torch.equal(out, recon.fused_recon_rgb(x4, q_rows, lay))
    for i in range(batch):
        ref = ref_decoder.reconstruct_ref(lay, blocks[i],
                                          [q[i] for q in qts])
        for side in (out, plain):
            d = np.abs(side[i].cpu().numpy().astype(int) - ref.astype(int))
            assert d.max() <= 3


@pytest.mark.parametrize("sub,h,w", RECON_CASES[:1] + RECON_CASES[3:4]
                         + RECON_CASES[7:8])
def test_recon_kernel_batch_equals_single_images(cuda, sub, h, w):
    """Each image of a batch is reconstructed with its own quant row, and a
    second image's pixels do not depend on the first's."""
    lay, _, _, (x4, q_rows) = _coefficients(sub, h, w, 3, 60, 99)
    x4, q_rows = x4.to(cuda), q_rows.to(cuda)
    out = recon.fused_recon_rgb(x4, q_rows, lay)
    for i in range(3):
        one = recon.fused_recon_rgb(x4[i:i + 1].contiguous(),
                                    q_rows[i:i + 1].contiguous(), lay)
        assert torch.equal(out[i], one[0])


def _x4_case(sub, h, w, fill, seed, batch=2):
    """An MCU-major reconstruction input made by fill(rng, lay, shape) ->
    int values [B, my, mx, L]; quant tables 1..40 per component. Returns
    (layout, x4, q_rows) on the CPU and (raster blocks, per-component
    natural-order tables) for the float64 reference."""
    lay = make_layout(h, w, sub)
    rng = np.random.default_rng(seed)
    shape = (batch, lay.mcus_y, lay.mcus_x, lay.blocks_per_mcu * 64)
    x4 = np.clip(fill(rng, lay, shape), -32768, 32767).astype(np.int16)
    tabs = rng.integers(1, 41, (2, 64)).astype(np.int32)
    per_comp = [tabs[0]] if lay.is_gray else [tabs[0], tabs[1], tabs[1]]
    q_rows = np.repeat(D._q_rows(lay, per_comp), batch, axis=0)
    blocks = np.empty((batch, lay.n_scan, 64), np.int32)
    blocks[:, np.asarray(lay.scan_flat)] = x4.reshape(batch, -1, 64)
    return (lay, torch.from_numpy(x4), torch.from_numpy(q_rows), blocks,
            per_comp)


def _hold_recon(cuda, case):
    """The kernel against recon_plain (the pixel parity) and every image
    against the float64 reference (<= 3), with one launch and no plain
    call."""
    lay, x4, q_rows, blocks, per_comp = case
    x4, q_rows = x4.to(cuda), q_rows.to(cuda)
    before = (recon.launches + recon.launches_gray, recon.plain_calls)
    out = recon.fused_recon_rgb(x4, q_rows, lay)
    torch.cuda.synchronize()
    assert (recon.launches + recon.launches_gray, recon.plain_calls) == \
        (before[0] + 1, before[1])
    _pixel_parity(out, recon.recon_plain(x4, q_rows, lay))
    for i in range(x4.shape[0]):
        ref = ref_decoder.reconstruct_ref(lay, blocks[i], per_comp)
        d = np.abs(out[i].cpu().numpy().astype(int) - ref.astype(int))
        assert d.max() <= 3
    return out


def _only(ks):
    """Blocks whose only nonzero coefficients are those of ks."""
    def fill(rng, lay, shape):
        x = np.zeros(shape, np.int64).reshape(shape[:3] + (-1, 64))
        for k in ks:
            x[..., k] = rng.integers(-60, 61, x.shape[:-1])
        return x.reshape(shape)
    return fill


RECON_FILLS = {
    "all_zero": lambda rng, lay, shape: np.zeros(shape, np.int64),
    "dc_only": _only([0]),
    "k63_only": _only([63]),
    "all_nonzero": lambda rng, lay, shape: rng.integers(1, 4, shape)
    * rng.choice([-1, 1], shape),
    "clamps": lambda rng, lay, shape: np.where(
        np.arange(shape[-1]) % 64 == 0, rng.choice([-2000, 2000], shape),
        rng.integers(-300, 301, shape)),
}


@pytest.mark.parametrize("fill", list(RECON_FILLS))
@pytest.mark.parametrize("sub,h,w", [("420", 61, 130), ("422", 47, 250),
                                     ("444", 9, 71), ("gray", 100, 257)])
def test_recon_kernel_on_structured_blocks(cuda, sub, h, w, fill):
    """Zero terms left out: all-zero blocks, DC only, only the last
    coefficient, no zero at all, and samples far past both clamps."""
    out = _hold_recon(cuda, _x4_case(sub, h, w, RECON_FILLS[fill],
                                     sum(map(ord, fill)) + h))
    if fill == "all_zero":
        assert int(out.min()) == int(out.max()) == 128
    if fill == "clamps":
        assert int(out.min()) == 0 and int(out.max()) == 255


@pytest.mark.parametrize("r", range(16))
@pytest.mark.parametrize("sub", ["420", "422", "444", "gray"])
def test_recon_kernel_at_every_residue(cuda, sub, r):
    """Heights and widths at every residue mod 16, widths whose MCU count
    is no multiple of the kernels' tiles (recon.TILE, recon.GRAY_TILE)."""
    h, w = 17 + r, 130 + 17 * r + (300 if sub == "gray" else 0)
    out = _hold_recon(cuda, _x4_case(
        sub, h, w, lambda rng, lay, shape: rng.integers(-40, 41, shape)
        * (rng.random(shape) < 0.3), 500 + r))
    assert out.shape[1:3] == (h, w)


def _halo_pattern(pattern, dense_first):
    """4:2:0 MCUs alternately dense and all zero: a checkerboard, the halves
    of a tile, or whole MCU rows, so that a halo neighbour is all zero
    while its owner is dense (dense_first) or the reverse."""
    def fill(rng, lay, shape):
        i = np.arange(shape[1])[:, None]
        j = np.arange(shape[2])[None, :]
        on = {"checker": (i + j) % 2 == 0,
              "tile_halves": (j // (recon.TILE // 2)) % 2 == 0,
              "rows": i % 2 == 0}[pattern]
        on = on if dense_first else ~on
        x = rng.integers(-50, 51, shape)
        return x * on[None, :, :, None]
    return fill


@pytest.mark.parametrize("dense_first", [True, False])
@pytest.mark.parametrize("pattern", ["checker", "tile_halves", "rows"])
@pytest.mark.parametrize("sub", ["420", "422"])
def test_recon_kernel_halo_beside_zero_neighbours(cuda, sub, pattern,
                                                  dense_first):
    _hold_recon(cuda, _x4_case(sub, 64, 2 * 16 * recon.TILE + 40,
                               _halo_pattern(pattern, dense_first),
                               7 + dense_first))


def _decode_file(mode, h, w, seed, quality=75, dri=0, optimize=False):
    img = _frame(h, w, mode, seed)
    return ref_encoder.encode(img, quality, "420" if mode == "gray" else mode,
                              restart_interval=dri, optimize=optimize)


@pytest.mark.parametrize("mode,h,w", [("420", 120, 136), ("422", 64, 126),
                                      ("444", 48, 62), ("gray", 100, 62)])
@pytest.mark.parametrize("dri", [0, 3])
def test_decode_round_trip_on_cuda(cuda, mode, h, w, dri):
    """decode(encode(x)) on the card against the float64 exact_decode and
    against the same decode on the CPU; the port's own encoder makes the
    file where it can (no restart interval)."""
    img = _frame(h, w, mode)
    if dri:
        data = _decode_file(mode, h, w, 7, dri=dri)
    else:
        data = api.encode(img, 75, "420" if mode == "gray" else mode,
                          device="cuda")
    before = recon.plain_calls
    out = api.decode(data, device="cuda")
    dev = api.decode(data, to_device=True, device="cuda")
    assert recon.plain_calls == before
    assert isinstance(out, np.ndarray) and dev.device.type == "cuda"
    assert np.array_equal(dev.cpu().numpy(), out)
    assert out.shape == img.shape
    d = np.abs(out.astype(int) - ref_decoder.exact_decode(data).astype(int))
    assert d.max() <= 3
    _pixel_parity(torch.from_numpy(out),
                  torch.from_numpy(api.decode(data, device="cpu")))


def test_decode_exceptions_and_foreign_sampling_on_cuda(cuda):
    two_level = (np.random.default_rng(3).integers(0, 2, (48, 64, 3)) * 255) \
        .astype(np.uint8)
    data = ref_encoder.encode(two_level, 95, "420")
    parsed = parser.parse_jpeg(data)
    pk = D.scan_packed(parsed, D.layout_from_parsed(parsed))
    assert pk is not None and pk[1].size > 0
    _pixel_parity(torch.from_numpy(api.decode(data, device="cuda")),
                  torch.from_numpy(api.decode(data, device="cpu")))
    lay = make_layout(32, 96, "411")
    blocks = np.random.default_rng(4).integers(-20, 20, (lay.n_scan, 64))
    qts = [np.full(64, 3, np.int32)] * 3
    before = (D.unfused_calls, recon.launches)
    out = D.reconstruct_pixels(lay, blocks, qts, device="cuda")
    assert (D.unfused_calls, recon.launches) == (before[0] + 1, before[1])
    _pixel_parity(torch.from_numpy(out), torch.from_numpy(
        D.reconstruct_pixels(lay, blocks, qts, device="cpu")))


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_decode_batch_on_cuda(cuda, mode):
    datas = [_decode_file(mode, 120, 136, s, optimize=bool(s % 2))
             for s in range(5)]
    counter = "launches_gray" if mode == "gray" else "launches"
    before = (getattr(recon, counter), recon.plain_calls)
    stacked = api.decode_batch(datas, to_device=True, device="cuda")
    assert getattr(recon, counter) == before[0] + 1
    chunks = api.decode_batch(datas, to_device=True, chunk=2, device="cuda")
    assert getattr(recon, counter) == before[0] + 4
    assert recon.plain_calls == before[1]
    assert stacked.device.type == "cuda" and stacked.shape[0] == 5
    assert [c.shape[0] for c in chunks] == [2, 2, 1]
    assert torch.equal(torch.cat(chunks), stacked)
    host = api.decode_batch(datas, chunk=3, device="cuda")
    for i, d in enumerate(datas):
        assert np.array_equal(host[i], stacked[i].cpu().numpy())
        assert np.array_equal(host[i], api.decode(d, device="cuda"))
    run, h2d = D.stage_recon(datas, chunk=2, device="cuda")
    assert h2d > 0 and torch.equal(torch.cat(run()), stacked)


def test_recon_on_a_cuda_tensor_never_takes_the_plain_version(cuda,
                                                              monkeypatch):
    """With the kernel library missing, a CUDA tensor raises: nothing gives
    way to recon_plain."""
    lay, _, _, (x4, q_rows) = _coefficients("420", 32, 48, 1, 30, 5)

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(recon.build, "library", no_library)
    before = recon.plain_calls
    with pytest.raises(RuntimeError, match="nvcc not found"):
        recon.fused_recon_rgb(x4.to(cuda), q_rows.to(cuda), lay)
    data = _decode_file("420", 32, 48, 1)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        api.decode(data, device="cuda")
    assert recon.plain_calls == before


# --- restart intervals, the repack and the separable K1 kernels, islow --------

DRI_CASES = [(120, 136, "420", 1), (120, 136, "420", 3), (61, 130, "420", 7),
             (64, 126, "422", 3), (48, 62, "444", 7), (100, 62, "gray", 3),
             (17, 23, "gray", 1), (128, 128, "gray", 16)]
WIDE_CASES = [(16, 8208, "420"), (8, 8200, "444")]   # one MCU row, past the gate


def _plan(h, w, sub, quality, dri):
    plan = engine.get_plan(h, w, sub, quality, "cuda", dri)
    return plan, (plan.layout, plan.kdct, plan.q), \
        plan.standard_tables


@pytest.mark.parametrize("h,w,sub,dri", DRI_CASES)
@pytest.mark.parametrize("w_blk", [8, 56])
def test_k1a_and_k1_kernels_with_restart_interval(cuda, h, w, sub, dri,
                                                  w_blk):
    """The predictor resets at every segment start, outputs are padded to
    whole segments with zero slots, and K1 holds the same coefficients."""
    imgs = np.stack([_frame(h, w, sub, seed=s) for s in (1, 2)])
    _, ops, tabs = _plan(h, w, sub, 75, dri)
    lay = ops[0]
    s_pad = lay.n_segments * lay.blocks_per_segment
    x = torch.from_numpy(imgs).to(cuda)
    buf, bits, zz = k1a_fused.fused_pixels_to_pack(x, *ops, tabs, w_blk,
                                                   return_zz=True)
    torch.cuda.synchronize()
    assert tuple(buf.shape) == (2, s_pad, w_blk) and \
        tuple(bits.shape) == (2, s_pad)
    ebuf, ebits = k1a_fused.entropy_plain(zz.to(torch.int32), lay, tabs,
                                          w_blk)
    assert torch.equal(ebits, bits) and torch.equal(ebuf, buf)
    assert not bits[:, lay.n_scan:].any() and not buf[:, lay.n_scan:].any()
    zz_k1 = k1_dct.fused_pixels_to_scan(x, *ops)
    assert tuple(zz_k1.shape) == (2, s_pad, 64)
    assert torch.equal(zz_k1[:, :lay.n_scan].reshape(-1), zz.reshape(-1))
    assert not zz_k1[:, lay.n_scan:].any()


@pytest.mark.parametrize("h,w,sub", CASES + WIDE_CASES)
def test_k1_repack_kernel_equals_row_kernel(cuda, h, w, sub):
    """The repack variant holds the row kernel's coefficients bit for bit
    (one arithmetic, two loaders), and is the default past the row gate."""
    imgs = np.stack([fixtures.synth_frame(h, w, seed=s) for s in (1, 2, 3)])
    _, ops, _ = _plan(h, w, sub, 75, 0)
    x = torch.from_numpy(imgs).to(cuda)
    before = (k1_dct.launches, k1_dct.launches_repack, k1_dct.plain_calls)
    rows = k1_dct.fused_pixels_to_scan(x, *ops, variant="rows")
    rep = k1_dct.fused_pixels_to_scan(x, *ops, variant="repack")
    torch.cuda.synchronize()
    assert (k1_dct.launches, k1_dct.launches_repack, k1_dct.plain_calls) == \
        (before[0] + 1, before[1] + 1, before[2])
    assert torch.equal(rows, rep)
    _only_knife_edges(rep, x, ops)
    wide = (h, w, sub) in WIDE_CASES
    assert k1_dct.k1_variant(ops[0]) == ("repack" if wide else "rows")
    k1_dct.fused_pixels_to_scan(x, *ops)
    assert k1_dct.launches_repack == before[1] + 1 + int(wide)


# one MCU, one tile (40 MCUs of 4:2:0 are 640 px, 32 are 512), one MCU more
# than a tile row, odd sizes, and row pitches 3*W that are a multiple of 16
# (64, 512, 528, 640, 656, 1040), of 8 (136), of 4 (1028 px: 3084), of 2
# (130, 62) or odd (53, 75)
SHARED_CASES = [(16, 16), (8, 8), (16, 512), (16, 528), (16, 640), (16, 656),
                (33, 1040), (40, 1028), (120, 136), (61, 130), (37, 53),
                (33, 75), (48, 62), (100, 1337)]


# the separable kernel's tiles: SEP_TILE MCUs of 4:2:0 (128 px), twice as
# many of 4:2:2 and four times as many of 4:4:4 (256 px); one tile a row and
# a tile plus one MCU (4:2:0: 144 px, 4:4:4: 264 px)
T_S = k1_dct.SEP_TILE
SEP_EDGES = [(16, 16 * T_S), (16, 16 * T_S + 16), (16, 32 * T_S),
             (16, 32 * T_S + 8)]
# the earlier frames at Q75 and Q95; every shared-transform edge and the
# separable tile's edges in the three samplings, without and with DRI 7
# (pad slots stay zero)
SEPARABLE_CASES = (
    [(h, w, sub, q, 0) for h, w, sub in CASES + WIDE_CASES[:1]
     for q in (75, 95)] +
    [(h, w, sub, 75, dri) for h, w in SHARED_CASES + SEP_EDGES
     for sub in ("420", "422", "444") for dri in (0, 7)])


@pytest.mark.parametrize("h,w,sub,quality,dri", SEPARABLE_CASES)
def test_k1_separable_kernel_vs_plain_and_k1(cuda, monkeypatch, h, w, sub,
                                             quality, dri):
    """The separable kernel against color_plain (they may differ only where
    the float64 value lies within 1e-4 of a rounding boundary) and against
    the dense K1 under the knife-edge policy; K1_DENSE = False selects it;
    the slots past the scan (restart padding) stay zero."""
    imgs = np.stack([fixtures.synth_frame(h, w, seed=s) for s in (1, 2, 3)])
    plan, ops, _ = _plan(h, w, sub, quality, dri)
    lay = ops[0]
    x = torch.from_numpy(imgs).to(cuda)
    before = (k1_dct.launches_color, k1_dct.plain_calls)
    zz = k1_dct.fused_pixels_to_scan(x, *ops, variant="separable",
                                     sep=plan.sep)
    torch.cuda.synchronize()
    assert (k1_dct.launches_color, k1_dct.plain_calls) == \
        (before[0] + 1, before[1])
    assert tuple(zz.shape) == (3, k1_dct.n_slots_padded(lay), 64)
    assert not zz[:, lay.n_scan:].any()
    plain = k1_dct.color_plain(x, lay, plan.sep, plan.q)
    d = zz != plain
    assert int((zz.int() - plain.int()).abs().max()) <= 1
    assert int(d.sum()) <= 1e-3 * d.numel()
    # the same transform in float64
    nb = lay.blocks_per_mcu - 2
    p = k1_dct.mcu_planar(x, lay).double()
    r, g, b = p[:, :, 0], p[:, :, 1], p[:, :, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168735892 * r + -0.331264108 * g + 0.5 * b
    cr = 0.5 * r + -0.418687589 * g + -0.081312411 * b
    kd, sc = plan.sep[:64].double(), plan.sep[64:].double()
    exact = torch.cat([(y.reshape(*y.shape[:2], nb, 64) @ kd).flatten(2),
                       cb @ sc, cr @ sc], dim=-1) / plan.q.double()
    dist = ((exact - exact.floor()) - 0.5).abs().reshape(3, lay.n_scan, 64)
    assert bool((dist[d[:, :lay.n_scan]] < 1e-4).all())
    dense = k1_dct.fused_pixels_to_scan(x, *ops, variant="rows")
    dd = (zz.int() - dense.int()).abs()
    assert int(dd.max()) <= 1
    assert float((dd > 0).double().mean()) <= max(KNIFE_EDGE_FRAC,
                                                  2.0 / dd.numel())
    monkeypatch.setattr(k1_dct, "K1_DENSE", False)
    assert torch.equal(plan.zz_scan(x)[0], zz)
    assert k1_dct.launches_color == before[0] + 2


@pytest.mark.parametrize("dri", [0, 1, 3, 7, 120])
@pytest.mark.parametrize("sub", ["420", "422", "444"])
@pytest.mark.parametrize("h,w", SHARED_CASES)
def test_shared_transform_kernels(cuda, h, w, sub, dri):
    """K1A's zz == K1 rows == K1 repack bit for bit; the kernels differ from
    the plain version only where the float64 value lies within 1e-4 of a
    rounding boundary; K1A's packed words and bits equal entropy_plain on
    the kernel's own zz exactly (the DC predictor across tiles, MCU rows and
    restart segments)."""
    imgs = np.stack([fixtures.synth_frame(h, w, seed=s) for s in (4, 5)])
    _, ops, tabs = _plan(h, w, sub, 75, dri)
    lay = ops[0]
    x = torch.from_numpy(imgs).to(cuda)
    before = (k1_dct.plain_calls, k1a_fused.plain_calls)
    rows = k1_dct.fused_pixels_to_scan(x, *ops, variant="rows")
    rep = k1_dct.fused_pixels_to_scan(x, *ops, variant="repack")
    buf, bits, zz = k1a_fused.fused_pixels_to_pack(x, *ops, tabs, 8,
                                                   return_zz=True)
    torch.cuda.synchronize()
    assert torch.equal(rows, rep)
    assert torch.equal(rows[:, :lay.n_scan].reshape(-1), zz.reshape(-1))
    assert not rows[:, lay.n_scan:].any()
    _only_knife_edges(zz, x, ops)
    ebuf, ebits = k1a_fused.entropy_plain(zz.to(torch.int32), lay, tabs, 8)
    assert torch.equal(ebits, bits) and torch.equal(ebuf, buf)
    assert (k1_dct.plain_calls, k1a_fused.plain_calls) == before


def test_shared_transform_takes_an_unaligned_batch(cuda):
    """A batch whose first byte is not 16-byte aligned (a view into a larger
    buffer) takes the narrower loads and holds the same coefficients."""
    h, w = 40, 528
    imgs = np.stack([fixtures.synth_frame(h, w, seed=s) for s in (6, 7)])
    _, ops, tabs = _plan(h, w, "420", 75, 0)
    x = torch.from_numpy(imgs).to(cuda)
    want = k1_dct.fused_pixels_to_scan(x, *ops, variant="rows")
    for off in (4, 1):
        flat = torch.zeros(x.numel() + 16, dtype=torch.uint8, device=cuda)
        view = flat[off:off + x.numel()].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 == off and view.is_contiguous()
        assert torch.equal(want, k1_dct.fused_pixels_to_scan(
            view, *ops, variant="rows"))
        _, _, zz = k1a_fused.fused_pixels_to_pack(view, *ops, tabs, 8,
                                                  return_zz=True)
        assert torch.equal(want.reshape(-1), zz.reshape(-1))


# --- the gray transform of gray K1 and gray K1A: every loader branch ---------

T_G = k1_dct.GRAY_TILE
# widths a multiple of 16 (160; 8 * T_G, one tile a row), of 4 only (100,
# 8 * T_G + 4) and odd (61, 1337); one tile plus one block a row
# (8 * T_G + 8); heights no multiple of 8 (17, 37, 5); a single block (8 x 8,
# and 5 x 7, all replicate pad)
GRAY_EDGES = [(16, 160), (40, 100), (37, 61), (17, 1337), (8, 8), (5, 7),
              (24, 8 * T_G), (24, 8 * T_G + 8), (17, 8 * T_G + 4)]


def _gray_counts():
    return (k1_dct.launches_gray, k1a_fused.launches_gray,
            k1_dct.plain_calls, k1a_fused.plain_calls)


def _hold_gray(x, dri, w_blk=8):
    """Gray K1 and gray K1A on x: equal coefficients, each launched once and
    no plain version called, the coefficients within the knife-edge policy
    of the plain version, K1A's words and bits equal to entropy_plain on its
    own coefficients (the DC predictor across tiles, rows and segments), the
    pad slots zero. Returns K1's coefficients."""
    h, w = x.shape[1:]
    _, ops, tabs = _plan(h, w, "gray", 75, dri)
    lay = ops[0]
    before = _gray_counts()
    zz_k1 = k1_dct.fused_pixels_to_scan(x, *ops)
    buf, bits, zz = k1a_fused.fused_pixels_to_pack(x, *ops, tabs, w_blk,
                                                   return_zz=True)
    torch.cuda.synchronize()
    assert _gray_counts() == (before[0] + 1, before[1] + 1, *before[2:])
    assert torch.equal(zz_k1[:, :lay.n_scan].reshape(-1), zz.reshape(-1))
    assert not zz_k1[:, lay.n_scan:].any()
    _only_knife_edges(zz, x, ops)
    ebuf, ebits = k1a_fused.entropy_plain(zz.to(torch.int32), lay, tabs,
                                          w_blk)
    assert torch.equal(ebits, bits) and torch.equal(ebuf, buf)
    assert not bits[:, lay.n_scan:].any() and not buf[:, lay.n_scan:].any()
    return zz_k1


@pytest.mark.parametrize("h,w", GRAY_EDGES)
def test_gray_kernels_at_tile_and_image_edges(cuda, h, w):
    imgs = np.stack([_frame(h, w, "gray", seed=s) for s in (3, 4)])
    _hold_gray(torch.from_numpy(imgs).to(cuda), 0)


@pytest.mark.parametrize("dri", [1, 3, 7, 240])
@pytest.mark.parametrize("h,w", [(40, 8 * T_G + 8), (24, 1920)])
def test_gray_kernels_with_restart_interval(cuda, h, w, dri):
    """Segment starts at tile starts, inside tiles and at row starts: rows of
    T_G + 1 blocks (a tile and one block) and of 240 (DRI 240: every row)."""
    imgs = np.stack([_frame(h, w, "gray", seed=s) for s in (5, 6)])
    _hold_gray(torch.from_numpy(imgs).to(cuda), dri)


def test_gray_kernels_take_an_unaligned_batch(cuda):
    """A batch whose first byte is 4- or 1-byte aligned takes the narrower
    loads and holds the coefficients of the aligned one."""
    h, w = 24, 8 * T_G + 16
    imgs = np.stack([_frame(h, w, "gray", seed=s) for s in (6, 7)])
    x = torch.from_numpy(imgs).to(cuda)
    want = _hold_gray(x, 0)
    for off in (4, 1):
        flat = torch.zeros(x.numel() + 16, dtype=torch.uint8, device=cuda)
        view = flat[off:off + x.numel()].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 == off and view.is_contiguous()
        assert torch.equal(want, _hold_gray(view, 0))


def _rst_markers(scan: bytes) -> list[int]:
    return [scan[i + 1] for i in range(len(scan) - 1)
            if scan[i] == 0xFF and 0xD0 <= scan[i + 1] <= 0xD7]


@pytest.mark.parametrize("h,w,mode,dri", DRI_CASES)
@pytest.mark.parametrize("optimize", [False, True])
def test_restart_interval_round_trip_on_cuda(cuda, h, w, mode, dri,
                                             optimize):
    """A DRI file from the card: RSTn count and numbering, coefficients
    equal the kernel's, api.decode on the card gives the CPU decode's pixels
    (the recon kernel's limit), and the bytes equal the CPU encode's
    wherever the coefficients agree."""
    img = _frame(h, w, mode)
    sub = "420" if mode == "gray" else mode
    kw = dict(quality=75, subsampling=sub, restart_interval=dri,
              optimize=optimize)
    data = api.encode(img, device="cuda", **kw)
    p = parser.parse_jpeg(data)
    plan, ops, _ = _plan(h, w, mode, 75, dri)
    lay = ops[0]
    assert p.restart_interval == dri
    assert _rst_markers(p.scan_data) == \
        [0xD0 + (i & 7) for i in range(lay.n_segments - 1)]
    x = torch.from_numpy(img)[None].to(cuda)
    zz = k1_dct.fused_pixels_to_scan(x, *ops)[0, :lay.n_scan]
    expect = np.empty((lay.n_scan, 64), np.int32)
    expect[lay.scan_flat] = zz.cpu().numpy()
    np.testing.assert_array_equal(_decode(data, lay), expect)
    out = api.decode(data, to_device=True)
    _pixel_parity(out, torch.from_numpy(api.decode(data, device="cpu")).to(
        cuda))
    cpu_plan = engine.get_plan(h, w, mode, 75, "cpu", dri)
    if torch.equal(cpu_plan.zz_scan(torch.from_numpy(img)[None])[0][0,
                   :lay.n_scan], zz.cpu()):
        assert data == api.encode(img, device="cpu", **kw)


def test_encode_batch_restart_interval_on_cuda(cuda):
    frames = np.stack([fixtures.synth_frame(64, 96, seed=s)
                       for s in (1, 2, 3)])
    before = (k1a_fused.plain_calls, seg_merge.plain_calls,
              block_pack.plain_calls, k1_dct.plain_calls)
    for kw in (dict(restart_interval=4), dict(restart_interval=5,
                                              optimize=True)):
        out = mesh.encode_batch(torch.from_numpy(frames).to(cuda), 75,
                                device="cuda", **kw)
        assert out == [api.encode(f, 75, device="cuda", **kw) for f in frames]
    assert (k1a_fused.plain_calls, seg_merge.plain_calls,
            block_pack.plain_calls, k1_dct.plain_calls) == before


@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("dri,optimize", [(0, False), (3, False), (0, True),
                                          (5, True)])
def test_islow_on_cuda_equals_cpu_and_reference(cuda, mode, dri, optimize):
    """The integer pipeline is exact, so the card's file equals the CPU's
    and the numpy reference's (ref.islow + ref.encoder) byte for byte."""
    from jpgenc_tpu_torch.engine import EOI, jfif_headers
    from jpgenc_tpu_torch.ref import islow as ref_islow
    img = _frame(61, 130, mode)
    sub = "420" if mode == "gray" else mode
    kw = dict(quality=75, subsampling=sub, restart_interval=dri,
              optimize=optimize, dct_method="islow")
    before = block_pack.launches
    data = api.encode(img, device="cuda", **kw)
    assert block_pack.launches > before
    assert data == api.encode(img, device="cpu", **kw)
    assert mesh.encode_batch(img[None], device="cuda", **kw) == [data]
    lay = make_layout(61, 130, mode, dri)
    qt = list(engine.qtables_for_quality(75))
    blocks = ref_islow.image_to_zigzag_islow(img, lay, qt)
    if optimize:
        n_tabs = 1 if mode == "gray" else 2
        dc_t, ac_t = engine.tables_from_freq(
            ref_encoder.symbol_histogram(lay, blocks), n_tabs)
    else:
        dc_t, ac_t = ref_encoder.standard_tables()
    assert data == (jfif_headers(lay, 75, dc_t, ac_t)
                    + ref_encoder.entropy_scan(lay, blocks, dc_t, ac_t) + EOI)


# --- distribution on the card: stripes and device lists ------------------------

STRIPE_CASES = [((128, 128), 4, {"restart_interval": 16}),       # gray, even
                ((120, 136, 3), 3, {}),                          # ragged
                ((120, 136, 3), 4, {"optimize": True}),
                ((56, 64), 5, {"restart_interval": 8}),          # pure pad
                ((61, 48, 3), 3, {"optimize": True, "dct_method": "islow"})]


@pytest.mark.parametrize("shape,n,kw", STRIPE_CASES)
def test_encode_striped_on_cuda_equals_unstriped(cuda, shape, n, kw):
    img = fixtures.synth_frame(shape[0], shape[1], seed=61)
    if len(shape) == 2:
        img = img[..., 0].copy()
    data = mesh.encode_striped(img, n, devices=["cuda", "cuda"],
                               device="cuda", **kw)
    r = parser.parse_jpeg(data).restart_interval
    assert kw.get("restart_interval", r) == r
    assert data == api.encode(img, device="cuda",
                              **{**kw, "restart_interval": r})
    assert data == mesh.encode_striped(img, n, device="cuda", **kw)


@pytest.mark.parametrize("kw", [{}, {"optimize": True},
                                {"dct_method": "islow"}])
def test_device_lists_on_cuda(cuda, kw):
    imgs = np.stack([fixtures.synth_frame(48, 80, seed=70 + i)
                     for i in range(5)])
    single = mesh.encode_batch(imgs, device="cuda", **kw)
    for devs in (["cuda", "cuda"], ["cuda"] * 3):
        assert mesh.encode_batch(imgs, devices=devs, device="cuda",
                                 **kw) == single
    pix = mesh.decode_batch(single, devices=["cuda", "cuda"], device="cuda")
    assert all(p.is_cuda for p in pix)
    assert torch.equal(torch.cat(pix),
                       api.decode_batch(single, to_device=True,
                                        device="cuda"))
    assert mesh.encode_batch(pix, devices=["cuda", "cuda"], device="cuda") \
        == mesh.encode_batch(torch.cat(pix), device="cuda")
