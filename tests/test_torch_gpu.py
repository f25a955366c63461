"""GPU lane: the CUDA kernels against their plain PyTorch versions on the
card, at the CPU tests' sizes. Every test here is marked `gpu` and skips
without CUDA. The card's machine has no JAX, and tests/conftest.py imports
it, so run this file there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

This file imports no JAX and no conftest fixture.
"""
import numpy as np
import pytest
import torch

from jpgenc_tpu_torch import api, engine, native
from jpgenc_tpu_torch.container import parser
from jpgenc_tpu_torch.layout import make_layout
from jpgenc_tpu_torch.ops import entropy
from jpgenc_tpu_torch.ops.cuda import block_pack, k1_dct, k1a_fused, seg_merge
from jpgenc_tpu_torch.parallel import mesh
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
    return (plan.layout, plan.m, plan.bias, plan.q), \
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


@pytest.mark.parametrize("n_seg", [1, 3])
@pytest.mark.parametrize("w_blk", [8, 24])
@pytest.mark.parametrize("capped", [False, True])
def test_seg_merge_kernel_vs_plain(cuda, n_seg, w_blk, capped):
    buf, bits = _random_blocks(n_seg * 200, w_blk, seed=n_seg + w_blk)
    cap = 3000 if capped else None
    pw, pb = seg_merge.seg_merge_plain(buf, bits, n_seg, w_blk, cap)
    kw, kb = seg_merge.fused_seg_merge(buf.to(cuda), bits.to(cuda), n_seg,
                                       w_blk, cap)
    torch.cuda.synchronize()
    assert torch.equal(kb.cpu(), pb) and torch.equal(kw.cpu(), pw)


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
    lay, m, bias, q = ops
    plain = k1_dct.transform_plain(x, *ops)
    zz = zz.reshape(plain.shape).to(torch.int32)
    d = zz != plain
    assert int((zz - plain).abs().max()) <= 1
    assert int(d.sum()) <= 1e-3 * d.numel()
    xb = k1_dct.mcu_bytes(x, lay).double()
    exact = ((xb - 128.0) @ m.double() if lay.is_gray
             else xb @ m.double() + bias.double()) / q.double()
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
    gpu = entropy.symbol_histogram(
        zc, block_pack.slot_metadata(prev.to(cuda), zc),
        *(a.to(cuda) for a in args))
    assert torch.equal(gpu.cpu(), cpu)


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
