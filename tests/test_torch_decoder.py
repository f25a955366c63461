"""The port's decoder (jpgenc_tpu_torch/decoder.py, api.decode,
api.decode_batch) against the JAX package on the CPU, at small sizes, from
literal seeds.

Pixels are compared under the `pixel_parity` rule: both sides run the same
float32 reconstruction with one reassociated 64-term sum, so they agree
except on rounding knife edges: max |diff| <= 1 on at most max(1e-3, 4/size)
of the bytes. Coefficients and index tensors are compared exactly.
"""
import functools
import io

import numpy as np
import pytest
import torch
from PIL import Image

import jpgenc_tpu.api as japi
import jpgenc_tpu.decoder as JD
from jpgenc_tpu.ref import encoder as jref_encoder
from jpgenc_tpu_torch import api, native
from jpgenc_tpu_torch import decoder as D
from jpgenc_tpu_torch.container.jfif import build_headers
from jpgenc_tpu_torch.container.parser import parse_jpeg
from jpgenc_tpu_torch.layout import make_layout
from jpgenc_tpu_torch.ops.cuda import recon
from jpgenc_tpu_torch.ref import decoder as ref_decoder
from jpgenc_tpu_torch.ref import encoder as ref_encoder
from jpgenc_tpu_torch import tables as T
from jpgenc_tpu_torch.utils.metrics import psnr

H, W = 40, 56


def pixel_parity(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.uint8
    d = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1, f"max diff {d.max()}"
    frac = (d > 0).sum() / d.size
    assert frac <= max(1e-3, 4 / d.size), f"mismatch fraction {frac}"


def _img(seed, h=H, w=W, gray=False, sigma=45):
    rng = np.random.default_rng(seed)
    shape = (h, w) if gray else (h, w, 3)
    return np.clip(rng.normal(128, sigma, shape), 0, 255).astype(np.uint8)


def _two_level(seed, h=48, w=64):
    """Two-level noise: at Q95 its coefficients pass +-127, so the packed
    stream carries exceptions."""
    return (np.random.default_rng(seed).integers(0, 2, (h, w, 3)) * 255) \
        .astype(np.uint8)


def _pillow(img, q, subsampling=None, **kw):
    buf = io.BytesIO()
    if subsampling is not None:
        kw["subsampling"] = subsampling
    Image.fromarray(img).save(buf, "JPEG", quality=q, **kw)
    return buf.getvalue()


@functools.lru_cache(maxsize=None)
def _reference_file(mode, optimize, dri):
    """A file from jpgenc_tpu.api.encode and the reference's decode of it."""
    img = _img(11, gray=mode == "gray")
    data = japi.encode(img, 75, "420" if mode == "gray" else mode,
                       restart_interval=dri, optimize=optimize)
    return data, japi.decode(data)


def _foreign_file(img, mode, quality=75, restart_interval=0):
    """A file in a sampling the encoders do not emit, from the
    factor-general numpy pieces (as tests/test_foreign_sampling.py)."""
    lay = make_layout(img.shape[0], img.shape[1], mode, restart_interval)
    qts = [T.scale_qtable(T.QTABLE_LUMA, quality),
           T.scale_qtable(T.QTABLE_CHROMA, quality)]
    zz = ref_encoder.image_to_zigzag(img, lay, [qts[c.qtab]
                                                for c in lay.comps])
    dc_t, ac_t = ref_encoder.standard_tables()
    scan = ref_encoder.entropy_scan(lay, zz, dc_t, ac_t)
    return build_headers(lay, qts, dc_t, ac_t) + scan + b"\xff\xd9", zz


# --- (c) api.decode against the reference's ---------------------------------

@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("optimize,dri", [(False, 0), (True, 0), (False, 3)],
                         ids=["standard", "optimize", "dri3"])
def test_decode_files_of_the_reference_encoder(mode, optimize, dri):
    data, ref = _reference_file(mode, optimize, dri)
    out = api.decode(data, device="cpu")
    pixel_parity(out, ref)
    d = np.abs(out.astype(int) - ref_decoder.exact_decode(data).astype(int))
    assert d.max() <= 3


@pytest.mark.parametrize("sub,q,h,w,kw", [
    (2, 75, 40, 64, {}), (2, 50, 61, 66, {}), (1, 90, 33, 64, {}),
    (0, 35, 24, 40, {}), (None, 80, 30, 50, {}),
    (2, 92, 48, 72, {"restart_marker_blocks": 2}),
    (1, 75, 32, 48, {"optimize": True}),
], ids=["420", "420-odd", "422", "444", "gray", "420-dri", "422-optimize"])
def test_decode_pillow_files(sub, q, h, w, kw):
    img = _img(12, h, w, gray=sub is None, sigma=50)
    data = _pillow(img, q, sub, progressive=False, **kw)
    out = api.decode(data, device="cpu")
    pixel_parity(out, japi.decode(data))
    pil = np.asarray(Image.open(io.BytesIO(data)))
    assert out.shape == pil.shape and psnr(out, pil) > 30.0


@pytest.mark.parametrize("mode,dims,dri", [
    ("411", (32, 96), 0), ("440", (29, 32), 0), ("410", (48, 64), 0),
    ("411", (32, 96), 2)])
def test_decode_foreign_samplings_as_torch_ops(mode, dims, dri):
    """4:1:1 / 4:4:0 / 4:1:0 take no kernel: they run `pixel_fn` and are
    counted as unfused."""
    data, zz = _foreign_file(_img(13, *dims, sigma=40), mode,
                             restart_interval=dri)
    before = (D.unfused_calls, recon.plain_calls)
    out = api.decode(data, device="cpu")
    assert (D.unfused_calls, recon.plain_calls) == (before[0] + 1, before[1])
    pixel_parity(out, JD.decode(data))
    lay, blocks, _ = D.decode_to_coefficients(data)
    assert lay.subsampling == mode
    np.testing.assert_array_equal(blocks, zz)
    d = np.abs(out.astype(int) - ref_decoder.exact_decode(data).astype(int))
    assert d.max() <= 3


def test_decode_resolves_quant_tables_per_component():
    """A foreign file may give any Tq to any component: here chroma uses
    slot 2 and luma slot 1."""
    img = _img(14)
    lay = make_layout(H, W, "420")
    qts = {1: T.scale_qtable(T.QTABLE_LUMA, 60),
           2: T.scale_qtable(T.QTABLE_CHROMA, 85)}
    comp_q = [qts[1], qts[2], qts[2]]
    zz = ref_encoder.image_to_zigzag(img, lay, comp_q)
    dc_t, ac_t = ref_encoder.standard_tables()
    data = bytearray(build_headers(lay, [qts[1], qts[2]], dc_t, ac_t)
                     + ref_encoder.entropy_scan(lay, zz, dc_t, ac_t)
                     + b"\xff\xd9")
    # renumber DQT slots 0/1 -> 1/2 and the SOF0 Tq fields with them
    i = 2
    while data[i + 1] != 0xDA:
        n = (data[i + 2] << 8) | data[i + 3]
        if data[i + 1] == 0xDB:
            j = i + 4
            while j < i + 2 + n:
                data[j] += 1
                j += 65
        elif data[i + 1] == 0xC0:
            for c in range(3):
                data[i + 10 + 3 * c + 2] += 1
        i += 2 + n
    data = bytes(data)
    parsed = parse_jpeg(data)
    assert sorted(parsed.qtables) == [1, 2]
    assert [c.qtab for c in parsed.comps] == [1, 2, 2]
    out = api.decode(data, device="cpu")
    np.testing.assert_array_equal(
        out, recon.pixels_from_blocks(
            lay, torch.from_numpy(zz),
            [torch.from_numpy(q.reshape(64).astype(np.int32))
             for q in comp_q]).numpy())
    pixel_parity(out, japi.decode(data))


def test_decode_rejects_an_undefined_quant_table():
    data = bytearray(jref_encoder.encode(_img(15), 75, "444"))
    i = data.index(b"\xff\xc0")
    data[i + 10 + 2] = 3                       # luma Tq -> slot 3
    with pytest.raises(ValueError, match="undefined quant table"):
        api.decode(bytes(data), device="cpu")


# --- (e) decode_to_coefficients ----------------------------------------------

@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("optimize,dri", [(False, 0), (True, 0), (False, 3)],
                         ids=["standard", "optimize", "dri3"])
def test_decode_to_coefficients_is_bit_identical(mode, optimize, dri):
    data, _ = _reference_file(mode, optimize, dri)
    lay, blocks, qts = D.decode_to_coefficients(data)
    jlay, jblocks, jqts = JD.decode_to_coefficients(data)
    assert blocks.dtype == jblocks.dtype
    np.testing.assert_array_equal(blocks, jblocks)
    assert sorted(qts) == sorted(jqts)
    for k in qts:
        np.testing.assert_array_equal(qts[k], jqts[k])
    assert (lay.height, lay.width, lay.subsampling, lay.restart_interval) \
        == (jlay.height, jlay.width, jlay.subsampling, jlay.restart_interval)


@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("optimize", [False, True])
def test_decode_to_coefficients_returns_the_port_encoders(mode, optimize):
    """The core invariant on the port's own encoder: the file holds the
    coefficients its K1 stage made (plain version here)."""
    from jpgenc_tpu_torch import engine
    img = _img(16, gray=mode == "gray")
    data = api.encode(img, 75, "420" if mode == "gray" else mode,
                      optimize=optimize, device="cpu")
    lay, blocks, _ = D.decode_to_coefficients(data)
    plan = engine.get_plan(H, W, mode, 75, "cpu")
    zz, _, _ = plan.zz_and_histogram(torch.from_numpy(img[None]))
    want = np.empty((lay.n_scan, 64), np.int32)
    want[lay.scan_flat] = zz[0].numpy()
    np.testing.assert_array_equal(blocks, want)
    x4, _ = D.coefficients_from_reference(lay, blocks, _qts(data))
    np.testing.assert_array_equal(x4.reshape(-1, 64).numpy(), zz[0].numpy())


def _qts(data):
    return D._qts_of(parse_jpeg(data))


# --- (f) the pure-Python scan reader ----------------------------------------

@pytest.mark.parametrize("mode,dri", [("420", 0), ("422", 2), ("gray", 3)])
def test_python_scan_reader_equals_native(mode, dri, monkeypatch):
    assert native.available()
    img = _img(17, 24, 32, gray=mode == "gray")
    data = jref_encoder.encode(img, 80, "420" if mode == "gray" else mode,
                               restart_interval=dri)
    parsed = parse_jpeg(data)
    lay = D.layout_from_parsed(parsed)
    fast = D.decode_scan_to_blocks(parsed, lay)
    monkeypatch.setattr(native, "available", lambda: False)
    py = D.decode_scan_to_blocks(parsed, lay)
    monkeypatch.undo()
    np.testing.assert_array_equal(py, fast)
    np.testing.assert_array_equal(py, JD.decode_to_coefficients(data)[1])


def test_python_scan_reader_is_the_fallback(monkeypatch):
    data = jref_encoder.encode(_img(18, 16, 24), 70, "444")
    want = D.decode_to_coefficients(data)[1]
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(D.decode_to_coefficients(data)[1], want)
    parsed = parse_jpeg(data)
    assert D.scan_packed(parsed, D.layout_from_parsed(parsed)) is None
    out = api.decode(data, device="cpu")          # pairs from the reader
    monkeypatch.undo()
    np.testing.assert_array_equal(out, api.decode(data, device="cpu"))


# --- (b) the densify ---------------------------------------------------------

def _densify_files(kind):
    if kind == "exceptions":
        return [_pillow(_two_level(s), 95, 2) for s in (20, 21, 22)]
    if kind == "dri":
        return [jref_encoder.encode(_img(s), 85, "420", restart_interval=2)
                for s in (23, 24, 25)]
    if kind == "gray":
        return [jref_encoder.encode(_img(s, gray=True), 75)
                for s in (26, 27, 28)]
    return [_foreign_file(_img(s, 32, 96), "411")[0] for s in (29, 30, 31)]


@pytest.mark.parametrize("kind", ["exceptions", "dri", "gray", "411"])
def test_every_upload_form_densifies_to_the_same_tensor(kind):
    """packed, chunk-flat packed, pairs and dense end in the identical
    int16 MCU-major tensor, which is blocks[scan_flat] of the reference's
    decode_to_coefficients."""
    datas = _densify_files(kind)
    parsed = [parse_jpeg(d) for d in datas]
    lay = D.layout_from_parsed(parsed[0])
    n64 = lay.n_scan * 64
    want = np.stack([JD.decode_to_coefficients(d)[1][np.asarray(lay.scan_flat)]
                     for d in datas]).astype(np.int16)
    want = want.reshape(3, lay.mcus_y, lay.mcus_x, -1)
    packed = [D.scan_packed(p, lay) for p in parsed]
    assert all(p is not None for p in packed)
    if kind == "exceptions":
        assert all(p[1].size > 0 for p in packed), "fixture has no escapes"
    q = np.ones((3, want.shape[-1]), np.float32)

    def dev(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a))
                     for a in arrays)

    # packed, one image
    for f in range(3):
        scan = (packed[f][0], D._scan_space_eidx(packed[f][1], lay),
                packed[f][2])
        x4 = D._densify(lay, "packed", dev(scan), 1)
        assert x4.dtype == torch.int16
        np.testing.assert_array_equal(x4[0].numpy(), want[f])
        # padded as the reference pads: hops and exception pads walk past
        # the end and drop
        mp, exc = D._pad_packed(*scan, scan[0].shape[0] + 300,
                                scan[1].size + 7, n64)
        eidx = (exc[0].astype(np.int64) & 0xFFFF) | \
            (exc[1].astype(np.int64) << 16)
        x4 = D._densify(lay, "packed", dev((mp, eidx, exc[2])), 1)
        np.testing.assert_array_equal(x4[0].numpy(), want[f])
    # chunk-flat packed, whatever form the size race picks
    job = D._job_from_packed(lay, packed, q)
    np.testing.assert_array_equal(
        D._densify(lay, job.form, dev(job.arrays), 3).numpy(), want)
    scan3 = [(m, D._scan_space_eidx(e, lay), v) for m, e, v in packed]
    flat3 = D._flatten_packed(scan3, n64, n64)
    np.testing.assert_array_equal(
        D._densify(lay, "packed", dev(flat3), 3).numpy(), want)
    # pairs, from the native pair decoder and from the packed stream
    for pairs in ([D.scan_pairs(p, lay) for p in parsed],
                  [D._pairs_from_packed(p, lay) for p in packed]):
        idx = np.concatenate([D._scan_space_eidx(i, lay) + f * n64
                              for f, (i, _) in enumerate(pairs)])
        val = np.concatenate([v for _, v in pairs]).astype(np.int16)
        np.testing.assert_array_equal(
            D._densify(lay, "pairs", dev((idx, val)), 3).numpy(), want)
        job = D._job_from_pairs(lay, pairs, q)
        assert job.form == ("pairs" if 6 * idx.size < 2 * 3 * n64
                            else "dense")
        np.testing.assert_array_equal(
            D._densify(lay, job.form, dev(job.arrays), 3).numpy(), want)
    # dense
    dense = np.zeros(3 * n64, np.int16)
    dense[idx] = val
    np.testing.assert_array_equal(
        D._densify(lay, "dense", dev((dense,)), 3).numpy(), want)
    with pytest.raises(ValueError, match="unknown upload form"):
        D._densify(lay, "sparse", (), 3)


def test_dense_content_takes_the_dense_upload():
    """Noise at Q100 has few zeros: packed loses the size race and the
    chunk uploads the dense tensor, with the same pixels."""
    noise = np.random.default_rng(32).integers(0, 256, (32, 48, 3), np.uint8)
    data = jref_encoder.encode(noise, 100, "444")
    parsed = parse_jpeg(data)
    lay = D.layout_from_parsed(parsed)
    job = D._single_job(parsed, lay)
    assert job.form == "dense"
    assert job.h2d_bytes == 2 * lay.n_scan * 64 + 4 * 192
    pixel_parity(api.decode(data, device="cpu"), japi.decode(data))
    sparse = D._single_job(parse_jpeg(jref_encoder.encode(_img(33), 50)),
                           make_layout(H, W, "420"))
    assert sparse.form == "packed"


def test_out_of_range_indices_fall_into_the_sink():
    idx = torch.tensor([0, 5, 9, 10, 11, 2**40, -3])
    val = torch.arange(1, 8, dtype=torch.int16)
    got = D._densify_pairs(idx, val, 10)
    assert got.shape == (10,)
    assert got.tolist() == [1, 0, 0, 0, 0, 2, 0, 0, 0, 3]


# --- (d) decode_batch ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _batch(mode):
    imgs = [_img(40 + s, gray=mode == "gray") for s in range(5)]
    datas = [jref_encoder.encode(im, 75, "420" if mode == "gray" else mode,
                                 optimize=bool(s % 2))
             for s, im in enumerate(imgs)]
    return datas, [api.decode(d, device="cpu") for d in datas]


@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("chunk", [None, 2, 5, 8])
def test_decode_batch_equals_per_image_decode(mode, chunk):
    datas, singles = _batch(mode)
    outs = api.decode_batch(datas, chunk=chunk, device="cpu")
    assert isinstance(outs, list) and len(outs) == 5
    for o, s in zip(outs, singles):
        assert isinstance(o, np.ndarray)
        np.testing.assert_array_equal(o, s)


@pytest.mark.parametrize("mode", ["420", "gray"])
def test_decode_batch_return_types(mode):
    datas, singles = _batch(mode)
    stacked = api.decode_batch(datas, to_device=True, device="cpu")
    assert isinstance(stacked, torch.Tensor) and stacked.dtype == torch.uint8
    assert stacked.device.type == "cpu"
    assert tuple(stacked.shape) == (5,) + singles[0].shape
    np.testing.assert_array_equal(stacked.numpy(), np.stack(singles))
    for chunk, sizes in ((2, [2, 2, 1]), (5, [5]), (9, [5])):
        chunks = api.decode_batch(datas, to_device=True, chunk=chunk,
                                  device="cpu")
        assert isinstance(chunks, list)
        assert [c.shape[0] for c in chunks] == sizes
        np.testing.assert_array_equal(torch.cat(chunks).numpy(),
                                      np.stack(singles))
    one = api.decode(datas[0], to_device=True, device="cpu")
    assert isinstance(one, torch.Tensor) and one.dtype == torch.uint8
    np.testing.assert_array_equal(one.numpy(), singles[0])
    assert api.decode_batch([], device="cpu") == []


def test_decode_batch_against_the_reference():
    datas, _ = _batch("420")
    for o, r in zip(api.decode_batch(datas, chunk=2, device="cpu"),
                    japi.decode_batch(datas, chunk=2)):
        pixel_parity(o, r)


@pytest.mark.parametrize("what", ["restart_interval", "size", "sampling"])
def test_decode_batch_mixed_geometry_goes_per_image(what):
    img = _img(50)
    a = jref_encoder.encode(img, 75, "420")
    b = {"restart_interval": lambda: jref_encoder.encode(
             img, 75, "420", restart_interval=2),
         "size": lambda: jref_encoder.encode(img[:32], 75, "420"),
         "sampling": lambda: jref_encoder.encode(img, 75, "422")}[what]()
    assert D._recon_jobs([a, b], None) is None
    outs = api.decode_batch([a, b, a], device="cpu")
    for o, d in zip(outs, (a, b, a)):
        np.testing.assert_array_equal(o, api.decode(d, device="cpu"))
    with pytest.raises(ValueError, match="same-geometry"):
        api.decode_batch([a, b], to_device=True, device="cpu")
    with pytest.raises(ValueError, match="same-geometry"):
        D.stage_recon([a, b], device="cpu")


def test_decode_batch_with_frames_that_lack_a_packed_stream(monkeypatch):
    """When the native packed decoder gives up on a frame (None), that
    frame is decoded to pairs and the chunk takes the pairs form."""
    datas, singles = _batch("422")
    real = D.scan_packed
    calls = []

    def flaky(parsed, layout, n_threads=0):
        calls.append(1)
        return None if len(calls) % 2 else real(parsed, layout, n_threads)

    monkeypatch.setattr(D, "scan_packed", flaky)
    outs = api.decode_batch(datas, chunk=2, device="cpu")
    for o, s in zip(outs, singles):
        np.testing.assert_array_equal(o, s)


def test_stage_recon_counts_the_upload_and_runs_the_device_half():
    datas, singles = _batch("420")
    run, h2d = D.stage_recon(datas, chunk=2, device="cpu")
    lay = make_layout(H, W, "420")
    jobs = [t() for t in D._recon_jobs(datas, 2)[1]]
    assert h2d == sum(sum(a.nbytes for a in j.arrays) + j.nb * 384 * 4
                      for j in jobs)
    for _ in range(2):
        outs = run()
        assert [o.shape[0] for o in outs] == [2, 2, 1]
        np.testing.assert_array_equal(torch.cat(outs).numpy(),
                                      np.stack(singles))
    assert lay.blocks_per_mcu * 64 == 384
    with pytest.raises(ValueError, match="chunk must be at least 1"):
        D.stage_recon(datas, chunk=0, device="cpu")


def test_reconstruct_pixels_takes_dict_and_per_component_tables():
    data, ref = _reference_file("420", False, 0)
    lay, blocks, qts = D.decode_to_coefficients(data)
    out = D.reconstruct_pixels(lay, blocks, qts, device="cpu")
    np.testing.assert_array_equal(out, api.decode(data, device="cpu"))
    per_comp = [qts[c.qtab] for c in lay.comps]
    dev = D.reconstruct_pixels(lay, blocks, per_comp, to_device=True,
                               device="cpu")
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), out)
    pixel_parity(out, JD.reconstruct_pixels(
        JD.layout_from_parsed(JD.parse_jpeg(data)), blocks, qts))


@pytest.mark.parametrize("fn", ["decode", "decode_batch", "stage_recon",
                                "reconstruct_pixels"])
def test_cuda_is_the_default_and_raises_without_a_card(fn):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    data, _ = _reference_file("444", False, 0)
    with pytest.raises(RuntimeError, match="is_available"):
        if fn == "decode":
            api.decode(data)
        elif fn == "decode_batch":
            api.decode_batch([data, data])
        elif fn == "stage_recon":
            D.stage_recon([data])
        else:
            lay, blocks, qts = D.decode_to_coefficients(data)
            D.reconstruct_pixels(lay, blocks, qts)
