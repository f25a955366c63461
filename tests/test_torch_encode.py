"""The port's encode entry points against `jpgenc_tpu.api.encode`, on the
CPU (device="cpu" runs each kernel's plain version).

Every input is made from a literal seed in this file, so a case sees the same
pixels in every run and on every worker. What a whole file asserts is split
in two, so that it is steady on any machine:

- the transform: both packages compute it in float32 in the same
  formulation (the reference's CPU path engine.pixels_to_scan and the
  port's plain version: BT.601, box mean, - 128, each block times KDCT_ZZ,
  divide, round), by two matmul libraries and with a box sum whose order
  XLA chooses by shape, so a coefficient whose exact value lies within
  ~1e-5 of a rounding boundary can still round differently. Tolerance: the
  knife-edge policy the reference states for itself
  (jpgenc_tpu/ops/pallas/k1_dct.py:18-24): |diff| <= 1 on at most
  max(1e-4, 2/size) of the coefficients of the two files (decoded with the
  C++ scan decoder). The inputs of this file measure 0 differing
  coefficients, and the six on which the port's earlier plain version (the
  TPU kernel's dense operator) rounded one coefficient apart are asserted
  byte for byte in test_knife_edge_cases_recorded;
- everything after the transform: byte-exact. The reference's own quantized
  coefficients (read back from its file) go through the port's entropy
  path — DPCM + per-block pack, kernel B, word compaction, fetch, stuffing
  finalize, headers — and the file must equal the reference's byte for byte.

Whole-file equality from pixels is asserted too, wherever the transform
check found no differing coefficient.
"""
import numpy as np
import pytest
import torch

from jpgenc_tpu import api as japi
from jpgenc_tpu.container.parser import parse_jpeg
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.native import decode_scan
from jpgenc_tpu.utils.fixtures import synth_frame
from jpgenc_tpu_torch import api, engine
from jpgenc_tpu_torch.config import EncodeConfig
from jpgenc_tpu_torch.ops.cuda import k1a_fused
from jpgenc_tpu_torch.parallel import mesh

torch.set_num_threads(1)


def _gradient_noise(seed, h, w, channels=None):
    """The structured test image of tests/conftest.py (gradients + sinusoids
    + noise), from a literal seed instead of a shared generator."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96.0 * np.sin(xx / 17.0) * np.cos(yy / 23.0) + 0.35 * xx + 0.2 * yy
    if channels:
        img = np.stack([base + 25.0 * c + rng.normal(0, 12, (h, w))
                        for c in range(channels)], axis=-1)
    else:
        img = base + rng.normal(0, 12, (h, w))
    return np.clip(img + 96.0, 0, 255).astype(np.uint8)


RGB = _gradient_noise(1234, 120, 136, channels=3)
GRAY = _gradient_noise(4321, 128, 128)


def _coefficients(data):
    """(layout, scan-decoded [n_total, 64] raster coefficients) of a file."""
    p = parse_jpeg(data)
    lay = make_layout(p.height, p.width, p.subsampling, p.restart_interval)
    return lay, decode_scan(p.scan_data, lay, [c.dc_tab for c in p.comps],
                            [c.ac_tab for c in p.comps],
                            [p.dc_tables.get(i) for i in range(2)],
                            [p.ac_tables.get(i) for i in range(2)])


def _transform_diffs(ours: bytes, ref: bytes) -> int:
    """Knife-edge policy on the two files' coefficients; returns how many
    differ."""
    _, a = _coefficients(ours)
    _, b = _coefficients(ref)
    d = np.abs(a - b)
    assert d.max() <= 1
    assert (d > 0).mean() <= max(1e-4, 2.0 / d.size)
    return int((d > 0).sum())


def _file_from_reference_coefficients(ref: bytes, quality: int,
                                      optimize: bool) -> bytes:
    """The reference file's coefficients through the port's entropy path on
    the CPU, up to a whole file."""
    lay, coef = _coefficients(ref)
    zz = torch.from_numpy(coef[lay.scan_flat].astype(np.int16))[None]
    plan = engine.get_plan(lay.height, lay.width, lay.subsampling, quality,
                           "cpu")
    return engine.EncodeJob(plan, EncodeConfig(
        quality=quality, optimize_huffman=optimize), zz=zz).file()


def _check_file(img, quality, sub="420", optimize=False):
    """The split assertion of the module docstring for one image."""
    ref = japi.encode(img, quality, sub, optimize=optimize)
    ours = api.encode(img, quality, sub, optimize=optimize, device="cpu")
    n_diff = _transform_diffs(ours, ref)
    assert _file_from_reference_coefficients(ref, quality, optimize) == ref
    if n_diff == 0:
        assert ours == ref
    return ours


@pytest.mark.parametrize("sub,quality", [
    ("420", 50), ("420", 75), ("420", 90), ("420", 95), ("422", 75),
    ("422", 95), ("444", 50), ("444", 90)])
def test_encode_bytes_equal_reference(sub, quality):
    _check_file(RGB, quality, sub)


@pytest.mark.parametrize("quality", [50, 90])
def test_encode_bytes_equal_reference_128x256(quality):
    _check_file(synth_frame(128, 256), quality)


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_gray_bytes_equal_reference(quality):
    _check_file(GRAY, quality)


@pytest.mark.parametrize("quality", [50, 90])
@pytest.mark.parametrize("sub", ["420", "422", "444", "gray"])
def test_optimize_bytes_equal_reference(sub, quality):
    """Two-pass optimized Huffman: the file carries the image's own tables
    and is smaller than the standard-table file."""
    img = GRAY[:64, :96] if sub == "gray" else RGB[:64, :96]
    ours = _check_file(img, quality, "420" if sub == "gray" else sub,
                       optimize=True)
    assert len(ours) < len(api.encode(
        img, quality, "420" if sub == "gray" else sub, device="cpu"))


@pytest.mark.parametrize("sub,tier", [("420", 1), ("444", 2)])
def test_noise_climbs_the_ladder_bytes_equal_reference(sub, tier):
    """Uniform noise overflows the first tiers (block words or stream
    capacity): 4:2:0 lands on the safe tier, 4:4:4 on the 56-word worst
    tier (test_pack_device.py:153-157). The bytes stay the reference's."""
    noise = np.random.default_rng(1234).integers(0, 256, (64, 64, 3),
                                                 dtype=np.uint8)
    plan = engine.get_plan(64, 64, sub, 78, "cpu")
    job = engine.EncodeJob(plan, EncodeConfig(quality=78, subsampling=sub),
                           torch.from_numpy(noise)[None])
    job.tables()
    for cap_u, w_blk in job.tiers[:tier]:
        assert job.recode(0, cap_u, w_blk) is None
    assert job.recode(0, *job.tiers[tier]) is not None
    _check_file(noise, 78, sub)


def test_optimize_noise_climbs_the_ladder():
    """With its own tables the noise frame still overflows the tight tier,
    and pass 2 climbs the ladder from the cached coefficients."""
    noise = np.random.default_rng(1234).integers(0, 256, (64, 64, 3),
                                                 dtype=np.uint8)
    plan = engine.get_plan(64, 64, "444", 78, "cpu")
    job = engine.EncodeJob(plan, EncodeConfig(quality=78, subsampling="444",
                                              optimize_huffman=True),
                           torch.from_numpy(noise)[None])
    job.first_pass()
    job.tables()
    assert job.recode(0, *job.tiers[0]) is None
    _check_file(noise, 78, "444", optimize=True)


@pytest.mark.parametrize("sub,optimize", [("420", False), ("444", True)])
def test_api_and_batch_ladders_on_noise(sub, optimize, monkeypatch):
    """The two ladders over the one row re-code, on a noise frame that
    overflows the tight tier: api.encode codes it at tight, then alone at
    safe, and stops there or at worst; encode_batch codes the batch at
    tight, then the noise row alone at worst. Both files are the same
    bytes."""
    noise = np.random.default_rng(1234).integers(0, 256, (64, 64, 3),
                                                 dtype=np.uint8)
    smooth = synth_frame(64, 64, seed=5)
    tiers = engine.tiers_for(engine.get_plan(64, 64, sub, 78, "cpu").layout,
                             78)
    assert len(tiers) == 3
    coded, recoded = [], []
    real_merge, real_recode = engine.EncodePlan.merge, engine.EncodeJob.recode

    def merge(self, buf, bits, cap_u, w_blk):
        coded.append(((cap_u, w_blk), int(bits.shape[0])))
        return real_merge(self, buf, bits, cap_u, w_blk)

    def recode(self, j, cap_u, w_blk):
        recoded.append((j, (cap_u, w_blk)))
        return real_recode(self, j, cap_u, w_blk)

    monkeypatch.setattr(engine.EncodePlan, "merge", merge)
    monkeypatch.setattr(engine.EncodeJob, "recode", recode)
    kw = dict(quality=78, subsampling=sub, optimize=optimize, device="cpu")
    one = api.encode(noise, **kw)
    assert coded in ([(tiers[0], 1), (tiers[1], 1)],
                     [(tiers[0], 1), (tiers[1], 1), (tiers[2], 1)])
    assert recoded == [(0, t) for t, _ in coded[1:]]
    coded.clear()
    recoded.clear()
    files = mesh.encode_batch(np.stack([smooth, noise]), **kw)
    assert coded == [(tiers[0], 2), (tiers[-1], 1)]
    assert recoded == [(1, tiers[-1])]
    assert files[1] == one


def _batch():
    frames = [synth_frame(64, 96, seed=s) for s in (1, 2, 3)]
    frames.append(np.random.default_rng(9).integers(0, 256, (64, 96, 3),
                                                    dtype=np.uint8))
    return np.stack(frames)


def _assert_batch(batch, **kw):
    """encode_batch equals per-image api.encode (the port's own, byte for
    byte) and the reference's per-image files under the split assertion."""
    out = mesh.encode_batch(batch, 75, device="cpu", **kw)
    assert out == [api.encode(f, 75, device="cpu", **kw) for f in batch]
    assert mesh.encode_batch(torch.from_numpy(batch), 75, device="cpu",
                             **kw) == out
    for f, data in zip(batch, out):
        ref = japi.encode(f, 75, **kw)
        if _transform_diffs(data, ref) == 0:
            assert data == ref


def test_encode_batch_equals_per_image_reference():
    """The whole batch at the tight tier, the noise frame retried alone at
    the worst tier (mesh.py:446-469)."""
    _assert_batch(_batch())


@pytest.mark.parametrize("gray", [False, True])
def test_encode_batch_optimize_equals_per_image(gray):
    """Per-image tables and headers; the noise frame's worst-tier retry
    runs from the cached coefficients (mesh.py:441-458)."""
    batch = _batch()
    _assert_batch(np.ascontiguousarray(batch[..., 1]) if gray else batch,
                  optimize=True)


def test_encode_batch_gray_equals_per_image_reference():
    _assert_batch(np.ascontiguousarray(_batch()[..., 1]))


@pytest.mark.parametrize("h,w,sub,quality", [
    (128, 128, "420", 75), (128, 256, "420", 95), (128, 128, "422", 75),
    (128, 128, "444", 75), (128, 128, "420", 90), (128, 256, "444", 95)])
def test_knife_edge_cases_recorded(h, w, sub, quality):
    """The six inputs on which the dense-operator plain version rounded one
    coefficient apart from the reference (and float64 said the port was
    wrong): with the shared per-block transform the port's file holds
    exactly the port's coefficients, they are the reference's on every
    coefficient, and the file is `jpgenc_tpu.api.encode`'s byte for byte."""
    img = synth_frame(h, w)
    ours = api.encode(img, quality, sub, device="cpu")
    lay, ours_c = _coefficients(ours)
    ref = japi.encode(img, quality, sub)
    plan = engine.get_plan(h, w, sub, quality, "cpu")
    zz = k1a_fused.transform_plain(torch.from_numpy(img)[None], lay, plan.kdct,
                                   plan.q).reshape(-1, 64).numpy()
    expect = np.empty_like(zz)
    expect[lay.scan_flat] = zz
    np.testing.assert_array_equal(ours_c, expect)
    assert _transform_diffs(ours, ref) == 0
    assert ours == ref
    assert api.encode(img, quality, sub, optimize=True, device="cpu") == \
        japi.encode(img, quality, sub, optimize=True)


@pytest.mark.parametrize("kwargs,item", [
    ({"restart_interval": 4}, "item 5"), ({"dct_method": "islow"}, "item 6")])
def test_unported_modes_raise(kwargs, item):
    """The modes that ROADMAP.md Queue 1 items 5 and 6 named are in: the
    calls that raised return the reference's file (islow: byte for byte; a
    restart interval: wherever the transforms agree)."""
    for img in (RGB, GRAY):
        ours = api.encode(img, device="cpu", **kwargs)
        assert mesh.encode_batch(img[None], device="cpu", **kwargs) == [ours]
        ref = japi.encode(img, **kwargs)
        if "dct_method" in kwargs or _transform_diffs(ours, ref) == 0:
            assert ours == ref


def test_device_is_explicit(monkeypatch):
    """No silent CPU: device="cuda" without CUDA raises, and a tensor must
    already live on the requested device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        api.encode(RGB)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.encode_batch(RGB[None], device="cuda", optimize=True)
    with pytest.raises(ValueError, match="lives on"):
        api.encode(torch.from_numpy(RGB).to("meta"), device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        api.encode(RGB.astype(np.int16), device="cpu")
    with pytest.raises(ValueError, match="subsampling"):
        api.encode(RGB, subsampling="411", device="cpu")
    with pytest.raises(ValueError, match="expected"):
        mesh.encode_batch(RGB[..., :2][None], device="cpu")


_MODES = {"gray": {}, "420_optimize": {"optimize": True},
          "islow": {"dct_method": "islow"},
          "restart": {"restart_interval": 3}}


def _mode_frames(mode: str) -> np.ndarray:
    """Two smooth 64 x 96 frames and a noise frame, which overflows tier 0
    and is re-coded alone; gray takes their first channel."""
    x = [synth_frame(64, 96, seed=s) for s in (31, 32)]
    x.append(np.random.default_rng(33).integers(0, 256, (64, 96, 3),
                                                dtype=np.uint8))
    x = np.stack(x)
    return np.ascontiguousarray(x[..., 0]) if mode == "gray" else x


@pytest.mark.parametrize("codec", ["native", "numpy"])
@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("entry", ["encode_batch", "encode_striped",
                                   "api.encode"])
def test_files_equal_the_row_at_a_time_finalize(entry, mode, codec,
                                                monkeypatch):
    """encode_batch (its noise row retried alone), encode_striped (three
    ragged stripes a frame, each a row of stripe plans) and api.encode give
    the same files through the batch finalize (native.finalize_rows) as
    through the row-at-a-time finalize: finalize_host_w's C++ call a row,
    or, with the C++ library gone, its numpy one."""
    x, kw = _mode_frames(mode), dict(_MODES[mode], quality=75, device="cpu")

    def encode():
        if entry == "encode_batch":
            return mesh.encode_batch(x, **kw)
        if entry == "encode_striped":
            return [mesh.encode_striped(f, 3, **kw) for f in x]
        return [api.encode(f, **kw) for f in x]

    calls = engine.native.finalize_calls
    batch = encode()
    calls, before = engine.native.finalize_calls, calls
    assert calls > before
    with monkeypatch.context() as m:
        if codec == "numpy":
            m.setattr(engine.native, "_load", lambda: None)
        else:
            m.setattr(engine.native, "finalize_rows", lambda *a, **k: None)
        rows = encode()
    assert engine.native.finalize_calls == calls
    assert rows == batch
