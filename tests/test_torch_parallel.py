"""The port's distribution layer on the CPU: device lists, stripe mode, the
batch-split decode, MeshConfig and the single-process multihost helpers
(the counterparts of tests/test_m7_parallel.py and
tests/test_io_meshconfig.py:44-69).

Device lists name the CPU more than once (["cpu", "cpu"], three entries),
as the one-card machine names its card. Whole-file tests follow ROADMAP.md
Queue 3's rule: striped files are held against unstriped PORT files, and
device-list files against single-device PORT files, byte for byte; port
files against jpgenc_tpu's under the split assertion (the transform within
the knife-edge policy, everything after it byte-exact). Every image comes
from a literal seed in this file.
"""
import numpy as np
import pytest
import torch

from jpgenc_tpu_torch import api, config
from jpgenc_tpu_torch.batch import run_batch
from jpgenc_tpu_torch.parallel import mesh, multihost
from jpgenc_tpu_torch.utils.fixtures import synth_frame
from jpgenc_tpu_torch.utils.metrics import psnr
from test_torch_cli_batch import _assert_split

torch.set_num_threads(1)

DEVICE_LISTS = [["cpu", "cpu"], ["cpu", "cpu", "cpu"]]


def _batch(seed, b, h, w, c=None):
    shape = (b, h, w) if c is None else (b, h, w, c)
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def _single(imgs, **kw):
    return [api.encode(im, device="cpu", **kw) for im in imgs]


# --- device lists (test_m7_parallel.py:26-55, :97-137, :193-226) -------------

@pytest.mark.parametrize("devs", DEVICE_LISTS)
def test_batch_encode_matches_single_device_gray(devs):
    imgs = _batch(101, 8, 64, 64)
    outs = mesh.encode_batch(imgs, quality=75, devices=devs, device="cpu")
    assert outs == _single(imgs, quality=75)


@pytest.mark.parametrize("devs", DEVICE_LISTS)
def test_batch_encode_matches_single_device_color(devs):
    imgs = _batch(102, 8, 64, 64, 3)
    outs = mesh.encode_batch(imgs, quality=75, restart_interval=2,
                             devices=devs, device="cpu")
    assert outs == _single(imgs, quality=75, restart_interval=2)


@pytest.mark.parametrize("devs", DEVICE_LISTS)
def test_batch_not_divisible_by_the_list(devs):
    imgs = _batch(103, 5, 64, 64)
    outs = mesh.encode_batch(imgs, quality=75, devices=devs, device="cpu")
    assert outs == _single(imgs, quality=75)
    # fewer images than entries: the last entry gets none
    assert mesh.encode_batch(imgs[:2], devices=devs, device="cpu") == \
        outs[:2]


@pytest.mark.parametrize("kw", [{"optimize": True},
                                {"dct_method": "islow"},
                                {"optimize": True, "dct_method": "islow",
                                 "restart_interval": 3}])
@pytest.mark.parametrize("devs", DEVICE_LISTS)
def test_batch_optimized_huffman_and_islow(devs, kw):
    imgs = _batch(104, 4, 64, 64, 3)
    outs = mesh.encode_batch(imgs, quality=75, devices=devs, device="cpu",
                             **kw)
    assert outs == _single(imgs, quality=75, **kw)


def test_batch_worst_tier_retry_on_one_entry():
    """A noise frame overflows the tight tier and is redone alone at the
    worst tier on the entry that owns it, beside smooth frames."""
    imgs = np.stack([synth_frame(48, 64, seed=105),
                     _batch(106, 1, 48, 64, 3)[0],
                     synth_frame(48, 64, seed=107)])
    for kw in ({}, {"optimize": True}):
        assert mesh.encode_batch(imgs, quality=95, devices=["cpu"] * 2,
                                 device="cpu", **kw) == \
            _single(imgs, quality=95, **kw)


def test_encode_batch_device_resident_transcode():
    """decode_batch(to_device=True, devices=...) pixels feed encode_batch
    directly, as a list of per-entry tensors, and the bytes equal the
    host-pixel encode's; a resident tensor must divide over the entries."""
    imgs = _batch(108, 8, 64, 80, 3)
    files = [api.encode(im, quality=90, device="cpu") for im in imgs]
    devs = ["cpu", "cpu"]
    pix = mesh.decode_batch(files, devices=devs, device="cpu")
    assert isinstance(pix, list) and [p.shape[0] for p in pix] == [4, 4]
    out_dev = mesh.encode_batch(pix, quality=75, devices=devs, device="cpu")
    host = torch.cat(pix).numpy()
    assert out_dev == mesh.encode_batch(host, quality=75, device="cpu")
    assert out_dev == mesh.encode_batch(torch.cat(pix), quality=75,
                                        devices=devs, device="cpu")
    with pytest.raises(ValueError):                  # 3 rows, 2 entries
        mesh.encode_batch(torch.cat(pix)[:3], devices=devs, device="cpu")
    with pytest.raises(ValueError):                  # one list per entry
        mesh.encode_batch(pix, devices=["cpu"] * 3, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        mesh.encode_batch(torch.cat(pix).to("meta"), devices=devs,
                          device="cpu")


def test_batch_optimize_device_resident():
    imgs = _batch(109, 8, 64, 80, 3)
    outs = mesh.encode_batch(torch.from_numpy(imgs), quality=75,
                             optimize=True, devices=["cpu"] * 4,
                             device="cpu")
    assert outs == _single(imgs, quality=75, optimize=True)


def test_decode_batch_matches_api_decode_batch():
    """mesh.decode_batch over entries equals api.decode_batch pixel for
    pixel: colour, gray with a batch that does not divide, the one-tensor
    form without devices, an entry without rows, and mixed geometry."""
    imgs = _batch(110, 8, 64, 64, 3)
    files = _single(imgs, quality=75)
    want = api.decode_batch(files, device="cpu")
    pix = mesh.decode_batch(files, devices=["cpu"] * 3, device="cpu")
    assert [p.shape[0] for p in pix] == [3, 3, 2]
    np.testing.assert_array_equal(torch.cat(pix).numpy(), np.stack(want))
    one = mesh.decode_batch(files, device="cpu")
    assert isinstance(one, torch.Tensor) and one.shape == (8, 64, 64, 3)
    np.testing.assert_array_equal(one.numpy(), np.stack(want))

    gfiles = [api.encode(im, quality=80, device="cpu")
              for im in _batch(111, 5, 48, 40)]
    outs = mesh.decode_batch(gfiles, devices=["cpu"] * 2, to_device=False,
                             device="cpu")
    assert len(outs) == 5
    for got, ref in zip(outs, api.decode_batch(gfiles, device="cpu")):
        np.testing.assert_array_equal(got, ref)
    few = mesh.decode_batch(gfiles[:2], devices=["cpu"] * 3, device="cpu")
    assert [p.shape for p in few][2] == (0, 48, 40)
    assert mesh.decode_batch([], device="cpu") == []
    with pytest.raises(ValueError):
        mesh.decode_batch([files[0], gfiles[0]], devices=["cpu"] * 2,
                          device="cpu")


def test_stage_batch_over_a_device_list(tmp_path):
    imgs = _batch(112, 5, 32, 48, 3)
    devs = ["cpu"] * 2
    staged = mesh.stage_batch(imgs, quality=60, devices=devs, device="cpu")
    assert [t.shape[0] for t, _ in staged[1]] == [3, 2]
    assert mesh.encode_batch(None, quality=60, staged=staged, devices=devs,
                             device="cpu") == _single(imgs, quality=60)
    with pytest.raises(ValueError):
        mesh.encode_batch(None, staged=staged, devices=["cpu"] * 3,
                          device="cpu")
    outs = [str(tmp_path / f"{i}.jpg") for i in range(len(imgs))]
    res = run_batch(imgs, outs, str(tmp_path / "m.jsonl"), chunk_size=2,
                    quality=60, device="cpu", devices=devs)
    assert res.done == 5
    assert [open(p, "rb").read() for p in outs] == _single(imgs, quality=60)


def test_batch_files_match_reference_under_split_assertion():
    from jpgenc_tpu.parallel import mesh as jmesh
    imgs = np.stack([synth_frame(48, 80, seed=113 + i) for i in range(4)])
    for kw in ({"restart_interval": 5}, {"optimize": True}):
        ours = mesh.encode_batch(imgs, quality=75, devices=["cpu"] * 2,
                                 device="cpu", **kw)
        ref = jmesh.encode_batch(imgs, quality=75, **kw)
        for a, b in zip(ours, ref):
            _assert_split(a, b, 75, kw.get("optimize", False))


# --- stripe mode (test_m7_parallel.py:57-86, :139-191) ----------------------

def _gray128(seed=120):
    return synth_frame(128, 128, seed=seed)[..., 1].copy()


def test_striped_equals_unsharded():
    # 128x128 gray: 16 MCU rows; 4 stripes of 4 rows; R=16 (one MCU row)
    img = _gray128()
    assert mesh.encode_striped(img, 4, restart_interval=16, device="cpu") \
        == api.encode(img, quality=75, restart_interval=16, device="cpu")


def test_striped_color_equals_unsharded():
    # 120x136 -> 8x9 MCUs at 4:2:0; 4 stripes of 2 MCU rows = 18 MCUs a
    # stripe; R=6 divides 18
    img = _batch(121, 1, 120, 136, 3)[0]
    assert mesh.encode_striped(img, 4, subsampling="420", restart_interval=6,
                               device="cpu") == \
        api.encode(img, quality=75, restart_interval=6, device="cpu")


def test_striped_default_interval_decodes():
    img = _gray128(122)
    data = mesh.encode_striped(img, 8, device="cpu")
    # default DRI: the MCUs of a stripe, 2 rows x 16
    assert data == api.encode(img, restart_interval=32, device="cpu")
    assert psnr(api.decode(data, device="cpu"), img) > 28.0


def test_striped_optimized_huffman():
    img = _gray128(123)
    data = mesh.encode_striped(img, 4, restart_interval=16, optimize=True,
                               device="cpu")
    base = mesh.encode_striped(img, 4, restart_interval=16, device="cpu")
    assert len(data) < len(base)
    assert data == api.encode(img, restart_interval=16, optimize=True,
                              device="cpu")
    np.testing.assert_array_equal(api.decode(data, device="cpu"),
                                  api.decode(base, device="cpu"))


def test_striped_ragged_equals_unsharded():
    # 16 MCU rows over 3 stripes: 6 + 6 + 4
    img = _gray128(124)
    assert mesh.encode_striped(img, 3, restart_interval=16, device="cpu") \
        == api.encode(img, restart_interval=16, device="cpu")


def test_striped_ragged_color_default_interval():
    # 120x136 4:2:0 -> 8 MCU rows over 3 stripes (3 + 3 + 2); the default
    # DRI becomes one MCU row, ceil(136 / 16) = 9 MCUs
    img = _batch(125, 1, 120, 136, 3)[0]
    striped = mesh.encode_striped(img, 3, subsampling="420", device="cpu")
    assert striped == api.encode(img, restart_interval=9, device="cpu")
    assert api.decode(striped, device="cpu").shape == img.shape


@pytest.mark.parametrize("devices", [None, ["cpu"] * 3])
def test_striped_ragged_pure_padding_stripe(devices):
    # gray 56x64: 7 MCU rows; 5 stripes of 2 -> 2, 2, 2, 1, 0 rows kept;
    # over three entries the last one holds only the stripe past the image
    img = _batch(126, 1, 56, 64)[0]
    assert mesh.encode_striped(img, 5, restart_interval=8, devices=devices,
                               device="cpu") \
        == api.encode(img, restart_interval=8, device="cpu")


def test_striped_ragged_validation():
    img = _batch(127, 1, 56, 64)[0]            # 7 MCU rows, 8 MCUs a row
    with pytest.raises(ValueError):            # 3 does not divide 8
        mesh.encode_striped(img, 3, restart_interval=3, device="cpu")
    with pytest.raises(ValueError):            # more stripes than MCU rows
        mesh.encode_striped(img, 8, device="cpu")
    with pytest.raises(ValueError):            # even split, 3 !| 16 MCUs
        mesh.encode_striped(_gray128(), 4, restart_interval=3, device="cpu")
    with pytest.raises(ValueError):
        mesh.encode_striped(img, 0, device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        mesh.encode_striped(img.astype(np.int16), 2, device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.encode_striped(img, 2)


def test_striped_ragged_optimize():
    """The stripe batch histograms padding rows the unstriped encode never
    sees; the true-height count replaces them, so the tables and the whole
    file equal the unstriped encode's."""
    img = _gray128(128)
    data = mesh.encode_striped(img, 3, restart_interval=16, optimize=True,
                               device="cpu")
    assert data == api.encode(img, restart_interval=16, optimize=True,
                              device="cpu")


@pytest.mark.parametrize("h,w,gray,n", [(61, 48, False, 3), (56, 48, False, 2),
                                        (61, 40, True, 3)])
@pytest.mark.parametrize("optimize", [False, True])
def test_striped_islow_at_a_non_mcu_height(h, w, gray, n, optimize):
    """islow with the true bottom edge mid-MCU: the last live stripe is
    re-encoded under its true-height layout (libjpeg's dummy rows), with
    optimize its histogram counted under that layout."""
    img = synth_frame(h, w, seed=129)
    if gray:
        img = img[..., 0].copy()
    lay_mcus_x = -(-w // (8 if gray else 16))
    mcu_rows = -(-h // (8 if gray else 16))
    ragged = mcu_rows % n != 0
    r = lay_mcus_x if ragged else -(-mcu_rows // n) * lay_mcus_x
    data = mesh.encode_striped(img, n, optimize=optimize, dct_method="islow",
                               devices=["cpu", "cpu"], device="cpu")
    assert data == api.encode(img, restart_interval=r, optimize=optimize,
                              dct_method="islow", device="cpu")


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu"] * 3,
                                     config.MeshConfig(stripe=2),
                                     config.MeshConfig()])
def test_striped_over_device_entries(devices):
    img = _batch(130, 1, 120, 136, 3)[0]
    for kw in ({}, {"optimize": True}):
        assert mesh.encode_striped(img, 3, devices=devices, device="cpu",
                                   **kw) == \
            mesh.encode_striped(img, 3, device="cpu", **kw)


@pytest.mark.parametrize("gray,n,kw", [(False, 4, {"restart_interval": 6}),
                                       (True, 3, {"optimize": True,
                                                  "restart_interval": 16})])
def test_striped_matches_reference_under_split_assertion(gray, n, kw):
    from jpgenc_tpu.parallel import mesh as jmesh
    img = _gray128(131) if gray else synth_frame(120, 136, seed=131)
    ours = mesh.encode_striped(img, n, devices=["cpu", "cpu"], device="cpu",
                               **kw)
    ref = jmesh.encode_striped(img, n, **kw)
    _assert_split(ours, ref, 75, kw.get("optimize", False))


def test_striped_launches_one_fused_call_per_entry(monkeypatch):
    """The fused stripe path runs K1A and the merge tail once per device
    entry (the plain versions on the CPU, counted by their wrappers)."""
    from jpgenc_tpu_torch.ops.cuda import k1a_fused, seg_merge
    for mod in (k1a_fused, seg_merge):
        monkeypatch.setattr(mod, "plain_calls", 0)
    img = synth_frame(120, 136, seed=132)     # no stripe overflows the tier
    mesh.encode_striped(img, 4, restart_interval=6, devices=["cpu"] * 2,
                        device="cpu")
    assert (k1a_fused.plain_calls, seg_merge.plain_calls) == (2, 2)


# --- MeshConfig (test_io_meshconfig.py:44-69) and multihost (:88-95) --------

def test_mesh_config_resolves_to_device_entries(monkeypatch):
    assert mesh.resolve_devices(None, "cpu") == [torch.device("cpu")]
    assert mesh.resolve_devices(config.MeshConfig(), "cpu") == \
        [torch.device("cpu")]
    assert len(mesh.resolve_devices(config.MeshConfig(stripe=2), "cpu")) == 2
    assert len(mesh.resolve_devices(config.MeshConfig(batch=2, stripe=3),
                                    "cpu")) == 6
    assert mesh.resolve_devices(["cpu", torch.device("cpu")], "cuda") == \
        [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        mesh.resolve_devices([], "cpu")
    with pytest.raises(ValueError):
        config.MeshConfig(batch_axis="x", stripe_axis="x")
    with pytest.raises(ValueError):
        config.MeshConfig(stripe=0)
    assert hash(config.MeshConfig()) == hash(config.MeshConfig())
    # the CUDA count, as make_mesh reads jax.devices(): four visible cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert mesh.resolve_devices(config.MeshConfig(), "cuda") == cuda
    assert mesh.resolve_devices(config.MeshConfig(stripe=2), "cuda") == cuda
    assert mesh.resolve_devices(config.MeshConfig(batch=1, stripe=2),
                                "cuda") == cuda[:2]
    for bad in (config.MeshConfig(stripe=5), config.MeshConfig(batch=3,
                                                               stripe=2)):
        with pytest.raises(ValueError):
            mesh.resolve_devices(bad, "cuda")
    assert mesh._stripe_devices(config.MeshConfig(), "cuda", 6) == cuda[:3]
    assert mesh._stripe_devices(config.MeshConfig(stripe=2), "cuda", 6) == \
        cuda[:2]


def test_encode_batch_accepts_mesh_config():
    imgs = _batch(133, 2, 24, 24, 3)
    outs = mesh.encode_batch(imgs, quality=75,
                             devices=config.MeshConfig(batch=2),
                             device="cpu")
    assert outs == _single(imgs, quality=75)


def test_multihost_helpers_single_process(monkeypatch):
    """Degenerate (1-process) behaviour of the control plane."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()                     # no cluster: a no-op
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.gather_bytes(b"abc") == [b"abc"]
    assert list(multihost.owned_indices(10)) == list(range(10))
    a = np.arange(6).reshape(2, 3)
    assert multihost.sum_array(a) is a
    assert mesh._exchange_rows({1: b"x"}) == {1: b"x"}
    with pytest.raises(ValueError):            # half a configuration
        multihost.initialize(coordinator_address="127.0.0.1:1")


@pytest.mark.parametrize("n", [0, 1, 5, 7, 8, 13])
@pytest.mark.parametrize("n_proc", [2, 3, 4])
def test_owned_indices_cover_the_items_as_the_reference(monkeypatch, n,
                                                        n_proc):
    """The contiguous, ceil-divided shard of the reference
    (multihost.py:72-79), over every process of a job."""
    monkeypatch.setattr(multihost, "process_count", lambda: n_proc)
    got = []
    for p in range(n_proc):
        monkeypatch.setattr(multihost, "process_index", lambda p=p: p)
        per = -(-n // n_proc)
        ref = range(p * per, min((p + 1) * per, n))
        own = multihost.owned_indices(n)
        assert list(own) == list(ref)
        got += list(own)
        split = mesh._owned_split(n, ["cpu"] * 3)
        assert [i for _, r in split for i in r] == list(own)
    assert got == list(range(n))
