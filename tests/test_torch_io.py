"""The port's image I/O (jpgenc_tpu_torch.io) against jpgenc_tpu.io, and its
own binary PPM / PGM reader and writer with Pillow's import made to fail.

Every image comes from a literal seed in this file. With Pillow present both
modules go through Pillow and must agree on pixels, shapes and file bytes;
with Pillow blocked the port reads, writes and probes .ppm / .pgm by itself
(the same bytes Pillow writes) and names Pillow for any other format.
"""
import sys

import numpy as np
import pytest

from jpgenc_tpu import io as jio
from jpgenc_tpu_torch import io as tio


def _image(seed, h, w, gray=False):
    rng = np.random.default_rng(seed)
    shape = (h, w) if gray else (h, w, 3)
    return rng.integers(0, 256, shape, dtype=np.uint8)


CASES = [("png", False, 21, 34), ("png", True, 8, 128), ("ppm", False, 37, 19),
         ("pgm", True, 128, 64), ("ppm", False, 1, 1)]


@pytest.mark.parametrize("ext,gray,h,w", CASES)
def test_load_save_probe_equal_reference(tmp_path, ext, gray, h, w):
    img = _image(h * 7 + w, h, w, gray)
    ours, theirs = tmp_path / f"ours.{ext}", tmp_path / f"theirs.{ext}"
    tio.save(str(ours), img)
    jio.save(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    for p in (ours, theirs):
        a, b = tio.load(str(p)), jio.load(str(p))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, img)
        assert tio.probe(str(p)) == jio.probe(str(p)) == \
            (h, w, 1 if gray else 3)


def test_find_images_and_load_batch_equal_reference(tmp_path):
    for i, ext in enumerate(("png", "ppm", "PGM", "txt", "jpg.bak")):
        tio.save(str(tmp_path / f"f{i}.png"), _image(i, 12, 20))
        (tmp_path / f"g{i}.{ext}").write_bytes(b"x")
    (tmp_path / "sub.png").mkdir()
    for pattern in ("*", "f*", "*.png"):
        assert tio.find_images(str(tmp_path), pattern) == \
            jio.find_images(str(tmp_path), pattern)
    assert tio.find_images(str(tmp_path / "f*.png")) == \
        jio.find_images(str(tmp_path / "f*.png"))
    assert len(tio.find_images(str(tmp_path), "f*")) == 5
    paths = tio.find_images(str(tmp_path), "f*")
    np.testing.assert_array_equal(tio.load_batch(paths),
                                  jio.load_batch(paths))
    tio.save(str(tmp_path / "odd.png"), _image(9, 12, 21))
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="has shape"):
            mod.load_batch(paths + [str(tmp_path / "odd.png")])
        with pytest.raises(ValueError, match="empty"):
            mod.load_batch([])


@pytest.fixture
def no_pillow(monkeypatch):
    """Make `from PIL import Image` raise ImportError, as on a machine
    without Pillow."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401


@pytest.mark.parametrize("ext,gray,h,w", [("ppm", False, 37, 19),
                                          ("pgm", True, 128, 64),
                                          ("ppm", True, 5, 3),
                                          ("pgm", False, 16, 256)])
def test_netpbm_round_trip_without_pillow(tmp_path, ext, gray, h, w):
    img = _image(h + w, h, w, gray)
    with_pillow = tmp_path / f"pil.{ext}"
    jio.save(str(with_pillow), img)           # Pillow's own file
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(sys.modules, "PIL", None)
        mp.setitem(sys.modules, "PIL.Image", None)
        ours = tmp_path / f"ours.{ext}"
        tio.save(str(ours), img)
        assert ours.read_bytes() == with_pillow.read_bytes()
        for p in (ours, with_pillow):
            np.testing.assert_array_equal(tio.load(str(p)), img)
            assert tio.probe(str(p)) == (h, w, 1 if gray else 3)
    finally:
        mp.undo()


def test_netpbm_header_comments_and_whitespace(tmp_path, no_pillow):
    img = _image(5, 3, 4)
    p = tmp_path / "c.ppm"
    p.write_bytes(b"P6 # a comment\n# another\n4\t3\r\n# c\n255\n"
                  + img.tobytes())
    np.testing.assert_array_equal(tio.load(str(p)), img)
    assert tio.probe(str(p)) == (3, 4, 3)


@pytest.mark.parametrize("head,err", [
    (b"P3\n1 1\n255\n", "magic"), (b"P5\n2 2\n65535\n", "maxval"),
    (b"P5\n2 2", "truncated"), (b"P5\n2 x 2\n255\n", "header byte"),
    (b"P5\n2 2\n255", "whitespace")])
def test_netpbm_bad_headers_raise(tmp_path, no_pillow, head, err):
    p = tmp_path / "bad.pgm"
    p.write_bytes(head)
    with pytest.raises(ValueError, match=err):
        tio.probe(str(p))


def test_netpbm_short_pixels_raise(tmp_path, no_pillow):
    p = tmp_path / "short.pgm"
    p.write_bytes(b"P5\n4 4\n255\n" + bytes(10))
    with pytest.raises(ValueError, match="pixel bytes"):
        tio.load(str(p))


@pytest.mark.parametrize("fn", ["load", "probe", "save"])
def test_other_formats_without_pillow_name_pillow(tmp_path, no_pillow, fn):
    p = str(tmp_path / "x.png")
    args = (p, _image(1, 4, 4)) if fn == "save" else (p,)
    with pytest.raises(ImportError, match="Pillow"):
        getattr(tio, fn)(*args)


@pytest.mark.parametrize("ext,gray", [("png", False), ("png", True),
                                      ("ppm", False), ("pgm", True),
                                      ("bmp", False)])
@pytest.mark.parametrize("h,w", [(1, 7), (33, 65), (128, 256)])
def test_probe_matches_load_shape(tmp_path, ext, gray, h, w):
    p = str(tmp_path / f"i.{ext}")
    tio.save(p, _image(h * w, h, w, gray))
    ph, pw, ch = tio.probe(p)
    assert tio.load(p).shape == ((ph, pw) if ch == 1 else (ph, pw, ch))
