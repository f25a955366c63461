"""Image file I/O (copy of jpgenc_tpu/io.py): load / save / probe / batch
loading for the file-driven encode paths (the CLI and the checkpointed
batch driver).

Host-side only; device code never touches files. `probe` reads just the
header (no pixel decode), so the batch driver can group thousands of files
by shape without loading them. Pillow is imported inside each function, as
the reference does. Where Pillow cannot be imported, binary PPM and PGM
(`P6` / `P5`, maxval 255, `#` comments in the header) are read, written and
probed by the small reader and writer below, so the CLI and the batch
driver run on a machine without Pillow; any other format then raises an
ImportError that names Pillow.
"""
from __future__ import annotations

import glob as _glob
import os

import numpy as np

IMAGE_EXTS = (".png", ".ppm", ".pgm", ".bmp", ".jpg", ".jpeg", ".tif",
              ".tiff", ".webp")
NETPBM_EXTS = (".ppm", ".pgm")


def _pillow_image(path: str):
    """PIL.Image, or None where Pillow is absent and `path` is a PPM / PGM
    file that the port's own reader and writer handle."""
    try:
        from PIL import Image
    except ImportError as e:
        if os.path.splitext(path)[1].lower() in NETPBM_EXTS:
            return None
        raise ImportError(
            f"Pillow is needed for {path!r}; without Pillow only binary "
            f".ppm / .pgm files are read and written") from e
    return Image


def _netpbm_header(f) -> tuple[int, int, int, int]:
    """(height, width, channels, offset of the pixels) of a binary PPM
    (P6) or PGM (P5) file with maxval 255."""
    magic = f.read(2)
    if magic not in (b"P6", b"P5"):
        raise ValueError(f"not a binary PPM / PGM file (magic {magic!r})")
    fields: list[int] = []
    c = f.read(1)
    while len(fields) < 3:
        if not c:
            raise ValueError("truncated PPM / PGM header")
        if c == b"#":                       # a comment runs to end of line
            while c not in (b"\n", b"\r", b""):
                c = f.read(1)
        elif c.isspace():
            c = f.read(1)
        elif c.isdigit():
            tok = b""
            while c.isdigit():
                tok += c
                c = f.read(1)
            fields.append(int(tok))
        else:
            raise ValueError(f"bad PPM / PGM header byte {c!r}")
    if not c.isspace():                     # one whitespace byte ends it
        raise ValueError("PPM / PGM header does not end in whitespace")
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"PPM / PGM maxval {maxval}: only 255 is read")
    return h, w, 3 if magic == b"P6" else 1, f.tell()


def _netpbm_load(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        h, w, ch, off = _netpbm_header(f)
        n = h * w * ch
        data = np.frombuffer(f.read(n), np.uint8)
    if data.size != n:
        raise ValueError(f"{path}: {data.size} pixel bytes, expected {n}")
    return data.reshape((h, w, 3) if ch == 3 else (h, w)).copy()


def _netpbm_save(path: str, arr: np.ndarray) -> None:
    """P6 for [H, W, 3], P5 for [H, W] uint8 (the header Pillow writes)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or not (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"PPM / PGM needs uint8 [H, W] or [H, W, 3], got "
                         f"{arr.dtype} {arr.shape}")
    head = b"P6" if arr.ndim == 3 else b"P5"
    with open(path, "wb") as f:
        f.write(head + b"\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
        f.write(arr.tobytes())


def load(path: str) -> np.ndarray:
    """Load an image file -> uint8 [H,W] (grayscale) or [H,W,3] (RGB)."""
    Image = _pillow_image(path)
    if Image is None:
        return _netpbm_load(path)
    img = Image.open(path)
    if img.mode not in ("L", "RGB"):
        img = img.convert("RGB")
    return np.asarray(img)


def save(path: str, arr: np.ndarray) -> None:
    """Save a uint8 array as an image file (format from the extension)."""
    Image = _pillow_image(path)
    if Image is None:
        _netpbm_save(path, arr)
        return
    Image.fromarray(arr).save(path)


def probe(path: str) -> tuple[int, int, int]:
    """(height, width, channels) from the file header — no pixel decode."""
    Image = _pillow_image(path)
    if Image is None:
        with open(path, "rb") as f:
            return _netpbm_header(f)[:3]
    with Image.open(path) as img:
        w, h = img.size
        ch = 1 if img.mode == "L" else 3
    return h, w, ch


def find_images(root: str, pattern: str = "*") -> list[str]:
    """Sorted image files under a directory (or matching a glob pattern)."""
    if os.path.isdir(root):
        paths = _glob.glob(os.path.join(root, pattern))
    else:
        paths = _glob.glob(root)
    return sorted(p for p in paths
                  if os.path.splitext(p)[1].lower() in IMAGE_EXTS
                  and os.path.isfile(p))


def load_batch(paths: list[str]) -> np.ndarray:
    """Load same-shape images into one [B,H,W(,3)] uint8 batch.

    Raises ValueError on a shape mismatch — callers with heterogeneous
    inputs should group by `probe` first (batch.run_batch does).
    """
    if not paths:
        raise ValueError("load_batch: empty path list")
    arrs = [load(p) for p in paths]
    shape = arrs[0].shape
    for p, a in zip(paths, arrs):
        if a.shape != shape:
            raise ValueError(
                f"load_batch: {p} has shape {a.shape}, expected {shape}")
    return np.stack(arrs)
