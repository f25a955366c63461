"""Color-stage helpers (counterpart of jpgenc_tpu/ops/color.py)."""
from __future__ import annotations

import torch


def pad_replicate(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replicate-pad [..., H, W, C] to [..., ph, pw, C] (color.py:82-86).

    Row and column indices are clamped to H-1 / W-1, the same rule the K1A
    kernel applies to its loads, so the result is exact for any dtype."""
    h, w = img.shape[-3], img.shape[-2]
    rows = torch.arange(ph, device=img.device).clamp_(max=h - 1)
    cols = torch.arange(pw, device=img.device).clamp_(max=w - 1)
    return img.index_select(-3, rows).index_select(-2, cols)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """[..., 3] float32 YCbCr -> float32 RGB, unclipped (color.py:26-34:
    the same constants and order of float32 operations)."""
    y = ycc[..., 0]
    cb = ycc[..., 1] - 128.0
    cr = ycc[..., 2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def upsample(plane: torch.Tensor, hs: int, vs: int) -> torch.Tensor:
    """Nearest-neighbour (replication) upsample of [..., H, W]
    (color.py:46-50)."""
    if hs == 1 and vs == 1:
        return plane
    return plane.repeat_interleave(vs, dim=-2).repeat_interleave(hs, dim=-1)


def _upsample2_axis(plane: torch.Tensor, axis: int) -> torch.Tensor:
    """Centered 2x upsample along one axis with the 3:1 triangle filter
    libjpeg calls "fancy" upsampling (color.py:53-64): out[2i] = 0.75 c[i] +
    0.25 c[i-1], out[2i+1] = 0.75 c[i] + 0.25 c[i+1], edges replicated."""
    x = plane.movedim(axis, 0)
    prev = torch.cat([x[:1], x[:-1]], dim=0)
    nxt = torch.cat([x[1:], x[-1:]], dim=0)
    even = 0.75 * x + 0.25 * prev
    odd = 0.75 * x + 0.25 * nxt
    out = torch.stack([even, odd], dim=1).reshape((-1,) + x.shape[1:])
    return out.movedim(0, axis)


def upsample_fancy(plane: torch.Tensor, hs: int, vs: int) -> torch.Tensor:
    """Triangle-filter upsample of [..., H, W], vertically first, then
    horizontally; factors other than 2 fall back to replication
    (color.py:67-79)."""
    out = plane
    if vs == 2:
        out = _upsample2_axis(out, -2)
    elif vs != 1:
        out = out.repeat_interleave(vs, dim=-2)
    if hs == 2:
        out = _upsample2_axis(out, -1)
    elif hs != 1:
        out = out.repeat_interleave(hs, dim=-1)
    return out
