"""Kernel K1: pixels -> quantized zigzag blocks (int16) in scan order, the
first pass of the split encode path (counterpart of
jpgenc_tpu/ops/pallas/k1_dct.py, entry `fused_pixels_to_scan`).

`fused_pixels_to_scan` launches the CUDA kernels in `csrc/k1_dct.cu` for a
CUDA tensor (colour: the dense-operator kernel that replaces
`_dense_dma_kernel`; gray: the one that replaces `_gray_kernel`) and takes
the plain version `pixels_to_scan_plain` only for a CPU tensor:

  colour: replicate pad, MCU regroup in natural byte order, one f32 matmul
    against the dense operator (color + subsample + FDCT + zigzag), + bias,
    / q, round half away;
  gray: (x - 128) @ KDCT_ZZ, / q, round half away.

These are also the transform halves of the K1A kernels (ops/cuda/
k1a_fused.py), which call the same device functions: an image coded by
either path holds the same coefficients.

[n_mcu, (nb+2)*64] is the interleaved scan order (T.81 A.2.3), so
[B, n_mcu, (nb+2)*64] outputs are [B, n_slots, 64] slot arrays by a free
reshape. Restart intervals (segment padding slots) are not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from jpgenc_tpu_torch.kernels import build
from jpgenc_tpu_torch.ops.color import pad_replicate
from jpgenc_tpu_torch.ops.transform import _KDCT_ZZ, round_half_away

#: launches of the colour and of the gray CUDA kernel, and calls of the
#: plain version
launches = 0
launches_gray = 0
plain_calls = 0


@functools.lru_cache(maxsize=16)
def _dense_operator(hs: int, vs: int, basis: str = "byte_slot"
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(M [4L, (nb+2)*64], bias [1, (nb+2)*64]) fused color+subsample+DCT+
    zigzag operator over raw interleaved-RGB MCU bytes (k1_dct.py:95-137).

    basis selects the input-lane ordering; all three hold the same f32
    values, permuted by row:
      'byte_slot': lane = L*kb + (r*wpr + j) — byte kb of MCU word (r, j);
      'row_major': lane = (r*4 + kb)*wpr + j;
      'natural':   lane = r*4*wpr + 4*j + kb — the MCU's bytes in memory
        order (pixel row r, then pixel, then channel), the layout the CUDA
        K1A kernel loads into shared memory.
    bias carries the luma level shift (DCT of the constant -128 plane)."""
    mh, mw = 8 * vs, 8 * hs
    nb = hs * vs
    wpr = mw * 3 // 4                  # u32 words per MCU pixel row
    lw = mh * wpr                      # words per MCU
    n_out = (nb + 2) * 64
    k = np.asarray(_KDCT_ZZ, np.float64)     # [64, 64] pixel -> zz coef
    cy = (0.299, 0.587, 0.114)
    ccb = (-0.168735892, -0.331264108, 0.5)
    ccr = (0.5, -0.418687589, -0.081312411)
    m = np.zeros((4 * lw, n_out), np.float64)
    for w in range(lw):
        r, j = divmod(w, wpr)
        for kb in range(4):
            px, c = divmod(4 * j + kb, 3)
            if basis == "byte_slot":
                lane = lw * kb + w
            elif basis == "row_major":
                lane = (r * 4 + kb) * wpr + j
            elif basis == "natural":
                lane = r * 4 * wpr + 4 * j + kb
            else:
                raise ValueError(f"unknown basis {basis!r}")
            blk = (r // 8) * hs + (px // 8)
            pos = (r % 8) * 8 + (px % 8)
            m[lane, blk * 64:(blk + 1) * 64] += cy[c] * k[pos]
            cpos = (r // vs) * 8 + (px // hs)
            wgt = 1.0 / (hs * vs)
            m[lane, nb * 64:(nb + 1) * 64] += ccb[c] * wgt * k[cpos]
            m[lane, (nb + 1) * 64:] += ccr[c] * wgt * k[cpos]
    bias = np.concatenate([np.tile(-128.0 * k.sum(axis=0), nb),
                           np.zeros(128)])
    return m.astype(np.float32), bias.astype(np.float32).reshape(1, -1)


def geometry(layout) -> tuple[int, int, int]:
    """(hs, vs, luma blocks per MCU) of a layout the kernels take."""
    if layout.restart_interval:
        raise NotImplementedError(
            "restart intervals are not ported yet: ROADMAP.md Queue 1 item 5")
    c0 = layout.comps[0]
    return c0.hs, c0.vs, c0.hs * c0.vs


def mcu_bytes(imgs: torch.Tensor, layout) -> torch.Tensor:
    """Colour [B, H, W, 3] u8 -> [B, n_mcu, 3*mh*mw] u8: each MCU's
    replicate-padded bytes in memory order (pixel row, pixel, channel) — the
    'natural' basis of _dense_operator. Gray [B, H, W] u8 -> [B, n_blocks,
    64] u8: each 8x8 block row-major."""
    hs, vs, _ = geometry(layout)
    c0 = layout.comps[0]
    b = imgs.shape[0]
    my, mx = layout.mcus_y, layout.mcus_x
    if layout.is_gray:
        padded = pad_replicate(imgs[..., None], c0.plane_h, c0.plane_w)
        return (padded.reshape(b, my, 8, mx, 8).permute(0, 1, 3, 2, 4)
                .reshape(b, my * mx, 64))
    mh, mw = 8 * vs, 8 * hs
    padded = pad_replicate(imgs, c0.plane_h, c0.plane_w)
    return (padded.reshape(b, my, mh, mx, 3 * mw).permute(0, 1, 3, 2, 4)
            .reshape(b, my * mx, 3 * mh * mw))


def transform_plain(imgs, layout, m, bias, q) -> torch.Tensor:
    """Pixels -> quantized zigzag [B, n_mcu, (nb+2)*64] int32 (gray:
    [B, n_blocks, 64]).

    Colour: m [3*mh*mw, (nb+2)*64] f32 natural-basis operator; bias, q
    [(nb+2)*64] f32 (q tiled per block: luma nb times, then chroma twice).
    Gray: m is KDCT_ZZ [64, 64], q [64] the luma row in zigzag order, and
    the level shift is taken from the pixels, so bias is not used."""
    x = mcu_bytes(imgs, layout).to(torch.float32)
    if layout.is_gray:
        out = torch.matmul(x - 128.0, m)
    else:
        out = torch.matmul(x, m) + bias
    return round_half_away(out / q).to(torch.int32)


def pixels_to_scan_plain(imgs, layout, m, bias, q) -> torch.Tensor:
    """The plain version of the K1 kernels: transform_plain as [B, n_slots,
    64] int16."""
    global plain_calls
    plain_calls += 1
    zz = transform_plain(imgs, layout, m, bias, q)
    return zz.reshape(zz.shape[0], -1, 64).to(torch.int16)


def check_operands(imgs: torch.Tensor, layout, m, bias, q) -> None:
    """Raise unless imgs and the transform operands are what the K1 / K1A
    kernels take for this layout: contiguous, on imgs' device, of the
    expected type and shape."""
    _, _, nb = geometry(layout)
    hw = (layout.height, layout.width)
    if layout.is_gray:
        shape = imgs.shape[:1] + hw
        ops = [(m, (64, 64)), (q, (64,))]
    else:
        l_out = (nb + 2) * 64
        shape = imgs.shape[:1] + hw + (3,)
        ops = [(m, (3 * 64 * nb, l_out)), (bias, (l_out,)), (q, (l_out,))]
    if (imgs.dtype != torch.uint8 or tuple(imgs.shape) != tuple(shape)
            or not imgs.is_contiguous()):
        raise ValueError(f"imgs must be a contiguous uint8 tensor of shape "
                         f"[B, {', '.join(map(str, shape[1:]))}] matching "
                         f"the layout, got {tuple(imgs.shape)} {imgs.dtype}")
    for t, shp in ops:
        if (t.device != imgs.device or t.dtype != torch.float32
                or tuple(t.shape) != shp or not t.is_contiguous()):
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} {t.device}: "
                             f"expected contiguous {shp} float32 on "
                             f"{imgs.device}")


def fused_pixels_to_scan(imgs: torch.Tensor, layout, m, bias, q
                         ) -> torch.Tensor:
    """[B, H, W, 3] u8 (gray: [B, H, W]) -> quantized zigzag blocks
    [B, n_slots, 64] int16 in interleaved scan order. Operands as
    transform_plain. On a CUDA tensor this launches the K1 kernel (or
    raises); on a CPU tensor it runs the plain version."""
    global launches, launches_gray
    hs, vs, _ = geometry(layout)
    if imgs.device.type == "cpu":
        return pixels_to_scan_plain(imgs, layout, m, bias, q)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    check_operands(imgs, layout, m, bias, q)
    b, h, w = imgs.shape[:3]
    zz = torch.empty((b, layout.n_scan, 64), dtype=torch.int16,
                     device=imgs.device)
    lib = build.library()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if layout.is_gray:
            rc = lib.k1_gray_launch(imgs.data_ptr(), b, h, w, m.data_ptr(),
                                    q.data_ptr(), zz.data_ptr(), stream)
        else:
            rc = lib.k1_dct_launch(imgs.data_ptr(), b, h, w, hs, vs,
                                   m.data_ptr(), bias.data_ptr(),
                                   q.data_ptr(), zz.data_ptr(), stream)
    build.check(rc, "k1_dct")
    if layout.is_gray:
        launches_gray += 1
    else:
        launches += 1
    return zz
