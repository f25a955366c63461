"""Kernel K1: pixels -> quantized zigzag blocks (int16) in scan order, the
first pass of the split encode path (counterpart of
jpgenc_tpu/ops/pallas/k1_dct.py, entry `fused_pixels_to_scan`).

`fused_pixels_to_scan` launches one of the CUDA kernels in `csrc/k1_dct.cu`
for a CUDA tensor and takes a plain version only for a CPU tensor. Colour
has three variants, one per Pallas kernel of the reference:

  "rows" (replaces `_dense_dma_kernel`): MCUs read from the image as it
    lies, tiles of MCUs of one image;
  "repack" (replaces `_dense_kernel`): the same dense operator over the
    MCU-contiguous repack `mcu_bytes` (torch ops, the reference's XLA
    prologue `mcu_pack_words`), flat tiles that ignore image rows. Taken
    where the reference takes it: frames whose MCU row is past ROW_GATE_BYTES;
  "separable" (replaces `_color_kernel`): BT.601, then one 64x64 product per
    luma block and one [nb*64, 64] product per chroma plane. Taken for every
    colour frame when the module switch K1_DENSE is False.

The plain versions:

  dense colour (`pixels_to_scan_plain`, both dense variants): replicate pad,
    MCU regroup in natural byte order, one f32 matmul against the dense
    operator (color + subsample + FDCT + zigzag), + bias, / q, round half
    away;
  separable colour (`color_plain`): BT.601 elementwise in the reference's
    order of operations, per-block matmul with KDCT_ZZ, matmul with sc, / q,
    round half away;
  gray: (x - 128) @ KDCT_ZZ, / q, round half away.

The dense kernels are also the transform halves of the K1A kernels
(ops/cuda/k1a_fused.py), which call the same device functions: an image
coded by either path holds the same coefficients. The separable kernel's
sums associate differently, so it agrees with them except at knife edges of
the rounding (k1_dct.py:18-24).

[n_mcu, (nb+2)*64] is the interleaved scan order (T.81 A.2.3), so
[B, n_mcu, (nb+2)*64] outputs are [B, n_slots, 64] slot arrays by a free
reshape. With a restart interval the slot arrays are padded with zero blocks
to whole segments, S = n_segments * blocks_per_segment (k1_dct.py:373-374).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from jpgenc_tpu_torch import tables as T
from jpgenc_tpu_torch.kernels import build
from jpgenc_tpu_torch.ops.color import pad_replicate
from jpgenc_tpu_torch.ops.transform import _KDCT_ZZ, round_half_away

#: launches of each CUDA kernel (colour rows / repack / separable, gray), and
#: calls of a plain version
launches = 0
launches_repack = 0
launches_color = 0
launches_gray = 0
plain_calls = 0

#: colour variant switch (k1_dct.py:92): True takes the dense operator (rows
#: or repack by the row gate), False the separable kernel for every colour
#: frame. One process keeps one setting, so no file mixes formulations.
K1_DENSE = True

#: The reference's row gate (k1_dct.py:298): bytes of one MCU row's word
#: block as its row kernel holds it (8*vs rows x mcus_x MCUs x 128 padded
#: lanes x 4 bytes). Past it the reference must leave the row kernel for the
#: repack kernel (4:2:0: frames wider than 8192 px). On the H100 this is a
#: choice, not a capacity limit: it is kept so that both packages take the
#: same variant for the same frame.
ROW_GATE_BYTES = 4 << 20

VARIANTS = ("rows", "repack", "separable")


def k1_variant(layout) -> str:
    """The colour variant fused_pixels_to_scan takes by default."""
    if not K1_DENSE:
        return "separable"
    c0 = layout.comps[0]
    if 8 * c0.vs * layout.mcus_x * 128 * 4 <= ROW_GATE_BYTES:
        return "rows"
    return "repack"


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


@functools.lru_cache(maxsize=8)
def _subsample_matrix(nb: int, hs: int, vs: int) -> np.ndarray:
    """[nb*64, 64] box-mean matrix: full-res chroma pixels (Y-block layout)
    -> 8x8 subsampled chroma block (row-major), weights 1/(hs*vs)
    (k1_dct.py:48-63)."""
    s = np.zeros((nb * 64, 64), np.float32)
    for i in range(8):
        for j in range(8):
            for di in range(vs):
                for dj in range(hs):
                    p, q = vs * i + di, hs * j + dj       # luma-grid pixel
                    blk = (p // 8) * hs + q // 8          # row-major block id
                    s[blk * 64 + (p % 8) * 8 + (q % 8), 8 * i + j] = \
                        1.0 / (hs * vs)
    return s


def build_operators(layout, qtabs) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """The separable operators of one layout (k1_dct.py:66-85; qtabs [2, 64]
    natural order): (bd_y [nb*64, nb*64] block-diagonal KDCT_ZZ, sc
    [nb*64, 64] = S_sub @ KDCT_ZZ, q_out [1, (nb+2)*64]) f32. Every row of
    S_sub holds one weight, a power of two, so sc is exact in float32."""
    c0 = layout.comps[0]
    nb = c0.hs * c0.vs
    zz = np.asarray(T.ZIGZAG)
    q = np.asarray(qtabs).reshape(2, 64).astype(np.float32)[:, zz]
    bd_y = np.kron(np.eye(nb, dtype=np.float32), _KDCT_ZZ)
    sc = _subsample_matrix(nb, c0.hs, c0.vs) @ _KDCT_ZZ
    q_out = np.concatenate([np.tile(q[0], nb), q[1], q[1]]).reshape(1, -1)
    return bd_y, sc.astype(np.float32), q_out


def separable_operator(bd_y: np.ndarray, sc: np.ndarray) -> np.ndarray:
    """build_operators' bd_y and sc -> the one operand the separable kernel
    and color_plain take: sep [(1 + nb) * 64, 64] f32, rows 0..63 bd_y's
    first diagonal block (KDCT_ZZ), rows 64.. sc."""
    return np.ascontiguousarray(
        np.concatenate([np.asarray(bd_y)[:64, :64], np.asarray(sc)]),
        np.float32)


def geometry(layout) -> tuple[int, int, int]:
    """(hs, vs, luma blocks per MCU) of a layout the kernels take."""
    c0 = layout.comps[0]
    return c0.hs, c0.vs, c0.hs * c0.vs


def n_slots_padded(layout) -> int:
    """Slots per image, padded to whole restart segments."""
    return layout.n_segments * layout.blocks_per_segment


def pad_slots(x: torch.Tensor, layout) -> torch.Tensor:
    """[B, n_scan, ...] -> [B, S, ...], zero slots appended
    (k1_dct.py:373-374, k1a_fused.py:587-592)."""
    pad = n_slots_padded(layout) - x.shape[1]
    if pad == 0:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


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
    """The plain version of the dense K1 kernels (rows and repack) and of
    the gray one: transform_plain as [B, S, 64] int16, zero blocks past
    n_scan."""
    global plain_calls
    plain_calls += 1
    zz = transform_plain(imgs, layout, m, bias, q)
    return pad_slots(zz.reshape(zz.shape[0], -1, 64).to(torch.int16), layout)


def mcu_planar(imgs: torch.Tensor, layout) -> torch.Tensor:
    """Colour [B, H, W, 3] u8 -> [B, n_mcu, 3, nb*64] u8: per MCU the
    channels major, luma blocks in row-major (v, h) order, pixels row-major
    (the reference's mcu_pack, k1_dct.py:185-196)."""
    hs, vs, nb = geometry(layout)
    c0 = layout.comps[0]
    b = imgs.shape[0]
    my, mx = layout.mcus_y, layout.mcus_x
    x = pad_replicate(imgs, c0.plane_h, c0.plane_w)
    x = x.reshape(b, my, vs, 8, mx, hs, 8, 3).permute(0, 1, 4, 7, 2, 5, 3, 6)
    return x.reshape(b, my * mx, 3, nb * 64)


def color_transform_plain(imgs, layout, sep, q) -> torch.Tensor:
    """The separable transform (k1_dct.py:203-222) -> [B, n_mcu, (nb+2)*64]
    int32. sep [(1+nb)*64, 64] f32 (separable_operator), q [(nb+2)*64] f32."""
    _, _, nb = geometry(layout)
    x = mcu_planar(imgs, layout).to(torch.float32)
    r, g, b = x[:, :, 0], x[:, :, 1], x[:, :, 2]          # [B, n_mcu, nb*64]
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168735892 * r + -0.331264108 * g + 0.5 * b
    cr = 0.5 * r + -0.418687589 * g + -0.081312411 * b
    kdct, sc = sep[:64], sep[64:]
    y_zz = torch.matmul(y.reshape(*y.shape[:2], nb, 64), kdct)
    out = torch.cat([y_zz.reshape(*y.shape[:2], nb * 64),
                     torch.matmul(cb, sc), torch.matmul(cr, sc)], dim=-1)
    return round_half_away(out / q).to(torch.int32)


def color_plain(imgs, layout, sep, q) -> torch.Tensor:
    """The plain version of the separable K1 kernel: color_transform_plain
    as [B, S, 64] int16, zero blocks past n_scan."""
    global plain_calls
    plain_calls += 1
    zz = color_transform_plain(imgs, layout, sep, q)
    return pad_slots(zz.reshape(zz.shape[0], -1, 64).to(torch.int16), layout)


@functools.lru_cache(maxsize=16)
def _sep_on(hs: int, vs: int, device: str) -> torch.Tensor:
    """separable_operator of a sampling on a device (layout-static)."""
    nb = hs * vs
    sc = _subsample_matrix(nb, hs, vs) @ _KDCT_ZZ
    return torch.from_numpy(separable_operator(_KDCT_ZZ, sc)).to(device)


def _check(t, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"operand {tuple(t.shape)} {t.dtype} {t.device}: "
                         f"expected contiguous {shape} {dtype} on {device}")


def check_operands(imgs: torch.Tensor, layout, m, bias, q) -> None:
    """Raise unless imgs and the transform operands are what the K1 / K1A
    kernels take for this layout: contiguous, on imgs' device, of the
    expected type and shape. bias is None for the separable kernel, whose
    operator m is sep."""
    _, _, nb = geometry(layout)
    hw = (layout.height, layout.width)
    f32 = torch.float32
    if layout.is_gray:
        shape = imgs.shape[:1] + hw
        ops = [(m, (64, 64)), (q, (64,))]
    else:
        l_out = (nb + 2) * 64
        shape = imgs.shape[:1] + hw + (3,)
        if bias is None:
            ops = [(m, ((1 + nb) * 64, 64)), (q, (l_out,))]
        else:
            ops = [(m, (3 * 64 * nb, l_out)), (bias, (l_out,)), (q, (l_out,))]
    if (imgs.dtype != torch.uint8 or tuple(imgs.shape) != tuple(shape)
            or not imgs.is_contiguous()):
        raise ValueError(f"imgs must be a contiguous uint8 tensor of shape "
                         f"[B, {', '.join(map(str, shape[1:]))}] matching "
                         f"the layout, got {tuple(imgs.shape)} {imgs.dtype}")
    for t, shp in ops:
        _check(t, f32, shp, imgs.device)


def fused_pixels_to_scan(imgs: torch.Tensor, layout, m, bias, q,
                         variant: str | None = None,
                         sep: torch.Tensor | None = None) -> torch.Tensor:
    """[B, H, W, 3] u8 (gray: [B, H, W]) -> quantized zigzag blocks
    [B, S, 64] int16 in interleaved scan order, S padded to whole restart
    segments with zero blocks. Operands as transform_plain. variant picks
    the colour kernel ("rows", "repack", "separable"; None: k1_variant, the
    reference's selection); the separable one takes sep (separable_operator;
    None: built for the layout) and ignores m and bias. On a CUDA tensor
    this launches the kernel (or raises); on a CPU tensor it runs the plain
    version."""
    global launches, launches_repack, launches_color, launches_gray
    hs, vs, _ = geometry(layout)
    if layout.is_gray:
        variant = None
    else:
        variant = variant or k1_variant(layout)
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{variant!r}")
    if variant == "separable" and sep is None:
        sep = _sep_on(hs, vs, str(imgs.device))
    if imgs.device.type == "cpu":
        if variant == "separable":
            return color_plain(imgs, layout, sep, q)
        return pixels_to_scan_plain(imgs, layout, m, bias, q)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    if variant == "separable":
        check_operands(imgs, layout, sep, None, q)
    else:
        check_operands(imgs, layout, m, bias, q)
    b, h, w = imgs.shape[:3]
    s_pad = n_slots_padded(layout)
    zz = torch.empty((b, s_pad, 64), dtype=torch.int16, device=imgs.device)
    if s_pad > layout.n_scan:
        zz[:, layout.n_scan:].zero_()
    # the repack is the torch prologue of its kernel (XLA in the reference)
    src = mcu_bytes(imgs, layout).contiguous() if variant == "repack" else imgs
    lib = build.library()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if layout.is_gray:
            rc = lib.k1_gray_launch(imgs.data_ptr(), b, h, w, s_pad,
                                    m.data_ptr(), q.data_ptr(), zz.data_ptr(),
                                    stream)
        else:
            op = sep if variant == "separable" else m
            rc = lib.k1_dct_launch(
                VARIANTS.index(variant), src.data_ptr(), b, h, w, hs, vs,
                s_pad, op.data_ptr(),
                None if variant == "separable" else bias.data_ptr(),
                q.data_ptr(), zz.data_ptr(), stream)
    build.check(rc, "k1_dct")
    if layout.is_gray:
        launches_gray += 1
    elif variant == "rows":
        launches += 1
    elif variant == "repack":
        launches_repack += 1
    else:
        launches_color += 1
    return zz
