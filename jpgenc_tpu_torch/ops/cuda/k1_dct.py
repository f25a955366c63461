"""Kernel K1: pixels -> quantized zigzag blocks (int16) in scan order, the
first pass of the split encode path (counterpart of
jpgenc_tpu/ops/pallas/k1_dct.py, entry `fused_pixels_to_scan`).

`fused_pixels_to_scan` launches one of the CUDA kernels in `csrc/k1_dct.cu`
for a CUDA tensor and takes a plain version only for a CPU tensor. Colour
has three variants, one per Pallas kernel of the reference:

  "rows" (replaces `_dense_dma_kernel`): MCUs read from the image as it
    lies, tiles of MCUs inside one MCU row of one image;
  "repack" (replaces `_dense_kernel`): the same transform over the
    MCU-contiguous repack `mcu_bytes` (torch ops, the reference's XLA
    prologue `mcu_pack_words`), flat tiles that ignore image rows. Taken
    where the reference takes it: frames whose MCU row is past ROW_GATE_BYTES;
  "separable" (replaces `_color_kernel`): BT.601, then one 64x64 product per
    luma block and one [nb*64, 64] product per chroma plane. Taken for every
    colour frame when the module switch K1_DENSE is False. Tiles of
    SEP_TILE * 4 / nb MCUs inside one MCU row; the kernel reads KDCT_ZZ, the
    first 64 rows of sep, and never sc: its chroma samples carry the exact
    1 / (hs*vs) that each row of sc holds (build_operators), so every
    product, and so every sum, is the plain version's.

Gray has one kernel (replaces `_gray_kernel`): each 8x8 block of
(pixel - 128) times KDCT_ZZ, / q, round half away, over tiles of GRAY_TILE
blocks inside one block row. It is the transform half of the gray K1A kernel
and calls the same device functions, so the two hold the same coefficients.

The reference's two dense kernels multiply an MCU's bytes by one dense
[3*mh*mw, (nb+2)*64] operator built for a matrix unit. "rows" and "repack"
compute the same function per block instead (the shared transform), in the
order of the reference's own path off the TPU (engine.pixels_to_scan):

  1. BT.601 per pixel (ops/color.py:15-23: y, cb + 128, cr + 128);
  2. box-mean subsample of the chroma planes, the hs x vs samples added in
     row-major order, times 1 / (hs*vs);
  3. - 128 on every sample;
  4. each 8x8 block times KDCT_ZZ [64, 64];
  5. / q (a true division), round half away.

The plain versions:

  the shared transform (`transform_plain`, `pixels_to_scan_plain`; colour
    and gray): those five steps in torch ops, gray from step 3;
  separable colour (`color_plain`): BT.601 elementwise in the reference's
    order of operations, per-block matmul with KDCT_ZZ, matmul with sc, / q,
    round half away.

The "rows" and "repack" kernels are also the transform half of the K1A
kernel (ops/cuda/k1a_fused.py), which calls the same device functions: an
image coded by either path holds the same coefficients. The separable kernel
subsamples after the products, so its sums associate differently and it
agrees with them except at knife edges of the rounding (k1_dct.py:18-24).

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

#: colour variant switch (k1_dct.py:92). In the reference True takes the
#: dense operator; here True takes its counterpart, the shared per-block
#: transform (the kernel K1A also runs: rows or repack by the row gate), and
#: False the separable kernel for every colour frame. One process keeps one
#: setting, so no file mixes formulations.
K1_DENSE = True

#: The reference's row gate (k1_dct.py:298): bytes of one MCU row's word
#: block as its row kernel holds it (8*vs rows x mcus_x MCUs x 128 padded
#: lanes x 4 bytes). Past it the reference must leave the row kernel for the
#: repack kernel (4:2:0: frames wider than 8192 px). On the H100 this is a
#: choice, not a capacity limit: it is kept so that both packages take the
#: same variant for the same frame.
ROW_GATE_BYTES = 4 << 20

#: 8x8 blocks a thread block of the gray kernels (gray K1, gray K1A) takes,
#: consecutive inside one block row: csrc/common.cuh's kGrayTile, 16 blocks
#: times JPGENC_GRAY_BPT (kernels/gray_sweep.py rebuilds with others)
GRAY_TILE = 128

#: MCUs a thread block of the separable kernel takes in 4:2:0, inside one MCU
#: row (4:2:2 twice as many, 4:4:4 four times: 32 luma blocks):
#: csrc/common.cuh's JPGENC_SEP_TILE (kernels/separable_sweep.py rebuilds
#: with others)
SEP_TILE = 8

VARIANTS = ("rows", "repack", "separable")


def k1_variant(layout) -> str:
    """The colour variant fused_pixels_to_scan takes by default."""
    if not K1_DENSE:
        return "separable"
    c0 = layout.comps[0]
    if 8 * c0.vs * layout.mcus_x * 128 * 4 <= ROW_GATE_BYTES:
        return "rows"
    return "repack"


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
    S_sub holds one weight, a power of two, so sc is exact in float32: row k
    is KDCT_ZZ[c] * (1 / (hs*vs)), c the chroma position sample k falls
    into, which is how the separable kernel uses it."""
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
    replicate-padded bytes in memory order (pixel row, pixel, channel), the
    repack kernel's input. Gray [B, H, W] u8 -> [B, n_blocks,
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


def box_mean(plane: torch.Tensor, hs: int, vs: int) -> torch.Tensor:
    """[B, H, W] f32 -> [B, H/vs, W/hs]: the mean of every vs x hs box, its
    samples added in row-major order and the sum scaled by the exact
    1 / (hs*vs) (color.py:37-43)."""
    if hs == 1 and vs == 1:
        return plane
    b, h, w = plane.shape
    p = plane.reshape(b, h // vs, vs, w // hs, hs)
    total = None
    for i in range(vs):
        for j in range(hs):
            total = p[:, :, i, :, j] if total is None else \
                total + p[:, :, i, :, j]
    return total * (1.0 / (hs * vs))


#: BT.601 full range (color.py:20-22) as the float32 values the kernels hold,
#: so that a float64 evaluation measures the same function
_Y, _CB, _CR = (tuple(float(np.float32(c)) for c in row) for row in (
    (0.299, 0.587, 0.114), (-0.168735892, -0.331264108, 0.5),
    (0.5, -0.418687589, -0.081312411)))


def mcu_samples(imgs: torch.Tensor, layout,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Colour [B, H, W, 3] u8 -> [B, n_mcu, nb+2, 64]: steps 1-3 of the
    shared transform. Per MCU its blocks in scan order (Y blocks row-major,
    Cb, Cr), each 8x8 block of level-shifted samples row-major. dtype
    float64 gives the checks their near-exact value of the same function."""
    hs, vs, nb = geometry(layout)
    c0 = layout.comps[0]
    n = imgs.shape[0]
    my, mx = layout.mcus_y, layout.mcus_x
    x = pad_replicate(imgs, c0.plane_h, c0.plane_w).to(dtype)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = _Y[0] * r + _Y[1] * g + _Y[2] * b
    cb = _CB[0] * r + _CB[1] * g + _CB[2] * b + 128.0
    cr = _CR[0] * r + _CR[1] * g + _CR[2] * b + 128.0
    yb = ((y - 128.0).reshape(n, my, vs, 8, mx, hs, 8)
          .permute(0, 1, 4, 2, 5, 3, 6).reshape(n, my * mx, nb, 64))
    chroma = [((box_mean(c, hs, vs) - 128.0).reshape(n, my, 8, mx, 8)
               .permute(0, 1, 3, 2, 4).reshape(n, my * mx, 1, 64))
              for c in (cb, cr)]
    return torch.cat([yb, *chroma], dim=2)


def scaled_coefficients(imgs, layout, kdct, q,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Steps 1-4 and the division of step 5, before the rounding:
    [B, n_mcu, (nb+2)*64] (gray: [B, n_blocks, 64]) in dtype."""
    if layout.is_gray:
        x = mcu_bytes(imgs, layout).to(dtype) - 128.0
    else:
        x = mcu_samples(imgs, layout, dtype)
    out = torch.matmul(x, kdct.to(dtype))
    return out.reshape(x.shape[0], x.shape[1], -1) / q.to(dtype)


def transform_plain(imgs, layout, kdct, q) -> torch.Tensor:
    """Pixels -> quantized zigzag [B, n_mcu, (nb+2)*64] int32 (gray:
    [B, n_blocks, 64]): the shared transform in torch ops.

    kdct is KDCT_ZZ [64, 64] f32. Colour: q [(nb+2)*64] f32, the quantizer
    in zigzag order tiled per block (luma nb times, then chroma twice).
    Gray: q [64], the luma row."""
    return round_half_away(
        scaled_coefficients(imgs, layout, kdct, q)).to(torch.int32)


def pixels_to_scan_plain(imgs, layout, kdct, q) -> torch.Tensor:
    """The plain version of the "rows" and "repack" K1 kernels and of the
    gray one: transform_plain as [B, S, 64] int16, zero blocks past
    n_scan."""
    global plain_calls
    plain_calls += 1
    zz = transform_plain(imgs, layout, kdct, q)
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


def check_operands(imgs: torch.Tensor, layout, op, q,
                   separable: bool = False) -> None:
    """Raise unless imgs and the transform operands are what the K1 / K1A
    kernels take for this layout: contiguous, on imgs' device, of the
    expected type and shape. op is KDCT_ZZ [64, 64], or sep for the
    separable kernel."""
    _, _, nb = geometry(layout)
    hw = (layout.height, layout.width)
    shape = imgs.shape[:1] + hw + (() if layout.is_gray else (3,))
    if (imgs.dtype != torch.uint8 or tuple(imgs.shape) != tuple(shape)
            or not imgs.is_contiguous()):
        raise ValueError(f"imgs must be a contiguous uint8 tensor of shape "
                         f"[B, {', '.join(map(str, shape[1:]))}] matching "
                         f"the layout, got {tuple(imgs.shape)} {imgs.dtype}")
    _check(op, torch.float32, ((1 + nb) * 64 if separable else 64, 64),
           imgs.device)
    _check(q, torch.float32, (64 if layout.is_gray else (nb + 2) * 64,),
           imgs.device)


def fused_pixels_to_scan(imgs: torch.Tensor, layout, kdct, q,
                         variant: str | None = None,
                         sep: torch.Tensor | None = None) -> torch.Tensor:
    """[B, H, W, 3] u8 (gray: [B, H, W]) -> quantized zigzag blocks
    [B, S, 64] int16 in interleaved scan order, S padded to whole restart
    segments with zero blocks. Operands as transform_plain. variant picks
    the colour kernel ("rows", "repack", "separable"; None: k1_variant, the
    reference's selection); the separable one takes sep (separable_operator;
    None: built for the layout) and ignores kdct. On a CUDA tensor this
    launches the kernel (or raises); on a CPU tensor it runs the plain
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
        return pixels_to_scan_plain(imgs, layout, kdct, q)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    op = sep if variant == "separable" else kdct
    check_operands(imgs, layout, op, q, separable=variant == "separable")
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
                                    kdct.data_ptr(), q.data_ptr(),
                                    zz.data_ptr(), stream)
        else:
            rc = lib.k1_dct_launch(
                VARIANTS.index(variant), src.data_ptr(), b, h, w, hs, vs,
                s_pad, op.data_ptr(), q.data_ptr(), zz.data_ptr(), stream)
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
