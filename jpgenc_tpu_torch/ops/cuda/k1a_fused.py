"""Kernel 1, K1A: pixels -> per-block Huffman-packed words in one pass
(counterpart of jpgenc_tpu/ops/pallas/k1a_fused.py).

`fused_pixels_to_pack` launches the CUDA kernel in `csrc/k1a_fused.cu`
(colour, replaces `_k1a_kernel`) or `csrc/k1a_gray.cu` (gray, replaces
`_k1a_gray_kernel`) for a CUDA tensor and takes the plain version
`pixels_to_pack_plain` only for a CPU tensor. The plain version is
`entropy_plain(transform_plain(...))`:

  transform_plain (ops/cuda/k1_dct.py, K1's plain version): the function of
    the kernels' first half (k1a_fused.py:62-71, :376-378) as the shared
    per-block transform: BT.601, box subsample, - 128, each 8x8 block times
    KDCT_ZZ, / q, round half away;
  entropy_plain: DC DPCM (the Y chain in (mcu, blk) order, chroma per MCU,
    gray block to block in raster order; reset at every restart-segment
    start, MCU g with g % mps == 0, mps = restart_interval or n_mcus) and
    the per-block pack of block_pack.pack_blocks_plain — bit-identical to
    the kernel given the same coefficients.

Scan order is (mcu, blk) row-major, so [B, n_mcu, nb+2, w_blk] outputs are
[B, n_slots, w_blk] slot arrays by a free reshape. With a restart interval
both outputs are padded to whole segments, S = n_segments *
blocks_per_segment slots, with zero words and zero bits
(k1a_fused.py:587-592).
"""
from __future__ import annotations

import torch

from jpgenc_tpu_torch.kernels import build
from jpgenc_tpu_torch.ops.cuda.block_pack import pack_blocks_plain
from jpgenc_tpu_torch.ops.cuda.k1_dct import (check_operands, geometry,
                                              n_slots_padded, pad_slots,
                                              transform_plain)

#: launches of the colour and of the gray CUDA kernel, and calls of the
#: plain version
launches = 0
launches_gray = 0
plain_calls = 0

#: widest per-block word tier the kernel's word scratch holds (the worst
#: tier, which covers MAX_BLOCK_BITS)
MAX_W_BLK = 56


def entropy_plain(zz: torch.Tensor, layout, tables, w_blk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized zigzag [B, n_mcu, (nb+2)*64] (gray: [B, n_blocks, 64]) ->
    (buf [B, S, w_blk] int32 u32 bit patterns, bits [B, S] int32), S padded
    to whole segments. tables: block_pack.packed_tables(luts) on zz's
    device."""
    _, _, nb = geometry(layout)
    b, n_mcu = zz.shape[0], zz.shape[1]
    per = 1 if layout.is_gray else nb + 2            # blocks per MCU
    mps = layout.restart_interval or layout.n_mcus
    z = zz.reshape(b, n_mcu, per, 64)
    dc = z[..., 0].to(torch.int64)                   # [B, n_mcu, per]
    prev = torch.zeros_like(dc)
    prev[:, 1:, 0] = dc[:, :-1, nb - 1]              # Y from the last MCU
    prev[:, 1:, nb:] = dc[:, :-1, nb:]               # Cb, Cr per MCU
    reset = torch.arange(n_mcu, device=zz.device) % mps == 0
    prev[:, reset] = 0                               # segment start
    prev[:, :, 1:nb] = dc[:, :, :nb - 1]             # Y chain within the MCU
    tab = (torch.arange(per, device=zz.device) >= nb).to(torch.int64)
    buf, bits = pack_blocks_plain(z.reshape(-1, 64), (dc - prev).reshape(-1),
                                  tab.expand(b, n_mcu, per).reshape(-1),
                                  tables, w_blk)
    return (pad_slots(buf.reshape(b, -1, w_blk), layout),
            pad_slots(bits.reshape(b, -1), layout))


def pixels_to_pack_plain(imgs, layout, kdct, q, tables, w_blk: int):
    """The plain version of the K1A kernel: entropy_plain(transform_plain)."""
    global plain_calls
    plain_calls += 1
    return entropy_plain(transform_plain(imgs, layout, kdct, q), layout,
                         tables, w_blk)


def fused_pixels_to_pack(imgs: torch.Tensor, layout, kdct, q, tables,
                         w_blk: int, return_zz: bool = False):
    """[B, H, W, 3] u8 (gray: [B, H, W]) -> (buf [B, S, w_blk] int32,
    bits [B, S] int32[, zz [B, n_mcu, (nb+2)*64] int16]), S = n_segments *
    blocks_per_segment slots, the pad slots zero.

    Operands as k1_dct.transform_plain; tables is one shared set,
    block_pack.packed_tables(luts) (gray codes with table 0). Blocks that
    need more than 32*w_blk bits keep their first w_blk words and their true
    bit count; callers test bits.max() > 32*w_blk. On a CUDA tensor this
    launches the K1A kernel (or raises); on a CPU tensor it runs the plain
    version. return_zz also returns the quantized coefficients (the kernel's
    debug output, for the GPU checks)."""
    global launches, launches_gray
    hs, vs, nb = geometry(layout)
    if imgs.device.type == "cpu":
        if return_zz:
            zz = transform_plain(imgs, layout, kdct, q)
            buf, bits = entropy_plain(zz, layout, tables, w_blk)
            return buf, bits, zz.to(torch.int16)
        return pixels_to_pack_plain(imgs, layout, kdct, q, tables, w_blk)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    check_operands(imgs, layout, kdct, q)
    if not 1 <= w_blk <= MAX_W_BLK:
        raise ValueError(f"w_blk must be in [1, {MAX_W_BLK}], got {w_blk}")
    ac_rows, dc_rows, misc = tables
    for t, shape in ((ac_rows, (4, 128)), (dc_rows, (2, 128)), (misc, (4,))):
        if (t.device != imgs.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} {t.device}: "
                             f"expected contiguous {shape} int32 on "
                             f"{imgs.device}")
    b, h, w = imgs.shape[:3]
    n_slots, mps = n_slots_padded(layout), \
        layout.restart_interval or layout.n_mcus
    buf = torch.empty((b, n_slots, w_blk), dtype=torch.int32,
                      device=imgs.device)
    bits = torch.empty((b, n_slots), dtype=torch.int32, device=imgs.device)
    if n_slots > layout.n_scan:
        buf[:, layout.n_scan:].zero_()
        bits[:, layout.n_scan:].zero_()
    zz = (torch.empty((b, layout.n_mcus, layout.blocks_per_mcu * 64),
                      dtype=torch.int16, device=imgs.device)
          if return_zz else None)
    zz_ptr = zz.data_ptr() if zz is not None else None
    lib = build.library()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if layout.is_gray:
            rc = lib.k1a_gray_launch(
                imgs.data_ptr(), b, h, w, mps, n_slots, kdct.data_ptr(),
                q.data_ptr(), ac_rows.data_ptr(), dc_rows.data_ptr(), misc.data_ptr(),
                w_blk, buf.data_ptr(), bits.data_ptr(), zz_ptr, stream)
        else:
            rc = lib.k1a_fused_launch(
                imgs.data_ptr(), b, h, w, hs, vs, mps, n_slots,
                kdct.data_ptr(), q.data_ptr(),
                ac_rows.data_ptr(), dc_rows.data_ptr(), misc.data_ptr(),
                w_blk, buf.data_ptr(), bits.data_ptr(), zz_ptr, stream)
    build.check(rc, "k1a_fused")
    if layout.is_gray:
        launches_gray += 1
    else:
        launches += 1
    return (buf, bits, zz) if return_zz else (buf, bits)
