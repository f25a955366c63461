"""Decoder reconstruction: MCU-major quantized coefficients -> uint8 pixels
(counterpart of jpgenc_tpu/ops/pallas/recon.py, entry `fused_recon_rgb`).

`fused_recon_rgb` launches the CUDA kernels in `csrc/recon.cu` for a CUDA
tensor (colour: the kernel that replaces the inner `kernel` of
`_make_kernel`, recon.py:279; gray: the one that replaces `_gray_kernel`,
recon.py:246) and takes the plain version `recon_plain` only for a CPU
tensor:

  dequantize in zigzag order -> coef @ KIDCT_ZZ + 128 -> round half to even
  and clamp to [0, 255] per component sample (the T.81 range limit, chroma
  too) -> triangle chroma upsample, vertically then horizontally -> BT.601
  -> round, clip, uint8, cropped to the image.

The input is the MCU-major tensor [B, mcus_y, mcus_x, L] int16, L =
blocks_per_mcu * 64 (luma blocks row-major, then Cb, Cr; zigzag order within
a block): JPEG's interleaved scan-position space, which the decoder's
densify scatter fills directly. q_rows is [B, L] float32, the quant tables
in the same lane order (`decoder._q_rows`). Both must be 16-byte aligned
(the kernels read them 16 bytes at a time): every tensor torch allocates is.

The kernels hold four blocks' dequantized coefficients in shared memory and
give each thread 4 positions of 4 blocks, so a warp reads the operator row
and the coefficients once per 16 FMAs; a warp walks only the coefficients
that are nonzero in one of its 8 blocks (`product_terms` counts them). On
dense coefficients the FMAs and the loop's bookkeeping bound them, on sparse
ones the fixed work per block (load, stores, colour stage); PERF.md holds
the times. Leaving out a zero term is exact (csrc/recon.cu says why), so
each sample is the kernel's 64-term __fmaf_rn chain in k order.

The kernel and the plain version run the same float32 operations except for
the order of the 64-term IDCT sum (a matmul in the plain version), so pixels
agree except where a sum lands within an ulp of a rounding boundary: max
|diff| <= 1 on fewer than 1e-3 of the bytes (the limit the reference holds
its Pallas kernel to, tests/test_pallas_recon.py:24-30).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from jpgenc_tpu_torch import tables as T
from jpgenc_tpu_torch.kernels import build
from jpgenc_tpu_torch.ops import color as C
from jpgenc_tpu_torch.ops import transform as X

#: launches of the colour and of the gray CUDA kernel, and calls of the
#: plain version
launches = 0
launches_gray = 0
plain_calls = 0

_KERNEL_MODES = ((1, 1), (2, 1), (2, 2))

#: the kernels' tiles (csrc/recon.cu kTile, kGrayTile): MCUs, and gray
#: blocks, a thread block; a warp's products serve 8 consecutive blocks of
#: a tile
TILE, GRAY_TILE, WARP_BLOCKS = 16, 64, 8


def recon_applicable(layout) -> bool:
    """Static gate for the reconstruction kernels: gray and the samplings
    4:4:4, 4:2:2, 4:2:0 at any width and height, as long as every block is
    in the scan exactly once (the MCU-major tensor then holds all of them).
    The rarer decode-side samplings (4:1:1, 4:4:0, 4:1:0) take
    `pixels_from_scan` as torch ops, as they take XLA in the reference
    (recon.py:399-403). The kernels' only limits of their own are CUDA's
    grid dimensions: at most 65535 MCU rows and 65535 images a launch."""
    if sum(c.n_blocks for c in layout.comps) != layout.n_scan:
        return False
    if layout.mcus_y > 65535:
        return False
    if layout.is_gray:
        return True
    c0 = layout.comps[0]
    return (c0.hs, c0.vs) in _KERNEL_MODES and all(
        (c.hs, c.vs) == (1, 1) for c in layout.comps[1:])


@functools.lru_cache(maxsize=4)
def _kidct(device: str) -> torch.Tensor:
    return torch.from_numpy(X._KIDCT_ZZ).to(device).contiguous()


def pixels_from_blocks(layout, blocks: torch.Tensor, qts) -> torch.Tensor:
    """[..., n_total, 64] component-planar zigzag blocks + per-component
    [..., 64] natural-order quant tables -> uint8 pixels [..., h, w, 3]
    (gray: [..., h, w]), cropped (decoder.py:449-486, with leading batch
    dimensions). IDCT output samples are rounded and range-limited to
    [0, 255] per component BEFORE chroma upsampling and colour conversion:
    the T.81 reconstruction semantics of every libjpeg-family decoder."""
    offs, comps = layout.comp_offsets, layout.comps
    h, w = layout.height, layout.width
    planes = [
        torch.clamp(torch.round(X.zigzag_to_plane(
            blocks[..., offs[i]:offs[i] + c.n_blocks, :], qts[i],
            c.plane_h, c.plane_w)), 0, 255)
        for i, c in enumerate(comps)]
    if layout.is_gray:
        return planes[0][..., :h, :w].to(torch.uint8)
    c0 = comps[0]
    cb = C.upsample_fancy(planes[1], c0.hs, c0.vs)
    cr = C.upsample_fancy(planes[2], c0.hs, c0.vs)
    rgb = C.ycbcr_to_rgb(torch.stack([planes[0], cb, cr], dim=-1))
    return torch.clamp(torch.round(rgb[..., :h, :w, :]), 0, 255) \
        .to(torch.uint8)


def pixels_from_scan(x4: torch.Tensor, q_rows: torch.Tensor, layout
                     ) -> torch.Tensor:
    """The reconstruction as torch ops from the MCU-major tensor: un-permute
    scan order to component-planar blocks, take each component's quant
    table back out of q_rows (natural order), then `pixels_from_blocks`."""
    b = x4.shape[0]
    dev = x4.device
    n_total = sum(c.n_blocks for c in layout.comps)
    scan_flat = torch.from_numpy(
        np.asarray(layout.scan_flat, np.int64)).to(dev)
    blocks = torch.zeros((b, n_total, 64), dtype=torch.int16, device=dev)
    blocks[:, scan_flat] = x4.reshape(b, layout.n_scan, 64)
    nb = layout.comps[0].hs * layout.comps[0].vs
    nat = torch.from_numpy(np.argsort(np.asarray(T.ZIGZAG))).to(dev)
    qts = [q_rows[:, o * 64:(o + 1) * 64].index_select(1, nat)
           for o in [0] + list(range(nb, nb + len(layout.comps) - 1))]
    return pixels_from_blocks(layout, blocks, qts)


def recon_plain(x4: torch.Tensor, q_rows: torch.Tensor, layout
                ) -> torch.Tensor:
    """The plain version of both kernels: `pixels_from_scan`, counted."""
    global plain_calls
    plain_calls += 1
    return pixels_from_scan(x4, q_rows, layout)


def product_terms(x4: torch.Tensor, layout) -> dict:
    """How many product terms the kernels run on these coefficients, for the
    tile's own blocks (the halo left out): `nonzero_frac`, the share of
    nonzero coefficients; `terms_per_block`, the mean nonzero coefficients a
    block; `terms_per_sample`, the mean terms of a sample as the kernels run
    them: each warp walks the nibbles (4 consecutive k) that hold a nonzero
    coefficient of one of its 8 blocks (a tile's blocks in scan order, the
    last warp padded with empty slots); `fmas`, what the warps spend: terms
    x 8 slots x 64 positions, summed. All four are exact counts on x4's
    device."""
    b, my, mx, lanes = x4.shape
    nb2 = lanes // 64
    tile = GRAY_TILE if layout.is_gray else TILE
    nz = (x4 != 0).reshape(b, my, mx, nb2, 64)
    real = torch.ones((b, my, mx, nb2), dtype=torch.bool, device=x4.device)
    pad_mcu = -mx % tile
    pad_slot = -(tile * nb2) % WARP_BLOCKS

    def warps(t):
        t = torch.cat([t, t.new_zeros((b, my, pad_mcu) + t.shape[3:])], 2)
        t = t.reshape((b, my, (mx + pad_mcu) // tile, tile * nb2)
                      + t.shape[4:])
        t = torch.cat([t, t.new_zeros((b, my, t.shape[2], pad_slot)
                                      + t.shape[4:])], 3)
        return t.reshape((b, my, t.shape[2], -1, WARP_BLOCKS) + t.shape[4:])

    union = warps(nz).any(dim=-2)                       # [.., warps, 64]
    terms = 4 * union.reshape(union.shape[:-1] + (16, 4)).any(-1).sum(-1)
    blocks = warps(real).sum(dim=-1)                    # real blocks a warp
    n_blocks = b * my * mx * nb2
    return {"nonzero_frac": int(nz.sum()) / (n_blocks * 64),
            "terms_per_block": int(nz.sum()) / n_blocks,
            "terms_per_sample": int((terms * blocks).sum()) / n_blocks,
            "fmas": int(terms.sum()) * WARP_BLOCKS * 64}


def check_operands(x4: torch.Tensor, q_rows: torch.Tensor, layout) -> None:
    """Raise unless x4 and q_rows are what the kernels take for this
    layout: contiguous, 16-byte aligned, on one device, of the expected
    type and shape."""
    if not recon_applicable(layout):
        raise ValueError(
            f"no reconstruction kernel for sampling {layout.subsampling!r} "
            f"({layout.mcus_y} MCU rows): use pixels_from_scan")
    lanes = layout.blocks_per_mcu * 64
    shape = (x4.shape[0], layout.mcus_y, layout.mcus_x, lanes)
    if (x4.dtype != torch.int16 or tuple(x4.shape) != shape
            or not x4.is_contiguous()):
        raise ValueError(f"x4 must be a contiguous int16 tensor of shape "
                         f"[B, {shape[1]}, {shape[2]}, {lanes}], got "
                         f"{tuple(x4.shape)} {x4.dtype}")
    if not 1 <= x4.shape[0] <= 65535:
        raise ValueError(f"batch of {x4.shape[0]}: a launch takes 1 to "
                         f"65535 images")
    if (q_rows.device != x4.device or q_rows.dtype != torch.float32
            or tuple(q_rows.shape) != (x4.shape[0], lanes)
            or not q_rows.is_contiguous()):
        raise ValueError(f"q_rows {tuple(q_rows.shape)} {q_rows.dtype} "
                         f"{q_rows.device}: expected contiguous "
                         f"{(x4.shape[0], lanes)} float32 on {x4.device}")
    if x4.data_ptr() % 16 or q_rows.data_ptr() % 16:
        raise ValueError("x4 and q_rows must start on a 16-byte boundary "
                         "(the kernels read them 16 bytes at a time)")


def fused_recon_rgb(x4: torch.Tensor, q_rows: torch.Tensor, layout
                    ) -> torch.Tensor:
    """[B, my, mx, L] int16 + [B, L] f32 quant rows -> [B, h, w, 3] uint8
    (gray: [B, h, w]). On a CUDA tensor this launches the kernel (or
    raises); on a CPU tensor it runs the plain version."""
    global launches, launches_gray
    if x4.device.type == "cpu":
        return recon_plain(x4, q_rows, layout)
    if x4.device.type != "cuda":
        raise ValueError(f"unsupported device {x4.device}")
    check_operands(x4, q_rows, layout)
    b, h, w = x4.shape[0], layout.height, layout.width
    my, mx = layout.mcus_y, layout.mcus_x
    shape = (b, h, w) if layout.is_gray else (b, h, w, 3)
    out = torch.empty(shape, dtype=torch.uint8, device=x4.device)
    kidct = _kidct(str(x4.device))
    lib = build.library()
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream().cuda_stream
        if layout.is_gray:
            rc = lib.recon_gray_launch(x4.data_ptr(), q_rows.data_ptr(),
                                       kidct.data_ptr(), out.data_ptr(), b,
                                       my, mx, h, w, stream)
        else:
            c0 = layout.comps[0]
            rc = lib.recon_launch(x4.data_ptr(), q_rows.data_ptr(),
                                  kidct.data_ptr(), out.data_ptr(), b, my,
                                  mx, h, w, c0.hs, c0.vs, stream)
    build.check(rc, "recon")
    if layout.is_gray:
        launches_gray += 1
    else:
        launches += 1
    return out
