"""Kernel 2, kernel B, with the word compaction after it: per-block words
-> the compact word stream of each image (counterpart of
jpgenc_tpu/ops/pallas/seg_merge.py followed by jpgenc_tpu/ops/pack.py
wcompact_unstuffed, as jpgenc_tpu/parallel/mesh.py:216-227 composes them).

`fused_merge` launches the three kernels of `csrc/seg_merge.cu` for a CUDA
tensor, or takes the plain version `merge_plain` only for a CPU tensor:
`seg_merge_plain` (kernel B's plain version: segment rows [n_seg, W] int32
holding MSB-first u32 bit patterns, W = spb*w_blk + 2, the reference's
w_seg, or min(W, cap_words); words past a segment's ceil(bits/32) zero),
then `pack.wcompact_unstuffed`, then the overflow flag.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from jpgenc_tpu_torch.kernels import build
from jpgenc_tpu_torch.ops import pack
from jpgenc_tpu_torch.ops.cuda.block_pack import (MAX_W_BLK, _shift_into_word,
                                                  to_i32_bits)

#: calls of fused_merge that launched the CUDA kernels, and calls of the
#: plain version (seg_merge_plain)
launches = 0
plain_calls = 0


def seg_offsets(bits: torch.Tensor, n_seg: int, w_blk: int):
    """The plain version's offsets (the CUDA merge tail computes them on
    the card): bits [n_blocks] -> (w0, r [n_blocks] int32 segment-relative
    word offset and bit shift, seg_bits [n_seg] int32). Per-block lengths
    are clamped to 32*w_blk first (seg_merge.py:157), so an overflowing
    block cannot push later offsets past the buffer; outputs are discarded
    whenever a block overflowed, so the clamp never changes a valid result."""
    b2 = bits.to(torch.int64).clamp(max=32 * w_blk).reshape(n_seg, -1)
    csum = b2.cumsum(dim=1)
    off = (csum - b2).reshape(-1)
    return ((off >> 5).to(torch.int32), (off & 31).to(torch.int32),
            csum[:, -1].to(torch.int32))


def _out_words(spb: int, w_blk: int, cap_words: int | None) -> int:
    w_seg = spb * w_blk + 2
    return w_seg if cap_words is None else min(w_seg, cap_words)


def seg_merge_plain(buf: torch.Tensor, bits: torch.Tensor, n_seg: int,
                    w_blk: int, cap_words: int | None = None):
    """The plain version of kernel B: funnel shift + scatter-add of every
    block's w_blk+1 words (bit-disjoint, so add == OR)."""
    global plain_calls
    plain_calls += 1
    n_blocks = buf.shape[0]
    spb = n_blocks // n_seg
    w0, r, seg_bits = seg_offsets(bits, n_seg, w_blk)
    out_w = _out_words(spb, w_blk, cap_words)
    u = buf.to(torch.int64) & 0xFFFFFFFF
    r64 = r.to(torch.int64)[:, None]
    sh = (_shift_into_word(F.pad(u, (0, 1)), -r64) |
          _shift_into_word(F.pad(u, (1, 0)), 32 - r64))     # [n, w_blk+1]
    idx = w0.to(torch.int64)[:, None] + torch.arange(w_blk + 1,
                                                     device=buf.device)
    seg = torch.arange(n_blocks, device=buf.device)[:, None] // spb
    flat = torch.where(idx < out_w, seg * out_w + idx, n_seg * out_w)  # sink
    out = torch.zeros(n_seg * out_w + 1, dtype=torch.int64, device=buf.device)
    out.scatter_add_(0, flat.reshape(-1), sh.reshape(-1))
    return to_i32_bits(out[:-1].reshape(n_seg, out_w)), seg_bits


def merge_plain(buf: torch.Tensor, bits: torch.Tensor, n_seg: int,
                w_blk: int, cap_w: int, walign: int):
    """The plain version of the merge tail: seg_merge_plain (capped at
    cap_w words) -> pack.wcompact_unstuffed -> overflow flag. Shapes as
    fused_merge."""
    b = buf.shape[0]
    seg_words, seg_bits = seg_merge_plain(
        buf.reshape(-1, w_blk), bits.reshape(-1), b * n_seg, w_blk,
        cap_words=cap_w)
    wstream, nbits = pack.wcompact_unstuffed(
        seg_words.reshape(b, n_seg, -1), seg_bits.reshape(b, n_seg), cap_w,
        walign)
    return wstream, nbits, bits.amax(dim=1) > 32 * w_blk


def fused_merge(buf: torch.Tensor, bits: torch.Tensor, n_seg: int,
                w_blk: int, cap_w: int, walign: int):
    """buf [B, S, w_blk] int32 (u32 bit patterns) + bits [B, S] int32, S =
    n_seg times the blocks per segment (scan order, segment-major) ->
    (wstream [B, cap_w] int32, nbits [B, n_seg] int32, ovf [B] bool).

    wstream's little-endian memory image is each image's unstuffed byte
    stream, segment starts walign-word aligned (pack.seg_nwords_aligned);
    words at or past cap_w are dropped. nbits is each segment's sum of
    min(bits, 32*w_blk); ovf flags an image with a block past 32*w_blk
    bits. On a CUDA tensor this launches csrc/seg_merge.cu (or raises): its
    words equal merge_plain's within each image's aligned prefix,
    seg_nwords_aligned(nbits, walign).sum(), and are left unwritten past
    it. On a CPU tensor it runs merge_plain."""
    global launches
    b = buf.shape[0]
    if buf.dim() != 3 or buf.shape[2] != w_blk or \
            bits.shape != buf.shape[:2] or buf.shape[1] % n_seg:
        raise ValueError(f"buf {tuple(buf.shape)} / bits {tuple(bits.shape)} "
                         f"do not make {n_seg} segments of w_blk={w_blk}")
    if cap_w < 1 or walign < 1 or walign & (walign - 1):
        raise ValueError(f"cap_w={cap_w} must be positive and walign="
                         f"{walign} a power of two")
    if buf.device.type == "cpu":
        return merge_plain(buf, bits, n_seg, w_blk, cap_w, walign)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if not 1 <= w_blk <= MAX_W_BLK:
        raise ValueError(f"w_blk must be in [1, {MAX_W_BLK}], got {w_blk}")
    for t in (buf, bits):
        if t.dtype != torch.int32 or not t.is_contiguous() or \
                t.device != buf.device:
            raise ValueError("buf and bits must be contiguous int32 tensors "
                             "on one device")
    spb = buf.shape[1] // n_seg
    lib = build.library()
    dev = buf.device
    scratch = torch.empty(lib.seg_merge_scratch(b, n_seg, spb),
                          dtype=torch.int64, device=dev)
    wstream = torch.empty((b, cap_w), dtype=torch.int32, device=dev)
    nbits = torch.empty((b, n_seg), dtype=torch.int32, device=dev)
    ovf = torch.empty(b, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.seg_merge_launch(buf.data_ptr(), bits.data_ptr(), b, n_seg,
                                  spb, w_blk, cap_w, walign,
                                  scratch.data_ptr(), wstream.data_ptr(),
                                  nbits.data_ptr(), ovf.data_ptr(), stream)
    build.check(rc, "seg_merge")
    launches += 1
    return wstream, nbits, ovf
