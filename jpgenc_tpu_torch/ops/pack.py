"""Bitstream capacities and the word compaction
(counterpart of jpgenc_tpu/ops/pack.py).

Everything here except `wcompact_unstuffed` is integer host arithmetic
copied from the reference; tests/test_torch_host.py pins each copy equal to
its original. `wcompact_unstuffed` is XLA ops in the reference and torch ops
here, batched over the leading image dimension: the plain version of the
merge tail's compaction (`ops/cuda/seg_merge.merge_plain`); on the card
`csrc/seg_merge.cu` writes the compact stream itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Worst-case bits per 8x8 block: DC (16-bit code + 11 amp) + 63 AC values
# (16-bit code + 10 amp) + at most 3 ZRLs (16 bits each).
MAX_BLOCK_BITS = 27 + 63 * 26 + 3 * 16


def words_per_segment(blocks_per_segment: int) -> int:
    """Worst-case u32 words for one restart segment (+3 slack)."""
    return -(-blocks_per_segment * MAX_BLOCK_BITS // 32) + 3


def w_blk_for_quality(quality: int) -> int:
    """First-tier per-block word capacity (pack.py:80-108). The tiers never
    change file bytes: a block that overflows escalates through the ladder
    (tight -> max(w, 24) -> 56 words, which covers MAX_BLOCK_BITS)."""
    if quality <= 80:
        return 8
    if quality <= 90:
        return 12
    if quality <= 95:
        return 16
    return 24


def walign_for(blocks_per_segment: int) -> int:
    """Per-layout wcompact chunk width in words (pack.py:162-182): segment
    starts in the compact stream are aligned to it. A pure function of the
    layout, so every consumer of the stream derives the same value."""
    if blocks_per_segment >= 256:
        return 64
    if blocks_per_segment >= 64:
        return 32
    if blocks_per_segment >= 16:
        return 16
    return 8


def seg_nwords_aligned(nbits, walign: int):
    """Words a segment occupies in the wcompact stream: ceil(bits/32)
    rounded up to the walign chunk (numpy arrays, tensors and ints)."""
    nw = (nbits + 31) >> 5
    return (nw + (walign - 1)) & -walign


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00) |
            ((x & 0xFF00) << 8) | (x << 24))


def wcompact_unstuffed(seg_words: torch.Tensor, seg_bits: torch.Tensor,
                       cap_w: int, walign: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Segments -> one compact word stream whose little-endian memory image
    is the unstuffed byte stream (pack.py:195-266), for a batch of images.

    seg_words: [B, n_seg, W] int32 holding MSB-first u32 bit patterns;
    seg_bits: [B, n_seg]. Returns (wstream [B, cap_w] int32, nbits
    [B, n_seg] int32). One segment: a byte swap of a word prefix. Several
    (restart intervals): segment starts are walign-word aligned in the
    stream (seg_nwords_aligned; the host finalize uses the same offsets), so
    the compaction gathers whole chunk rows of walign words: mark the
    chunks where segments start, a prefix count maps every chunk to its
    segment (a duplicate start, from an empty segment, resolves to the last
    one: it owns the chunk), gather the chunk rows, zero the words past the
    segment's content, byte swap. The output is valid only when the aligned
    words fit cap_w; the caller checks on the host and retries a bigger
    tier otherwise."""
    b, n_seg, w = seg_words.shape
    nbits = seg_bits.to(torch.int32)
    if n_seg == 1:
        k = min(cap_w, w)
        out = _bswap32(seg_words[:, 0, :k])
        if k < cap_w:
            out = F.pad(out, (0, cap_w - k))
        return out, nbits

    dev = seg_words.device
    wshift = walign.bit_length() - 1
    nb64 = nbits.to(torch.int64)
    nw = (nb64 + 31) >> 5                              # content words
    nwa = seg_nwords_aligned(nb64, walign)
    wbase = nwa.cumsum(dim=1) - nwa                    # aligned starts
    cap_c = -(-cap_w // walign)

    # chunk -> segment map; starts past the capacity land in a sink column
    marks = torch.zeros((b, cap_c + 1), dtype=torch.int64, device=dev)
    marks.scatter_add_(1, (wbase >> wshift).clamp(max=cap_c),
                       torch.ones_like(wbase))
    s = (marks[:, :cap_c].cumsum(dim=1) - 1).clamp(0, n_seg - 1)  # [B, cap_c]

    # source rows: segment words padded to whole chunks, [B, rows, walign]
    w8 = -(-w // walign)
    rows = F.pad(seg_words, (0, w8 * walign - w)).reshape(b, n_seg * w8,
                                                          walign)
    q8 = torch.arange(cap_c, device=dev) - (wbase.gather(1, s) >> wshift)
    idx = s * w8 + q8.clamp(0, w8 - 1)                 # [B, cap_c]
    chunk = rows.gather(1, idx[:, :, None].expand(b, cap_c, walign))

    off = q8[:, :, None] * walign + torch.arange(walign, device=dev)
    out = torch.where(off < nw.gather(1, s)[:, :, None], _bswap32(chunk), 0)
    return out.reshape(b, -1)[:, :cap_w].contiguous(), nbits
