"""Kernel A: scan-ordered zigzag blocks -> per-block Huffman-packed words
(counterpart of jpgenc_tpu/ops/pallas/block_pack.py).

`fused_block_pack` launches the CUDA kernel in `csrc/block_pack.cu` for a
CUDA tensor and takes the plain version `pack_blocks_plain` only for a CPU
tensor. `slot_metadata` is the torch prologue (the previous same-component
DC is a gather, XLA in the reference too). The plain version is the
PyTorch form of `_ssss`, `_ac_analysis`, `_dc_piece` and `_pack_slots`
(block_pack.py:37-229); the K1A kernels' entropy halves are checked bit for
bit against it as well.

Huffman tables come as `packed_tables` makes them, either one set shared by
every image (ac_rows [4, 128], dc_rows [2, 128], misc [4]) or one set per
image with a leading batch dimension (optimized tables; the reference vmaps
the kernel over a batch of LUTs, parallel/mesh.py:293-296).

All arithmetic runs in int64 holding u32 values, so no shift or sum here
depends on signed overflow; packed words leave as int32 tensors that hold
the u32 bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from jpgenc_tpu_torch.kernels import build

_M32 = 0xFFFFFFFF

#: launches of the CUDA kernel, and calls of the plain version
launches = 0
plain_calls = 0

#: widest per-block word tier the kernel takes (covers MAX_BLOCK_BITS)
MAX_W_BLK = 56


def packed_tables(luts) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Huffman LUTs (.dc/.ac [..., 2, 256] packed (code << 5) | len) ->
    (ac_rows [..., 4, 128], dc_rows [..., 2, 128], misc [..., 4]) int32 CPU
    tensors (block_pack.py:37-51; misc is [zrl_tab0, zrl_tab1, eob_tab0,
    eob_tab1]). A leading dimension is one table set per image."""
    ac = np.asarray(luts.ac, np.int32)
    dc = np.asarray(luts.dc, np.int32)
    lead = ac.shape[:-2]
    ac_rows = ac.reshape(*lead, 4, 128)
    dc_rows = np.pad(dc[..., :16], [(0, 0)] * (len(lead) + 1) + [(0, 112)])
    misc = np.stack([ac[..., 0, 0xF0], ac[..., 1, 0xF0], ac[..., 0, 0],
                     ac[..., 1, 0]], axis=-1).astype(np.int32)
    return (torch.from_numpy(ac_rows.copy()), torch.from_numpy(dc_rows),
            torch.from_numpy(misc))


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bit pattern."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _lane_shift_right(x: torch.Tensor, n: int) -> torch.Tensor:
    """Shift values toward higher index along dim 1 by n (zero fill)."""
    if n == 0:
        return x
    return torch.nn.functional.pad(x, (n, 0))[:, :-n]


def _ssss(v: torch.Tensor) -> torch.Tensor:
    """Bit length of |v| via the f32 exponent (exact for |v| < 2^24)."""
    av = v.abs()
    e = (av.to(torch.float32).view(torch.int32).to(torch.int64) >> 23) & 0xFF
    return torch.where(av == 0, 0, e - 126)


def _shift_into_word(v: torch.Tensor, s) -> torch.Tensor:
    """u32 v shifted by s bits (+ = left), truncated to a u32 word; |s| >= 32
    yields 0 (pack.py:42-53)."""
    s = torch.as_tensor(s, device=v.device)
    sl = s.clamp(0, 31)
    sr = (-s).clamp(0, 31)
    left = torch.where((s >= 0) & (s < 32), (v << sl) & _M32, 0)
    right = torch.where((s < 0) & (s > -32), v >> sr, 0)
    return left | right


def _ac_analysis(v: torch.Tensor):
    """Zigzag rows [t, 64] int64 -> (pos, nz, run, s_ac, amp_ac, sym):
    T.81 F.1.2.2 run lengths by a running max of nonzero positions, plus
    SSSS and amplitude per AC lane (block_pack.py:78-97)."""
    t = v.shape[0]
    pos = torch.arange(64, device=v.device).expand(t, 64)
    nz = (v != 0) & (pos > 0)
    incl = torch.where(nz, pos, 0)
    for sh in (1, 2, 4, 8, 16, 32):
        incl = torch.maximum(incl, _lane_shift_right(incl, sh))
    prev_nz = _lane_shift_right(incl, 1)
    run = pos - prev_nz - 1
    s_ac = _ssss(v)
    amp_ac = torch.where(v >= 0, v, v + (1 << s_ac) - 1) & ((1 << s_ac) - 1)
    sym = ((run & 15) << 4) | s_ac
    return pos, nz, run, s_ac, amp_ac, sym


def _dc_piece(dcdiff: torch.Tensor):
    """DC diff [t, 1] int64 -> (s_dc, amp_dc)."""
    s_dc = _ssss(dcdiff)
    amp_dc = torch.where(dcdiff >= 0, dcdiff,
                         dcdiff + (1 << s_dc) - 1) & ((1 << s_dc) - 1)
    return s_dc, amp_dc


def _pack_slots(pos, nz, run, s_ac, amp_ac, e_ac, s_dc, amp_dc, e_dc,
                zrl, eob, valid, w_blk: int):
    """Per-slot pieces -> (packed words [t, w_blk] int64 u32 values, total
    bits [t]) (block_pack.py:152-229). valid [t, 1] bool masks whole slots
    to zero length (segment padding). Each lane's <=3 ZRL pieces and main
    piece go MSB-first into a 96-bit register, the in-block exclusive prefix
    gives bit offsets, and the funnel-shifted registers are summed into their
    words (bit-disjoint, so sum == OR). Words at or past w_blk are dropped;
    the total stays true, so callers detect overflow as bits > 32 * w_blk."""
    t = pos.shape[0]
    main_val = _shift_into_word(e_ac >> 5, s_ac) | amp_ac
    main_len = torch.where(nz & valid, (e_ac & 31) + s_ac, 0)

    at63 = pos == 63
    eob_here = at63 & ~nz[:, 63:64]
    main_val = torch.where(eob_here, eob >> 5, main_val)
    main_len = torch.where(eob_here & valid, eob & 31, main_len)

    at0 = pos == 0
    dc_val = _shift_into_word(e_dc >> 5, s_dc) | amp_dc
    dc_len = torch.where(valid, (e_dc & 31) + s_dc, 0)
    main_val = torch.where(at0, dc_val, main_val)
    main_len = torch.where(at0, dc_len, main_len)

    n_zrl = torch.where(nz & valid, run >> 4, 0)
    reg = [torch.zeros_like(main_val) for _ in range(3)]
    p_off = torch.zeros_like(main_len)
    for p in range(4):
        if p < 3:
            on = n_zrl > p
            pv = torch.where(on, zrl >> 5, 0)
            plen = torch.where(on, zrl & 31, 0)
        else:
            pv, plen = main_val, main_len
        a = 96 - p_off - plen
        for w in range(3):
            reg[w] = reg[w] | _shift_into_word(pv, a - 64 + 32 * w)
        p_off = p_off + plen
    slen = p_off

    csum = slen.cumsum(dim=1)
    off = csum - slen
    total = csum[:, 63]
    d = off >> 5
    r = off & 31

    zero = torch.zeros_like(reg[0])
    buf = torch.zeros((t, w_blk + 1), dtype=torch.int64, device=pos.device)
    for j in range(4):
        lo = reg[j] if j <= 2 else zero
        hi = reg[j - 1] if j >= 1 else zero
        w4 = _shift_into_word(lo, -r) | _shift_into_word(hi, 32 - r)
        buf.scatter_add_(1, (d + j).clamp(max=w_blk), w4)   # col w_blk: sink
    return buf[:, :w_blk], total


def pack_blocks_plain(zz: torch.Tensor, dcdiff: torch.Tensor,
                      tab: torch.Tensor, tables, w_blk: int,
                      dctab: torch.Tensor | None = None,
                      valid: torch.Tensor | None = None,
                      img: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan-ordered zigzag blocks -> per-block packed words: the plain form
    of kernel A.

    zz [S, 64], dcdiff [S] and tab [S] (the AC table id, 0 luma, 1 chroma;
    also the DC table id unless dctab [S] is given) are integer tensors;
    valid [S] (default all ones) zeroes padding slots; tables is
    packed_tables(luts) on zz's device, shared or, with img [S] naming each
    slot's image, one set per image. Returns (buf [S, w_blk] int32 u32 bit
    patterns, bits [S] int32)."""
    ac_rows, dc_rows, misc = (x.to(torch.int64) for x in tables)
    v = zz.to(torch.int64)
    tab = tab.to(torch.int64).reshape(-1, 1)
    dct = tab if dctab is None else dctab.to(torch.int64).reshape(-1, 1)
    base = torch.zeros_like(tab) if img is None else \
        2 * img.to(torch.int64).reshape(-1, 1)
    ok = torch.ones_like(tab, dtype=torch.bool) if valid is None else \
        (valid != 0).reshape(-1, 1)
    pos, nz, run, s_ac, amp_ac, sym = _ac_analysis(v)
    e_ac = ac_rows.reshape(-1)[(base + tab) * 256 + sym]
    s_dc, amp_dc = _dc_piece(dcdiff.to(torch.int64).reshape(-1, 1))
    e_dc = dc_rows.reshape(-1)[(base + dct) * 128 + s_dc]
    zrl = misc.reshape(-1)[2 * base + tab]
    eob = misc.reshape(-1)[2 * base + 2 + tab]
    buf, total = _pack_slots(pos, nz, run, s_ac, amp_ac, e_ac, s_dc, amp_dc,
                             e_dc, zrl, eob, ok, w_blk)
    return to_i32_bits(buf), total.to(torch.int32)


def slot_metadata(prev_same: torch.Tensor, zz: torch.Tensor) -> torch.Tensor:
    """The torch prologue of kernel A (block_pack.py:282-289): zz
    [B, n_slots, 64] and the layout's prev_same [n_slots] (DC predecessor
    slot, -1 at a predictor reset) -> DC differences [B, n_slots] int32."""
    dc = zz[..., 0].to(torch.int32)
    prev = dc[:, prev_same.clamp(min=0)]
    return dc - torch.where(prev_same >= 0, prev, 0)


def fused_block_pack(zz: torch.Tensor, dcdiff: torch.Tensor,
                     actab: torch.Tensor, dctab: torch.Tensor,
                     valid: torch.Tensor, tables, w_blk: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """zz [B, n_slots, 64] int16 (+ per-slot metadata) -> (buf
    [B, n_slots, w_blk] int32 u32 bit patterns, bits [B, n_slots] int32).

    dcdiff [B, n_slots] int32 is slot_metadata's; actab, dctab, valid
    [n_slots] int32 are the layout's symbol plan, the same for every image;
    tables is packed_tables(luts), shared ([4, 128], [2, 128], [4]) or per
    image ([B, 4, 128], [B, 2, 128], [B, 4]). A block over 32*w_blk bits
    keeps its first w_blk words and its true bit count. On a CUDA tensor
    this launches kernel A (or raises); on a CPU tensor it runs the plain
    version."""
    global launches, plain_calls
    b, n_slots = zz.shape[0], zz.shape[1]
    ac_rows, dc_rows, misc = tables
    n_tables = 1 if ac_rows.dim() == 2 else ac_rows.shape[0]
    if zz.shape != (b, n_slots, 64) or dcdiff.shape != (b, n_slots) or \
            any(x.shape != (n_slots,) for x in (actab, dctab, valid)):
        raise ValueError(f"zz {tuple(zz.shape)}, dcdiff {tuple(dcdiff.shape)}"
                         " and the slot plan do not agree")
    if n_tables not in (1, b):
        raise ValueError(f"{n_tables} table sets for a batch of {b}")
    if zz.device.type == "cpu":
        plain_calls += 1
        img = None if n_tables == 1 else \
            torch.arange(b).repeat_interleave(n_slots)
        buf, bits = pack_blocks_plain(
            zz.reshape(-1, 64), dcdiff.reshape(-1), actab.repeat(b), tables,
            w_blk, dctab=dctab.repeat(b), valid=valid.repeat(b), img=img)
        return buf.reshape(b, n_slots, w_blk), bits.reshape(b, n_slots)
    if zz.device.type != "cuda":
        raise ValueError(f"unsupported device {zz.device}")
    if not 1 <= w_blk <= MAX_W_BLK:
        raise ValueError(f"w_blk must be in [1, {MAX_W_BLK}], got {w_blk}")
    lead = () if ac_rows.dim() == 2 else (b,)
    args = [(zz, torch.int16, (b, n_slots, 64)),
            (dcdiff, torch.int32, (b, n_slots)),
            (actab, torch.int32, (n_slots,)), (dctab, torch.int32, (n_slots,)),
            (valid, torch.int32, (n_slots,)),
            (ac_rows, torch.int32, lead + (4, 128)),
            (dc_rows, torch.int32, lead + (2, 128)),
            (misc, torch.int32, lead + (4,))]
    for t, dt, shape in args:
        if (t.device != zz.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} {t.device}: "
                             f"expected contiguous {shape} {dt} on "
                             f"{zz.device}")
    if zz.data_ptr() % 16:
        raise ValueError("zz must be 16-byte aligned (the kernel reads it "
                         "16 bytes a lane)")
    buf = torch.empty((b, n_slots, w_blk), dtype=torch.int32,
                      device=zz.device)
    bits = torch.empty((b, n_slots), dtype=torch.int32, device=zz.device)
    lib = build.library()
    with torch.cuda.device(zz.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.block_pack_launch(
            zz.data_ptr(), dcdiff.data_ptr(), actab.data_ptr(),
            dctab.data_ptr(), valid.data_ptr(), b, n_slots,
            ac_rows.data_ptr(), dc_rows.data_ptr(), misc.data_ptr(),
            n_tables, w_blk, buf.data_ptr(), bits.data_ptr(), stream)
    build.check(rc, "block_pack")
    launches += 1
    return buf, bits
