"""Plain baseline JPEG decoder: the benchmark's reference, and the reader
that turns a program's file back into its coefficients for the judge.

- `parse`: the markers of a baseline sequential file (SOI, APPn, COM, DQT,
  SOF0, DHT, DRI, SOS ... EOI); anything else is refused.
- `decode_coefficients`: Huffman decoding of every restart segment in
  Python, one symbol per 16-bit table lookup, with strict end checks: a
  segment must end within its last byte on 1-bit padding, and the scan
  must hold exactly the MCUs the frame declares.
- `reconstruct`: the port's numpy anchor (`ref/decoder.reconstruct_ref`:
  dequantize, IDCT, round and clamp each sample, centred triangle chroma
  upsampling, full-range BT.601, round and clamp) computed in float32, the
  precision the float DCT states, where the anchor uses float64. float64
  rounds samples that float32 puts exactly on .5 (flat blocks, where the
  float32 IDCT weight 0.12499999 times a DC level lands on a half) the
  other way, so it sits 0.27 % of the pixels from any float32 decoder.
  `matmul="tf32"` rounds the IDCT product's operands to TF32: the control.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from . import tables as T
from .encoder import dct_matrix, to_tf32
from .huffman import HuffTable, build_codes
from .layout import FrameLayout, make_layout

_SAMPLING = {(2, 2): "420", (2, 1): "422", (1, 1): "444"}


class DecodeError(ValueError):
    """The bytes are not a baseline file this decoder reads."""


@dataclass
class Parsed:
    qtables: dict = field(default_factory=dict)    # Tq -> [64] natural order
    dc: dict = field(default_factory=dict)         # Th -> HuffTable
    ac: dict = field(default_factory=dict)
    height: int = 0
    width: int = 0
    comps: list = field(default_factory=list)      # (id, h, v, tq)
    scan_tables: list = field(default_factory=list)  # (td, ta) per comp
    restart_interval: int = 0
    scan: bytes = b""
    header_len: int = 0


def parse(data: bytes) -> Parsed:
    if data[:2] != b"\xff\xd8":
        raise DecodeError("no SOI")
    if data[-2:] != b"\xff\xd9":
        raise DecodeError("no EOI at the end")
    p, pos = Parsed(), 2
    while True:
        if pos + 4 > len(data) or data[pos] != 0xFF:
            raise DecodeError(f"no marker at byte {pos}")
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    raise DecodeError("16-bit quantization table")
                zz = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int32)
                nat = np.zeros(64, np.int32)
                nat[T.ZIGZAG] = zz
                p.qtables[tq] = nat
                i += 65
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = np.frombuffer(seg[i + 1:i + 17], np.uint8).astype(np.int32)
                n = int(bits.sum())
                vals = np.frombuffer(seg[i + 17:i + 17 + n], np.uint8).astype(np.int32)
                (p.ac if tc else p.dc)[th] = build_codes(bits, vals)
                i += 17 + n
        elif marker == 0xC0:
            prec, p.height, p.width, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise DecodeError("precision is not 8 bits")
            p.comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                        seg[7 + 3 * c] & 15, seg[8 + 3 * c]) for c in range(nf)]
        elif marker == 0xDD:
            (p.restart_interval,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:
            ns = seg[0]
            p.scan_tables = [(seg[2 + 2 * c] >> 4, seg[2 + 2 * c] & 15)
                             for c in range(ns)]
            if ns != len(p.comps) or tuple(seg[1 + 2 * ns:4 + 2 * ns]) != (0, 63, 0):
                raise DecodeError("not one interleaved baseline scan")
            p.header_len = pos
            p.scan = data[pos:-2]
            return p
        elif 0xE0 <= marker <= 0xEF or marker == 0xFE:
            pass
        else:
            raise DecodeError(f"marker 0xFF{marker:02X} is not baseline")


def layout_of(p: Parsed) -> FrameLayout:
    if len(p.comps) == 1:
        mode = "gray"
    else:
        h, v = p.comps[0][1], p.comps[0][2]
        if len(p.comps) != 3 or any(c[1:3] != (1, 1) for c in p.comps[1:]) \
                or (h, v) not in _SAMPLING:
            raise DecodeError(f"sampling {p.comps} is not one this encoder writes")
        mode = _SAMPLING[(h, v)]
    return make_layout(p.height, p.width, mode, p.restart_interval)


def _lut(t: HuffTable) -> list[int]:
    """16-bit lookahead -> (code length << 8) | symbol; 0 for no code."""
    lut = np.zeros(1 << 16, np.int64)
    for sym in range(256):
        n = int(t.length[sym])
        if n:
            c = int(t.code[sym]) << (16 - n)
            lut[c:c + (1 << (16 - n))] = (n << 8) | sym
    return lut.tolist()


def _segments(scan: bytes) -> list[bytes]:
    """Split at RSTn markers and remove the 0x00 stuffed after each 0xFF."""
    a = np.frombuffer(scan, np.uint8)
    ff = np.flatnonzero(a[:-1] == 0xFF)
    nxt = a[ff + 1]
    if ((nxt != 0) & ((nxt < 0xD0) | (nxt > 0xD7))).any() or \
            (a.size and a[-1] == 0xFF):
        raise DecodeError("a marker inside the scan")
    rst = ff[nxt != 0]
    segs, start = [], 0
    for r in list(rst) + [a.size]:
        s = a[start:r]
        stuffed = np.flatnonzero(s[:-1] == 0xFF) + 1
        segs.append(np.delete(s, stuffed).tobytes())
        start = r + 2
    return segs


def decode_coefficients(p: Parsed, layout: FrameLayout) -> np.ndarray:
    """[n_total, 64] raster zigzag coefficients of the file's scan."""
    dcl = [_lut(p.dc[td]) for td, _ in p.scan_tables]
    acl = [_lut(p.ac[ta]) for _, ta in p.scan_tables]
    segs = _segments(p.scan)
    per_seg = layout.blocks_per_segment
    n_scan = layout.n_scan
    if len(segs) != -(-n_scan // per_seg):
        raise DecodeError(f"{len(segs)} restart segments, the frame has "
                          f"{-(-n_scan // per_seg)}")
    comp = layout.scan_comp.tolist()
    idx: list[int] = []
    val: list[int] = []
    for si, seg in enumerate(segs):
        b = np.frombuffer(seg + b"\x00" * 4, np.uint8).astype(np.int64)
        w = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
        pos, end = 0, 8 * len(seg)
        pred = [0] * len(layout.comps)
        for j in range(si * per_seg, min(n_scan, (si + 1) * per_seg)):
            c = comp[j]
            e = dcl[c][(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                raise DecodeError(f"no DC code at bit {pos}, slot {j}")
            pos += e >> 8
            s = e & 0xFF
            if s:
                v = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pred[c] += v
            base = j * 64
            idx.append(base)
            val.append(pred[c])
            lut, k = acl[c], 1
            while k < 64:
                e = lut[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise DecodeError(f"no AC code at bit {pos}, slot {j}")
                pos += e >> 8
                rs = e & 0xFF
                s = rs & 15
                if not s:
                    if rs != 0xF0:
                        break                       # EOB
                    k += 16
                    continue
                k += rs >> 4
                if k > 63:
                    raise DecodeError(f"coefficient past 63, slot {j}")
                v = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                idx.append(base + k)
                val.append(v)
                k += 1
            if pos > end:
                raise DecodeError(f"segment {si} read past its end")
        pad = end - pos
        if pad > 7 or (pad and (w[pos >> 3] >> (32 - (pos & 7) - pad))
                       & ((1 << pad) - 1) != (1 << pad) - 1):
            raise DecodeError(f"segment {si}: {pad} bits after its last "
                              "block, not 1-bit padding")
    z = np.zeros(n_scan * 64, np.int32)
    z[np.asarray(idx, np.int64)] = val
    out = np.empty((n_scan, 64), np.int32)
    out[layout.scan_flat] = z.reshape(n_scan, 64)
    return out


# ---------------------------------------------------------------------------
# Reconstruction (the port's numpy anchor, in float32)
# ---------------------------------------------------------------------------

_C = np.asarray(dct_matrix(np.float32))
_KIDCT_ZZ = np.kron(_C, _C)[np.asarray(T.ZIGZAG), :].astype(np.float32)


def upsample_fancy_ref(a: np.ndarray, axis: int) -> np.ndarray:
    """2x centered 3:1 triangle upsample along `axis`, edges replicated."""
    idx = np.arange(a.shape[axis])
    prev = np.maximum(idx - 1, 0)
    nxt = np.minimum(idx + 1, a.shape[axis] - 1)
    t = np.take(a, idx, axis)
    even = 0.75 * t + 0.25 * np.take(a, prev, axis)
    odd = 0.75 * t + 0.25 * np.take(a, nxt, axis)
    out = np.stack([even, odd], axis=axis + 1)
    shp = list(a.shape)
    shp[axis] *= 2
    return out.reshape(shp)


def _upsample_axis_ref(a: np.ndarray, f: int, axis: int) -> np.ndarray:
    if f == 1:
        return a
    if f == 2:
        return upsample_fancy_ref(a, axis)
    return np.repeat(a, f, axis=axis)


def reconstruct(layout: FrameLayout, blocks: np.ndarray, qts: list,
                matmul: str = "float32") -> np.ndarray:
    """[n_total, 64] zigzag coefficient blocks + per-component natural
    quant tables -> uint8 pixels (cropped), in float32."""
    if matmul not in ("float32", "tf32"):
        raise ValueError(f"matmul must be 'float32' or 'tf32', not {matmul!r}")
    ft = np.float32
    zz = np.asarray(T.ZIGZAG)
    offs = layout.comp_offsets
    planes = []
    for i, c in enumerate(layout.comps):
        q = np.asarray(qts[i]).reshape(64).astype(ft)
        bl = np.asarray(blocks[offs[i]:offs[i] + c.n_blocks], ft) * q[zz]
        if matmul == "float32":
            px = bl @ _KIDCT_ZZ
        else:
            px = np.matmul(to_tf32(bl), to_tf32(_KIDCT_ZZ))
        px = px + ft(128.0)
        bw = c.plane_w // 8
        plane = px.reshape(c.plane_h // 8, bw, 8, 8) \
            .transpose(0, 2, 1, 3).reshape(c.plane_h, c.plane_w)
        planes.append(np.clip(np.round(plane), 0, 255).astype(ft))
    h, w = layout.height, layout.width
    if layout.is_gray:
        return planes[0][:h, :w].astype(np.uint8)
    c0 = layout.comps[0]
    cb, cr = planes[1], planes[2]
    cb = _upsample_axis_ref(_upsample_axis_ref(cb, c0.vs, 0), c0.hs, 1)
    cr = _upsample_axis_ref(_upsample_axis_ref(cr, c0.vs, 0), c0.hs, 1)
    y = planes[0]
    r = y + ft(1.402) * (cr - ft(128.0))
    g = y - ft(0.344136286) * (cb - ft(128.0)) - ft(0.714136286) * (cr - ft(128.0))
    b = y + ft(1.772) * (cb - ft(128.0))
    rgb = np.stack([r, g, b], axis=-1)[:h, :w]
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def decode(data: bytes, matmul: str = "float32") -> np.ndarray:
    """JPEG bytes -> uint8 pixels."""
    p = parse(data)
    layout = layout_of(p)
    blocks = decode_coefficients(p, layout)
    qts = [p.qtables[c[3]] for c in p.comps]
    return reconstruct(layout, blocks, qts, matmul)
