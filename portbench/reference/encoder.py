"""Plain NumPy baseline JPEG encoder: the benchmark's reference.

The transform is a frozen copy of the port's own numpy anchor
(`ref/encoder.py`: full-range BT.601 in float32, edge padding, box-mean chroma
subsampling, the orthonormal 8x8 DCT as `C @ X @ C.T` in float32, quantization
by round-half-away-from-zero). The entropy coder is written here over whole
arrays instead of a loop per coefficient, so that a 4K frame codes in a
fraction of a second: DC differences by the layout's predecessor slots, AC
run lengths from the positions of the nonzero coefficients, ZRL and EOB
items, every item's code and amplitude bits packed MSB first, 1-bits to the
byte boundary, 0x00 stuffed after each 0xFF and RSTn between restart
segments (T.81 F.1.2, F.1.2.3, B.2.4.4).

`matmul="tf32"` computes the DCT's two matrix products with their operands
rounded to TF32 (10 explicit mantissa bits) and float32 sums: the control,
the precision a tensor-core port of the transform would drop to.
"""
from __future__ import annotations

import numpy as np

from . import tables as T
from .huffman import HuffTable, build_codes, optimize_tables
from .jfif import build_headers
from .layout import FrameLayout, make_layout

EOI = b"\xff\xd9"


def dct_matrix(dtype=np.float32) -> np.ndarray:
    x = np.arange(8, dtype=np.float64)
    u = x[:, None]
    c = np.where(u == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    m = c * np.cos((2.0 * x[None, :] + 1.0) * u * np.pi / 16.0)
    return m.astype(dtype)


_C = dct_matrix()


def to_tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), kept
    in float32: the operand rounding of a TF32 tensor-core product."""
    i = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((i + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def round_half_away(x: np.ndarray) -> np.ndarray:
    return np.trunc(x + np.copysign(np.float32(0.5), x))


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """Full-range BT.601 (JFIF 1.02). rgb: [...,3] uint8 -> float32 [...,3]."""
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return np.stack([y, cb, cr], axis=-1)


def pad_replicate(plane: np.ndarray, ph: int, pw: int) -> np.ndarray:
    h, w = plane.shape[:2]
    return np.pad(plane, [(0, ph - h), (0, pw - w)] + [(0, 0)] * (plane.ndim - 2),
                  mode="edge")


def subsample(plane: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """Box-mean subsampling by (vs, hs)."""
    h, w = plane.shape
    p = plane.reshape(h // vs, vs, w // hs, hs)
    return p.mean(axis=(1, 3), dtype=np.float32)


def blockify(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [H//8 * W//8, 8, 8], raster block order."""
    h, w = plane.shape
    return (plane.reshape(h // 8, 8, w // 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 8, 8))


def fdct_blocks(blocks: np.ndarray, matmul: str = "float32") -> np.ndarray:
    """2-D T.81 FDCT of level-shifted float32 blocks [n, 8, 8]."""
    if matmul == "float32":
        return np.einsum("ij,njk,lk->nil", _C, blocks, _C).astype(np.float32)
    if matmul != "tf32":
        raise ValueError(f"matmul must be 'float32' or 'tf32', not {matmul!r}")
    c = to_tf32(_C)
    t = np.matmul(to_tf32(blocks), c.T)
    return np.matmul(c, to_tf32(t)).astype(np.float32)


def plane_to_zigzag(plane_f32: np.ndarray, qtable_nat: np.ndarray,
                    matmul: str = "float32") -> np.ndarray:
    """Padded float32 plane -> [n_blocks, 64] int32 quantized zigzag coefficients."""
    blocks = blockify(plane_f32) - np.float32(128.0)
    coef = fdct_blocks(blocks, matmul)
    q = round_half_away(coef / qtable_nat.reshape(8, 8).astype(np.float32))
    return q.reshape(-1, 64)[:, T.ZIGZAG].astype(np.int32)


def qtables_for(quality: int) -> list[np.ndarray]:
    return [T.scale_qtable(T.QTABLE_LUMA, quality),
            T.scale_qtable(T.QTABLE_CHROMA, quality)]


def image_to_zigzag(img: np.ndarray, layout: FrameLayout,
                    qtables: list[np.ndarray], matmul: str = "float32"
                    ) -> np.ndarray:
    """uint8 image -> concatenated [sum n_blocks, 64] zigzag blocks (raster per comp)."""
    if layout.is_gray:
        plane = pad_replicate(img.astype(np.float32),
                              layout.comps[0].plane_h, layout.comps[0].plane_w)
        return plane_to_zigzag(plane, qtables[0], matmul)
    padded = pad_replicate(img, layout.comps[0].plane_h, layout.comps[0].plane_w)
    ycc = rgb_to_ycbcr(padded)
    hs, vs = layout.comps[0].hs, layout.comps[0].vs
    planes = [
        ycc[..., 0],
        subsample(ycc[..., 1], hs, vs),
        subsample(ycc[..., 2], hs, vs),
    ]
    parts = [plane_to_zigzag(p, qtables[c.qtab], matmul)
             for p, c in zip(planes, layout.comps)]
    return np.concatenate(parts, axis=0)


# ---------------------------------------------------------------------------
# Entropy coding over whole arrays
# ---------------------------------------------------------------------------

def category(v: np.ndarray) -> np.ndarray:
    """SSSS, the bit length of |v| (T.81 Tables F.1, F.2)."""
    a = np.abs(v.astype(np.int64))
    s = np.zeros(a.shape, np.int64)
    nz = a > 0
    s[nz] = np.frexp(a[nz].astype(np.float64))[1]
    return s


class Symbols:
    """Every coded item of a scan, in scan order: its slot, kind (0 DC, 1
    AC), Huffman table id, symbol, and amplitude bits with their count."""

    def __init__(self, layout: FrameLayout, blocks: np.ndarray):
        z = np.asarray(blocks, np.int64)[layout.scan_flat]     # [n_scan, 64]
        n = z.shape[0]
        comp = layout.scan_comp
        dc_tab = np.array([c.dc_tab for c in layout.comps])[comp]
        ac_tab = np.array([c.ac_tab for c in layout.comps])[comp]
        # DC: difference to the predecessor slot (0 after a reset)
        prev = layout.prev_same
        pred = np.where(prev >= 0, z[np.maximum(prev, 0), 0], 0)
        diff = z[:, 0] - pred
        s_dc = category(diff)
        slot = [np.arange(n)]
        sub = [np.zeros(n, np.int64)]
        kind = [np.zeros(n, np.int64)]
        tab = [dc_tab]
        sym = [s_dc]
        amp = [diff]
        nbits = [s_dc]
        # AC: nonzero coefficients, with their zero runs
        jj, kk = np.nonzero(z[:, 1:])
        kk = kk + 1
        first = np.ones(jj.size, bool)
        first[1:] = jj[1:] != jj[:-1]
        prevk = np.where(first, 0, np.concatenate([[0], kk[:-1]]))
        run = kk - prevk - 1
        val = z[jj, kk]
        s_ac = category(val)
        n_zrl = run // 16
        zj = np.repeat(jj, n_zrl)
        zk = np.repeat(kk, n_zrl)
        slot += [jj, zj]
        sub += [2 * kk, 2 * zk - 1]
        kind += [np.ones(jj.size, np.int64), np.ones(zj.size, np.int64)]
        tab += [ac_tab[jj], ac_tab[zj]]
        sym += [((run % 16) << 4) | s_ac, np.full(zj.size, T.ZRL)]
        amp += [val, np.zeros(zj.size, np.int64)]
        nbits += [s_ac, np.zeros(zj.size, np.int64)]
        # EOB where the last nonzero AC coefficient is not at position 63
        last = np.zeros(n, np.int64)
        np.maximum.at(last, jj, kk)
        ej = np.flatnonzero(last < 63)
        slot.append(ej)
        sub.append(np.full(ej.size, 254))
        kind.append(np.ones(ej.size, np.int64))
        tab.append(ac_tab[ej])
        sym.append(np.full(ej.size, T.EOB))
        amp.append(np.zeros(ej.size, np.int64))
        nbits.append(np.zeros(ej.size, np.int64))
        slot = np.concatenate(slot)
        order = np.lexsort((np.concatenate(sub), slot))
        self.slot = slot[order]
        self.kind = np.concatenate(kind)[order]
        self.tab = np.concatenate(tab)[order]
        self.sym = np.concatenate(sym)[order]
        amp = np.concatenate(amp)[order]
        self.nbits = np.concatenate(nbits)[order]
        # amplitude bits: v >= 0 -> v; v < 0 -> v + 2^s - 1 (T.81 F.1.2.1)
        self.amp = np.where(amp >= 0, amp, amp + (1 << self.nbits) - 1)
        self.seg = layout.scan_seg[self.slot]

    def histogram(self) -> np.ndarray:
        """[2 kinds (dc, ac), 2 table ids, 256] symbol counts."""
        freq = np.zeros((2, 2, 256), np.int64)
        np.add.at(freq, (self.kind, self.tab, self.sym), 1)
        return freq


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """MSB-first bit packing, 1-bits to the byte boundary, 0xFF stuffing."""
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    item = np.repeat(np.arange(lengths.size), lengths)
    pos = np.arange(total) - starts[item]
    bits = np.ones(-(-total // 8) * 8, np.uint8)
    bits[:total] = (values[item] >> (lengths[item] - 1 - pos)) & 1
    out = np.packbits(bits)
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def entropy_scan(layout: FrameLayout, symbols: Symbols,
                 dc_tables: list[HuffTable], ac_tables: list[HuffTable]
                 ) -> bytes:
    """The stuffed entropy-coded segment, RSTn markers included."""
    code = np.zeros((2, 2, 256), np.int64)
    length = np.zeros((2, 2, 256), np.int64)
    for t, (dc, ac) in enumerate(zip(dc_tables, ac_tables)):
        code[0, t], length[0, t] = dc.code, dc.length
        code[1, t], length[1, t] = ac.code, ac.length
    idx = (symbols.kind, symbols.tab, symbols.sym)
    clen = length[idx]
    if (clen == 0).any():
        raise ValueError("a symbol has no code in its Huffman table")
    values = (code[idx] << symbols.nbits) | symbols.amp
    lengths = clen + symbols.nbits
    bounds = np.flatnonzero(np.diff(symbols.seg)) + 1
    out = bytearray()
    for i, (v, ln) in enumerate(zip(np.split(values, bounds),
                                    np.split(lengths, bounds))):
        if i:
            out += bytes([0xFF, 0xD0 + (i - 1) % 8])
        out += _pack(v, ln)
    return bytes(out)


def standard_tables() -> tuple[list[HuffTable], list[HuffTable]]:
    dc = [build_codes(T.DC_LUMA_BITS, T.DC_LUMA_VALS),
          build_codes(T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)]
    ac = [build_codes(T.AC_LUMA_BITS, T.AC_LUMA_VALS),
          build_codes(T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)]
    return dc, ac


def optimized_tables(layout: FrameLayout, symbols: Symbols
                     ) -> tuple[list[HuffTable], list[HuffTable]]:
    """One image's own tables from its symbol histogram (T.81 K.2)."""
    freq = symbols.histogram()
    n_tabs = 1 if layout.is_gray else 2
    dc = [build_codes(*optimize_tables(freq[0, t])) for t in range(n_tabs)]
    ac = [build_codes(*optimize_tables(freq[1, t])) for t in range(n_tabs)]
    return dc, ac


def encode_blocks(layout: FrameLayout, blocks: np.ndarray, quality: int,
                  optimize: bool) -> bytes:
    """The whole file for raster zigzag coefficients `blocks` [n, 64]: the
    headers at `quality`, the standard tables or (optimize) the ones built
    from these coefficients, the scan and EOI."""
    symbols = Symbols(layout, blocks)
    dc, ac = (optimized_tables(layout, symbols) if optimize
              else standard_tables())
    return (build_headers(layout, qtables_for(quality), dc, ac)
            + entropy_scan(layout, symbols, dc, ac) + EOI)


def layout_for(img_shape: tuple, subsampling: str, restart_interval: int
               ) -> FrameLayout:
    mode = "gray" if len(img_shape) == 2 else subsampling
    return make_layout(int(img_shape[0]), int(img_shape[1]), mode,
                       restart_interval)


def encode(img: np.ndarray, quality: int = 75, subsampling: str = "420",
           restart_interval: int = 0, optimize: bool = False,
           matmul: str = "float32") -> bytes:
    """Baseline JFIF encode of a [H,W] grayscale or [H,W,3] RGB uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("image must be uint8")
    layout = layout_for(img.shape, subsampling, restart_interval)
    blocks = image_to_zigzag(img, layout, qtables_for(quality), matmul)
    return encode_blocks(layout, blocks, quality, optimize)
