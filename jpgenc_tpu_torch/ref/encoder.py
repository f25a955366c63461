"""NumPy reference JPEG encoder (SURVEY.md milestone M0).

This is the spec-correctness anchor: a straightforward, loop-level
implementation of the full baseline pipeline (T.81 sections A/F, Annex K) that
every device stage is diffed against. It is intentionally simple, not fast.
Copy of jpgenc_tpu/ref/encoder.py: the oracle chip_smoke.py uses on the GPU's
machine, where the JAX package is not installed.

Numerics contract shared with the device path (frozen for determinism,
SURVEY.md section 8 item 3):
  - color convert + subsample + DCT in float32
  - quantize = round-half-away-from-zero of coef / q
"""
from __future__ import annotations

import numpy as np

from jpgenc_tpu_torch import tables as T
from jpgenc_tpu_torch.config import EncodeConfig
from jpgenc_tpu_torch.container.jfif import build_headers
from jpgenc_tpu_torch.huffman import HuffTable, build_codes, optimize_tables
from jpgenc_tpu_torch.layout import FrameLayout, make_layout
from jpgenc_tpu_torch.ref.bitio import BitWriter

# --- DCT-II orthonormal matrix; C @ X @ C.T realizes the T.81 A.3.3 FDCT
# (1/4 Cu Cv double sum) because the orthonormal 1-D scale factors
# sqrt(1/8)/sqrt(2/8) multiply out to exactly 1/4 CuCv in 2-D.
def dct_matrix(dtype=np.float32) -> np.ndarray:
    x = np.arange(8, dtype=np.float64)
    u = x[:, None]
    c = np.where(u == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    m = c * np.cos((2.0 * x[None, :] + 1.0) * u * np.pi / 16.0)
    return m.astype(dtype)


_C = dct_matrix()


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
    """Box-mean subsampling by (vs, hs) — our frozen design choice for 4:2:0/4:2:2."""
    h, w = plane.shape
    p = plane.reshape(h // vs, vs, w // hs, hs)
    return p.mean(axis=(1, 3), dtype=np.float32)


def blockify(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [H//8 * W//8, 8, 8], raster block order."""
    h, w = plane.shape
    return (plane.reshape(h // 8, 8, w // 8, 8)
            .transpose(0, 2, 1, 3)
            .reshape(-1, 8, 8))


def fdct_blocks(blocks: np.ndarray) -> np.ndarray:
    """2-D T.81 FDCT of level-shifted float32 blocks [n, 8, 8]."""
    return np.einsum("ij,njk,lk->nil", _C, blocks, _C).astype(np.float32)


def plane_to_zigzag(plane_f32: np.ndarray, qtable_nat: np.ndarray) -> np.ndarray:
    """Padded float32 plane -> [n_blocks, 64] int32 quantized zigzag coefficients."""
    blocks = blockify(plane_f32) - np.float32(128.0)
    coef = fdct_blocks(blocks)
    q = round_half_away(coef / qtable_nat.reshape(8, 8).astype(np.float32))
    return q.reshape(-1, 64)[:, T.ZIGZAG].astype(np.int32)


def image_to_zigzag(img: np.ndarray, layout: FrameLayout,
                    qtables: list[np.ndarray]) -> np.ndarray:
    """uint8 image -> concatenated [sum n_blocks, 64] zigzag blocks (raster per comp)."""
    if layout.is_gray:
        plane = pad_replicate(img.astype(np.float32),
                              layout.comps[0].plane_h, layout.comps[0].plane_w)
        return plane_to_zigzag(plane, qtables[0])
    padded = pad_replicate(img, layout.comps[0].plane_h, layout.comps[0].plane_w)
    ycc = rgb_to_ycbcr(padded)
    hs, vs = layout.comps[0].hs, layout.comps[0].vs
    planes = [
        ycc[..., 0],
        subsample(ycc[..., 1], hs, vs),
        subsample(ycc[..., 2], hs, vs),
    ]
    parts = [plane_to_zigzag(p, qtables[c.qtab])
             for p, c in zip(planes, layout.comps)]
    return np.concatenate(parts, axis=0)


def _ssss(v: int) -> int:
    return int(abs(v)).bit_length()


def entropy_scan(layout: FrameLayout, all_blocks: np.ndarray,
                 dc_tables: list[HuffTable], ac_tables: list[HuffTable]) -> bytes:
    """Scan-order Huffman encode -> stuffed entropy bytes incl. RSTn markers."""
    out = bytearray()
    w = BitWriter()
    dc_pred = [0] * len(layout.comps)
    cur_seg = 0
    for j in range(layout.n_scan):
        seg = int(layout.scan_seg[j])
        if seg != cur_seg:
            w.align()
            out += w.getvalue()
            out += bytes([0xFF, 0xD0 + ((seg - 1) % 8)])
            w = BitWriter()
            dc_pred = [0] * len(layout.comps)
            cur_seg = seg
        ci = int(layout.scan_comp[j])
        zz = all_blocks[layout.scan_flat[j]]
        dct_t, act = dc_tables[layout.comps[ci].dc_tab], ac_tables[layout.comps[ci].ac_tab]
        # DC
        diff = int(zz[0]) - dc_pred[ci]
        dc_pred[ci] = int(zz[0])
        s = _ssss(diff)
        w.put(int(dct_t.code[s]), int(dct_t.length[s]))
        if s:
            w.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        # AC
        run = 0
        for k in range(1, 64):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run >= 16:
                w.put(int(act.code[T.ZRL]), int(act.length[T.ZRL]))
                run -= 16
            s = _ssss(v)
            sym = (run << 4) | s
            w.put(int(act.code[sym]), int(act.length[sym]))
            w.put(v if v >= 0 else v + (1 << s) - 1, s)
            run = 0
        if run > 0:
            w.put(int(act.code[T.EOB]), int(act.length[T.EOB]))
    w.align()
    out += w.getvalue()
    return bytes(out)


def symbol_histogram(layout: FrameLayout, all_blocks: np.ndarray) -> np.ndarray:
    """[2 kinds(dc,ac), 2 table ids, 256] symbol frequency counts for pass 1."""
    freq = np.zeros((2, 2, 256), dtype=np.int64)
    dc_pred = [0] * len(layout.comps)
    cur_seg = 0
    for j in range(layout.n_scan):
        seg = int(layout.scan_seg[j])
        if seg != cur_seg:
            dc_pred = [0] * len(layout.comps)
            cur_seg = seg
        ci = int(layout.scan_comp[j])
        c = layout.comps[ci]
        zz = all_blocks[layout.scan_flat[j]]
        diff = int(zz[0]) - dc_pred[ci]
        dc_pred[ci] = int(zz[0])
        freq[0, c.dc_tab, _ssss(diff)] += 1
        run = 0
        for k in range(1, 64):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run >= 16:
                freq[1, c.ac_tab, T.ZRL] += 1
                run -= 16
            freq[1, c.ac_tab, (run << 4) | _ssss(v)] += 1
            run = 0
        if run > 0:
            freq[1, c.ac_tab, T.EOB] += 1
    return freq


def standard_tables() -> tuple[list[HuffTable], list[HuffTable]]:
    dc = [build_codes(T.DC_LUMA_BITS, T.DC_LUMA_VALS),
          build_codes(T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)]
    ac = [build_codes(T.AC_LUMA_BITS, T.AC_LUMA_VALS),
          build_codes(T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)]
    return dc, ac


def encode(img: np.ndarray, quality: int = 75, subsampling: str = "420",
           restart_interval: int = 0, optimize: bool = False) -> bytes:
    """Baseline JFIF encode of a [H,W] grayscale or [H,W,3] RGB uint8 image."""
    cfg = EncodeConfig(quality=quality, subsampling=subsampling,
                       restart_interval=restart_interval,
                       optimize_huffman=optimize)
    return encode_with_config(img, cfg)


def encode_with_config(img: np.ndarray, cfg: EncodeConfig) -> bytes:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("image must be uint8")
    mode = "gray" if img.ndim == 2 else cfg.subsampling
    layout = make_layout(img.shape[0], img.shape[1], mode, cfg.restart_interval)
    qtables = [T.scale_qtable(T.QTABLE_LUMA, cfg.quality),
               T.scale_qtable(T.QTABLE_CHROMA, cfg.quality)]
    all_blocks = image_to_zigzag(img, layout, qtables)
    if cfg.optimize_huffman:
        freq = symbol_histogram(layout, all_blocks)
        n_tabs = 1 if layout.is_gray else 2
        dc_tables = [build_codes(*optimize_tables(freq[0, t])) for t in range(n_tabs)]
        ac_tables = [build_codes(*optimize_tables(freq[1, t])) for t in range(n_tabs)]
    else:
        dc_tables, ac_tables = standard_tables()
    scan = entropy_scan(layout, all_blocks, dc_tables, ac_tables)
    hdr = build_headers(layout, qtables, dc_tables, ac_tables)
    return hdr + scan + b"\xff\xd9"
