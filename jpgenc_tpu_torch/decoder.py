"""Decoder: JFIF bytes -> pixels on the device (counterpart of
jpgenc_tpu/decoder.py).

  bytes -> marker parse -> host entropy decode (C++, `native`; inherently
  serial, T.81 F.2.2) -> the smallest upload form of the coefficients ->
  densify on the device into the MCU-major tensor [B, my, mx, L] int16 ->
  the reconstruction kernel (ops/cuda/recon.py) -> uint8 pixels on the device

The core invariant: decode_to_coefficients(encode(img)) is bit-identical to
the encoder's quantized coefficients at matched tables.

Upload forms. Every form ends in the same MCU-major tensor and the same
kernel, so the form never changes a pixel:

  * "packed": the native decoder's 2-byte (delta, value) stream in
    scan-position space, which IS the MCU-major layout (one cumsum, one
    scatter), plus an exception list for |value| > 127 scattered second; a
    batch chunk is one chunk-flat stream (`_flatten_packed`);
  * "pairs": (scan-space index, value) pairs, when there is no packed
    stream;
  * "dense": the int16 tensor itself, when the sparse forms would be larger.

Sizes are uploaded as they are. The reference's power-of-two capacity
buckets, its one-buffer single-image upload and its cache of jitted
reconstructions bound retraces and a per-transfer latency that eager
PyTorch on a local card does not have, and are not carried over (ROADMAP.md
Queue 1 item 9); `_pad_packed` stays as the pinned description of the pad
semantics the densify honours: positions and exception indices past the end
fall into a sink element.

Gray and 4:4:4 / 4:2:2 / 4:2:0 take the CUDA kernel at any size
(`recon.recon_applicable`); the rarer samplings (4:1:1, 4:4:0, 4:1:0) take
the same reconstruction as torch ops on the device (`pixel_fn`), counted in
`unfused_calls`. Sharding a batch over several devices
(jpgenc_tpu/parallel/mesh.py `decode_batch`) is ROADMAP.md Queue 1 item 8.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from jpgenc_tpu_torch import native
from jpgenc_tpu_torch import tables as T
from jpgenc_tpu_torch.container.parser import ParsedJpeg, parse_jpeg
from jpgenc_tpu_torch.engine import resolve_device
from jpgenc_tpu_torch.huffman import HuffTable
from jpgenc_tpu_torch.layout import FrameLayout, make_layout
from jpgenc_tpu_torch.ops.cuda import recon
from jpgenc_tpu_torch.ref.bitio import unstuff_bytes
from jpgenc_tpu_torch.utils.lru import LRUCache

#: reconstructions that ran as torch ops because the layout has no kernel
unfused_calls = 0


class _BitReader:
    """MSB-first bit reader over unstuffed entropy bytes."""

    __slots__ = ("bits", "pos", "n")

    def __init__(self, data: np.ndarray):
        self.bits = np.unpackbits(data)
        self.pos = 0
        self.n = self.bits.size

    def read_bit(self) -> int:
        if self.pos >= self.n:
            raise ValueError("bitstream exhausted")
        b = int(self.bits[self.pos])
        self.pos += 1
        return b

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos + n > self.n:
            raise ValueError("bitstream exhausted")
        v = 0
        for b in self.bits[self.pos:self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v


def _decode_lut(tbl: HuffTable) -> dict[tuple[int, int], int]:
    """(length, code) -> symbol."""
    out = {}
    for sym in range(256):
        l = int(tbl.length[sym])
        if l:
            out[(l, int(tbl.code[sym]))] = sym
    return out


def _read_symbol(br: _BitReader, lut: dict[tuple[int, int], int]) -> int:
    code = 0
    for l in range(1, 17):
        code = (code << 1) | br.read_bit()
        sym = lut.get((l, code))
        if sym is not None:
            return sym
    raise ValueError("invalid Huffman code in scan")


def _extend(v: int, s: int) -> int:
    """T.81 F.2.2.1 EXTEND: amplitude bits -> signed value."""
    if s == 0:
        return 0
    return v if v >= (1 << (s - 1)) else v - (1 << s) + 1


def _tables_by_id(d: dict) -> list:
    """Huffman tables as native rows indexed BY table id (T.81 allows Th
    0-3 in baseline files); a slot the file does not define stays None —
    native._pack_tables leaves it empty, and it is never referenced (ids
    are validated against the tables present by the callers)."""
    return [d.get(i) for i in range(4)]


def _sparse_wins(n_pairs: int, n64: int) -> bool:
    """True when the pair upload (int32 index + int16 value) beats dense
    int16."""
    return 6 * n_pairs < 2 * n64


def _packed_wins(n_main: int, n_exc: int, n64: int) -> bool:
    """True when the packed upload beats the dense int16 tensor."""
    return 2 * n_main + 6 * n_exc < 2 * n64


def _table_ids(parsed: ParsedJpeg) -> tuple[list[int], list[int]]:
    return ([c.dc_tab for c in parsed.comps],
            [c.ac_tab for c in parsed.comps])


def _native_takes(parsed: ParsedJpeg) -> bool:
    """The C++ decoder takes table ids 0-3 that the file defines."""
    comp_dc, comp_ac = _table_ids(parsed)
    return (native.available()
            and all(0 <= t <= 3 for t in comp_dc + comp_ac)
            and all(t in parsed.dc_tables for t in comp_dc)
            and all(t in parsed.ac_tables for t in comp_ac))


def decode_scan_to_blocks(parsed: ParsedJpeg, layout: FrameLayout,
                          n_threads: int = 0) -> np.ndarray:
    """Entropy-decode the scan into the concatenated [n_total, 64] block array.

    Uses the native C++ decoder (jpgenc_tpu_torch.native) when available —
    with `n_threads` segment-parallel workers over restart segments (0 =
    auto; 1 = serial); the pure Python reader below is the reference
    fallback and stays test-covered.

    Table assignments come from the file's SOS header (parsed.comps), not the
    canonical layout ids, so foreign baseline files with unusual Td/Ta
    assignments decode with the right tables.
    """
    comp_dc, comp_ac = _table_ids(parsed)
    for cid, (d, a) in enumerate(zip(comp_dc, comp_ac)):
        if d not in parsed.dc_tables:
            raise ValueError(
                f"component {cid} references undefined DC Huffman table {d}")
        if a not in parsed.ac_tables:
            raise ValueError(
                f"component {cid} references undefined AC Huffman table {a}")

    if _native_takes(parsed):
        out = native.decode_scan(
            parsed.scan_data, layout, comp_dc, comp_ac,
            _tables_by_id(parsed.dc_tables), _tables_by_id(parsed.ac_tables),
            n_threads=n_threads)
        if out is not None:
            return out
    dc_luts = {i: _decode_lut(t) for i, t in parsed.dc_tables.items()}
    ac_luts = {i: _decode_lut(t) for i, t in parsed.ac_tables.items()}

    # split at RST markers (they are never stuffed, so a raw byte scan is safe)
    segs: list[bytes] = []
    data = parsed.scan_data
    start = 0
    i = 0
    while i < len(data) - 1:
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            segs.append(data[start:i])
            start = i + 2
            i += 2
        else:
            i += 1
    segs.append(data[start:])
    if len(segs) != layout.n_segments:
        raise ValueError(f"expected {layout.n_segments} restart segments, "
                         f"found {len(segs)}")

    n_total = sum(c.n_blocks for c in layout.comps)
    out = np.zeros((n_total, 64), dtype=np.int32)

    spb = layout.blocks_per_segment
    for s, seg in enumerate(segs):
        br = _BitReader(unstuff_bytes(seg))
        pred = [0] * len(layout.comps)
        j0 = s * spb
        j1 = min(j0 + spb, layout.n_scan)
        for j in range(j0, j1):
            ci = int(layout.scan_comp[j])
            blk = out[layout.scan_flat[j]]
            ssss = _read_symbol(br, dc_luts[comp_dc[ci]])
            diff = _extend(br.read_bits(ssss), ssss)
            pred[ci] += diff
            blk[0] = pred[ci]
            k = 1
            while k < 64:
                rs = _read_symbol(br, ac_luts[comp_ac[ci]])
                r, sz = rs >> 4, rs & 15
                if sz == 0:
                    if rs == T.ZRL:
                        k += 16
                        continue
                    break  # EOB
                k += r
                if k > 63:
                    raise ValueError("run overflows block")
                blk[k] = _extend(br.read_bits(sz), sz)
                k += 1
    return out


def scan_pairs(parsed: ParsedJpeg, layout: FrameLayout, n_threads: int = 0
               ) -> tuple[np.ndarray, np.ndarray]:
    """Entropy-decode the scan directly to nonzero coefficient pairs
    (flat idx, int16 value) — the native C++ decoder emits this form
    without ever materializing the dense [n_total, 64] tensor, decoding
    restart segments across `n_threads` workers (0 = auto; 1 = serial —
    batch paths pass 1 and parallelize across images instead); the Python
    reference decode + flatnonzero is the fallback."""
    if _native_takes(parsed):
        out = native.decode_scan_sparse(
            parsed.scan_data, layout, *_table_ids(parsed),
            _tables_by_id(parsed.dc_tables), _tables_by_id(parsed.ac_tables),
            n_threads=n_threads)
        if out is not None:
            return out
    blocks = decode_scan_to_blocks(parsed, layout, n_threads=n_threads)
    nz = np.flatnonzero(blocks)
    return nz.astype(np.int64), blocks.reshape(-1)[nz].astype(np.int16)


def scan_packed(parsed: ParsedJpeg, layout: FrameLayout, n_threads: int = 0
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Entropy-decode the scan to the packed 2-byte-per-coefficient form
    (native.decode_scan_packed), decoding restart segments across
    `n_threads` workers (0 = auto; 1 = serial — batch paths pass 1 and
    parallelize across images instead). Returns None when the native
    library is unavailable, the capacity heuristic overflows, or table ids
    fall outside the native range — callers fall back to `scan_pairs`."""
    if _native_takes(parsed):
        return native.decode_scan_packed(
            parsed.scan_data, layout, *_table_ids(parsed),
            _tables_by_id(parsed.dc_tables), _tables_by_id(parsed.ac_tables),
            n_threads=n_threads)
    return None


_INV_SCAN = LRUCache(64)


def _inv_scan(layout: FrameLayout) -> np.ndarray:
    """flat (component-planar) block index -> scan-order block index."""
    key = (layout.height, layout.width, layout.subsampling)
    inv = _INV_SCAN.get(key)
    if inv is None:
        n_total = sum(c.n_blocks for c in layout.comps)
        inv = np.empty(max(n_total, layout.n_scan), np.int64)
        inv[np.asarray(layout.scan_flat, np.int64)] = np.arange(layout.n_scan)
        _INV_SCAN[key] = inv
    return inv


def _scan_space_eidx(eidx: np.ndarray, layout: FrameLayout) -> np.ndarray:
    """Coefficient indices from flat (component-planar) space into
    scan-position space (the MCU-major layout)."""
    e = eidx.astype(np.int64)
    return _inv_scan(layout)[e >> 6] * 64 + (e & 63)


def _q_rows(layout: FrameLayout, qts: list) -> np.ndarray:
    """Per-component [64] natural-order quant tables -> [B, L] f32 zigzag
    quant rows in the MCU-major lane order (luma tiled nb times, then
    Cb, Cr). qts entries are [64] (B=1) or [B, 64]. numpy: the rows are
    made on the host and uploaded with the coefficients."""
    c0 = layout.comps[0]
    nb = c0.hs * c0.vs
    zz = np.asarray(T.ZIGZAG)
    rows = [np.asarray(q).reshape(-1, 64).astype(np.float32)[:, zz]
            for q in qts]
    return np.ascontiguousarray(
        np.concatenate([np.tile(rows[0], (1, nb))] + rows[1:], axis=1))


def _rows_from_pairs(idx: np.ndarray, val: np.ndarray, size: int,
                     cap: int) -> np.ndarray:
    """Nonzero coefficient pairs -> [3, cap] int16 sparse triple rows
    (idx_lo, idx_hi, value), idx = flat position: the layout of the packed
    form's exception list. Padding entries carry an out-of-bounds idx
    (`size`), which the device-side scatter drops."""
    n = idx.size
    out = np.empty((3, cap), np.int16)
    out[0, :n] = (idx & 0xFFFF).astype(np.int16)
    out[1, :n] = (idx >> 16).astype(np.int16)
    out[2, :n] = val.astype(np.int16)
    out[0, n:] = np.uint16(size & 0xFFFF).view(np.int16)
    out[1, n:] = np.uint16(size >> 16).view(np.int16)
    out[2, n:] = 0
    return out


def _sparsify(blocks: np.ndarray, cap: int) -> np.ndarray:
    """Dense [n_total, 64] coefficients -> [3, cap] int16 sparse rows."""
    nz = np.flatnonzero(blocks)
    return _rows_from_pairs(nz.astype(np.int64),
                            blocks.reshape(-1)[nz], blocks.size, cap)


def _pad_packed(main: np.ndarray, eidx: np.ndarray, evals: np.ndarray,
                cap_main: int, cap_exc: int, size: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Pad a packed stream to (cap_main, cap_exc): main pads are (255, 0)
    phantoms (keep walking the tail, writing zeros into zero positions
    until the index leaves the array and drops); exception pads carry an
    out-of-bounds index. The decode paths upload exact sizes; the densify
    honours these pads all the same."""
    n = main.shape[0]
    out = np.empty((cap_main, 2), np.uint8)
    out[:n] = main
    out[n:, 0] = 255
    out[n:, 1] = 0
    return out, _rows_from_pairs(eidx.astype(np.int64), evals, size, cap_exc)


def _flatten_packed(packed: list, n_scan64: int, n64: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate per-frame packed streams into ONE chunk-flat stream in
    GLOBAL scan-position space (frame f's positions live at
    [f*n_scan64, (f+1)*n_scan64)): frame boundaries are bridged by
    adjusting each frame's first delta and inserting (255, 0) phantom hops
    for gaps > 255 — phantoms only ever write zeros into trailing/leading
    zero positions, so the chunk decodes with a single exact-size upload
    and ONE scatter. Exception indices of frame f are offset by f*n64:
    callers whose exceptions are already in scan space pass n64 =
    n_scan64. Returns (main [n, 2] u8, exception global idx i64, exception
    values i16)."""
    parts = []
    exc_idx_parts, exc_val_parts = [], []
    prev = -1                     # last written global pos
    for f, (main, eidx, evals) in enumerate(packed):
        base = f * n_scan64
        if main.shape[0]:
            first = base + int(main[0, 0]) - 1     # global pos of 1st entry
            last = base + int(main[:, 0].astype(np.int64).sum()) - 1
            gap = first - prev
            k = (gap - 1) // 255                   # bridge phantom hops
            if k:
                ph = np.zeros((k, 2), np.uint8)
                ph[:, 0] = 255
                parts.append(ph)
            if k or f:
                main = main.copy()
                main[0, 0] = gap - 255 * k
            parts.append(main)
            prev = last
        if eidx.size:
            exc_idx_parts.append(eidx.astype(np.int64) + f * n64)
            exc_val_parts.append(evals)
    main_all = np.concatenate(parts) if parts else np.zeros((0, 2), np.uint8)
    eidx = (np.concatenate(exc_idx_parts) if exc_idx_parts
            else np.zeros(0, np.int64))
    evals = (np.concatenate(exc_val_parts) if exc_val_parts
             else np.zeros(0, np.int16))
    return main_all, eidx, evals


def _pairs_from_packed(pk: tuple, layout: FrameLayout
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Convert a packed stream to (flat idx, int16 value) pairs on host —
    phantoms (value 0) dropped, escapes (-128) replaced from the exception
    list in emit order. Lets the pair/dense fallbacks reuse an
    already-decoded packed stream instead of entropy-decoding the scan a
    second time."""
    main, eidx, evals = pk
    pos = np.cumsum(main[:, 0].astype(np.int64)) - 1
    val = main[:, 1].view(np.int8)
    keep = val != 0
    pos = pos[keep]
    sf = np.asarray(layout.scan_flat, np.int64)
    idx = sf[pos >> 6] * 64 + (pos & 63)
    out = val[keep].astype(np.int16)
    esc = np.flatnonzero(out == -128)      # 1:1, in emit order
    out[esc] = evals
    return idx, out


def layout_from_parsed(parsed: ParsedJpeg) -> FrameLayout:
    return make_layout(parsed.height, parsed.width, parsed.subsampling,
                       parsed.restart_interval)


def _qts_of(parsed: ParsedJpeg) -> list:
    qts = []
    for ci, c in enumerate(parsed.comps):
        if c.qtab not in parsed.qtables:
            raise ValueError(
                f"component {ci} references undefined quant table {c.qtab}")
        qts.append(parsed.qtables[c.qtab])
    return qts


def decode_to_coefficients(data: bytes) -> tuple[FrameLayout, np.ndarray, dict]:
    """JPEG bytes -> (layout, [n_total, 64] zigzag int32 blocks, qtables)."""
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    blocks = decode_scan_to_blocks(parsed, layout)
    return layout, blocks, parsed.qtables


def coefficients_from_reference(layout: FrameLayout, blocks: np.ndarray,
                                qts) -> tuple[torch.Tensor, torch.Tensor]:
    """What carries across from the reference's decoder: its
    `decode_to_coefficients` output (numpy [n_total, 64] blocks, or
    [B, n_total, 64], and the quant tables: a dict by table id, or one
    [64] / [B, 64] natural-order table per component) -> the port's CPU
    tensors (x4 [B, my, mx, L] int16 MCU-major, q_rows [B, L] f32)."""
    if isinstance(qts, dict):
        qts = [qts[c.qtab] for c in layout.comps]
    blocks = np.asarray(blocks)
    blocks = blocks.reshape(-1, blocks.shape[-2], 64)
    x4 = blocks[:, np.asarray(layout.scan_flat)].astype(np.int16).reshape(
        blocks.shape[0], layout.mcus_y, layout.mcus_x, -1)
    q_rows = _q_rows(layout, list(qts))
    if q_rows.shape[0] != x4.shape[0]:
        q_rows = np.repeat(q_rows, x4.shape[0], axis=0)
    return (torch.from_numpy(np.ascontiguousarray(x4)),
            torch.from_numpy(np.ascontiguousarray(q_rows)))


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------

def pixel_fn(layout: FrameLayout):
    """The reconstruction as torch ops: ([..., n_total, 64] coefficient
    blocks, per-component [..., 64] natural-order quant tables) -> uint8
    pixels cropped to the true image size (decoder.py:449-486). The plain
    version of the kernels and the path of the samplings they do not
    take."""
    def _pix(blocks, qts):
        return recon.pixels_from_blocks(layout, blocks, qts)
    return _pix


def _densify_packed(main: torch.Tensor, eidx: torch.Tensor,
                    evals: torch.Tensor, size: int) -> torch.Tensor:
    """Packed (delta, val_s8) stream [n, 2] u8 + exceptions (int64 indices,
    int16 values), all in scan-position space -> flat int16 [size] on the
    stream's device.

    pos = cumsum(delta) - 1, in int64, so nothing can wrap. Deltas are
    >= 1, so positions are strictly increasing and unique: the scatter is
    deterministic. Phantom hops write 0 into positions that are zero
    anyway; positions and exception indices past the end (pads) fall into
    one sink element. Exceptions scatter SECOND, on the same stream,
    overwriting their -128 escape bytes."""
    pos = torch.cumsum(main[:, 0].to(torch.int64), dim=0) - 1
    val = main[:, 1].contiguous().view(torch.int8).to(torch.int16)
    flat = torch.zeros(size + 1, dtype=torch.int16, device=main.device)
    flat.index_put_((pos.clamp_(max=size),), val)
    return _scatter_pairs(flat, eidx, evals, size)


def _scatter_pairs(flat: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                   size: int) -> torch.Tensor:
    """flat[idx] = val with out-of-range indices dropped into the sink
    element flat[size]; returns flat[:size]."""
    if idx.numel():
        idx = idx.to(torch.int64)
        idx = torch.where((idx < 0) | (idx > size), size, idx)
        flat.index_put_((idx,), val)
    return flat[:size]


def _densify_pairs(idx: torch.Tensor, val: torch.Tensor, size: int
                   ) -> torch.Tensor:
    """Scan-space (index, int16 value) pairs -> flat int16 [size]."""
    flat = torch.zeros(size + 1, dtype=torch.int16, device=val.device)
    return _scatter_pairs(flat, idx, val, size)


class _Job(NamedTuple):
    """One chunk's host arrays, ready to upload."""
    form: str                # "packed" | "pairs" | "dense"
    arrays: tuple            # numpy arrays of the form
    q_rows: np.ndarray       # [nb, L] f32
    nb: int                  # images in the chunk

    @property
    def h2d_bytes(self) -> int:
        return sum(a.nbytes for a in self.arrays) + self.q_rows.nbytes


def _job_from_packed(layout: FrameLayout, packed: list, q_rows: np.ndarray
                     ) -> _Job:
    """The smallest upload form of one chunk whose frames all have a packed
    stream (main, exception FLAT indices, exception values)."""
    n_scan64 = layout.n_scan * 64
    nb = len(packed)
    scan = [(m, _scan_space_eidx(e, layout), v) for m, e, v in packed]
    main, eidx, evals = _flatten_packed(scan, n_scan64, n_scan64)
    if _packed_wins(main.shape[0], eidx.size, nb * n_scan64):
        return _Job("packed", (main, eidx, evals), q_rows, nb)
    # pathological dense content: unpack on the host (no second entropy
    # decode)
    return _job_from_pairs(
        layout, [_pairs_from_packed(p, layout) for p in packed], q_rows)


def _job_from_pairs(layout: FrameLayout, pairs: list, q_rows: np.ndarray
                    ) -> _Job:
    """Pairs (FLAT idx, value) per frame -> the pairs form when it is
    smaller than the dense tensor, else the dense form."""
    n_scan64 = layout.n_scan * 64
    nb = len(pairs)
    idx = np.concatenate([_scan_space_eidx(i, layout) + f * n_scan64
                          for f, (i, _) in enumerate(pairs)])
    val = np.concatenate([v.astype(np.int16) for _, v in pairs])
    if _sparse_wins(idx.size, nb * n_scan64):
        if nb * n_scan64 < 2**31:
            idx = idx.astype(np.int32)
        return _Job("pairs", (idx, val), q_rows, nb)
    dense = np.zeros(nb * n_scan64, np.int16)
    dense[idx] = val
    return _Job("dense", (dense,), q_rows, nb)


def _upload(job: _Job, dev: torch.device) -> tuple:
    """(device tensors of job.arrays, q_rows on the device): synchronous
    copies from pageable memory."""
    return (tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in job.arrays),
            torch.from_numpy(job.q_rows).to(dev))


def _densify(layout: FrameLayout, form: str, arrays: tuple, nb: int
             ) -> torch.Tensor:
    """An uploaded form -> the MCU-major tensor [nb, my, mx, L] int16 on
    the arrays' device."""
    size = nb * layout.n_scan * 64
    if form == "packed":
        flat = _densify_packed(*arrays, size)
    elif form == "pairs":
        flat = _densify_pairs(*arrays, size)
    elif form == "dense":
        flat = arrays[0]
    else:
        raise ValueError(f"unknown upload form {form!r}")
    return flat.reshape(nb, layout.mcus_y, layout.mcus_x,
                        layout.blocks_per_mcu * 64)


def _reconstruct(layout: FrameLayout, form: str, arrays: tuple,
                 q_rows: torch.Tensor, nb: int) -> torch.Tensor:
    """Device half of one chunk: densify the uploaded form, then the kernel
    (or, for a layout without one, the torch reconstruction). Returns
    [nb, h, w, 3] / [nb, h, w] uint8."""
    global unfused_calls
    x4 = _densify(layout, form, arrays, nb)
    if recon.recon_applicable(layout):
        return recon.fused_recon_rgb(x4, q_rows, layout)
    unfused_calls += 1
    return recon.pixels_from_scan(x4, q_rows, layout)


def _run(layout: FrameLayout, job: _Job, dev: torch.device) -> torch.Tensor:
    arrays, q_rows = _upload(job, dev)
    return _reconstruct(layout, job.form, arrays, q_rows, job.nb)


def reconstruct_pixels(layout: FrameLayout, all_blocks: np.ndarray,
                       qtables, to_device: bool = False, device="cuda"):
    """Device reconstruction: blocks -> uint8 image, cropped to original size.

    qtables: dict keyed by the layout's quant-table ids, or a per-component
    sequence of [64]-element natural-order tables (foreign files may assign
    any Tq per component). Baseline coefficients fit int16 and are mostly
    zeros at photographic qualities: they are uploaded as pairs unless the
    dense tensor is smaller.

    to_device=True returns the uint8 tensor on `device` instead of
    downloading — the production shape when decoded pixels feed a
    device-side input pipeline.
    """
    dev = resolve_device(device)
    if isinstance(qtables, dict):
        qts = [np.asarray(qtables[c.qtab]) for c in layout.comps]
    else:
        qts = [np.asarray(q) for q in qtables]
    nz = np.flatnonzero(all_blocks)
    job = _job_from_pairs(
        layout, [(nz.astype(np.int64), all_blocks.reshape(-1)[nz])],
        _q_rows(layout, qts))
    out = _run(layout, job, dev)[0]
    return out if to_device else out.cpu().numpy()


def _single_job(parsed: ParsedJpeg, layout: FrameLayout) -> _Job:
    q_rows = _q_rows(layout, _qts_of(parsed))
    pk = scan_packed(parsed, layout)
    if pk is not None:
        return _job_from_packed(layout, [pk], q_rows)
    return _job_from_pairs(layout, [scan_pairs(parsed, layout)], q_rows)


def decode(data: bytes, to_device: bool = False, device="cuda"):
    """JPEG bytes -> uint8 image ([H,W] grayscale or [H,W,3] RGB), computed
    on `device`: "cuda" runs the reconstruction kernel and raises if CUDA is
    absent; "cpu" runs the plain PyTorch version.

    to_device=True keeps the decoded pixels on the device (returns a
    torch.uint8 tensor) instead of downloading — for feeding device-side
    input pipelines.

    Coefficients are uploaded in the smallest available form: the packed
    2-byte (delta, val) stream when the native decoder is available and it
    beats dense, else sparse pairs, else dense.
    """
    dev = resolve_device(device)
    parsed = parse_jpeg(data)
    layout = layout_from_parsed(parsed)
    out = _run(layout, _single_job(parsed, layout), dev)[0]
    return out if to_device else out.cpu().numpy()


def _recon_jobs(datas: list[bytes], chunk: int | None):
    """Host half of decode_batch: parse + entropy decode + upload-form
    selection. Returns (layout, [thunk per chunk -> _Job]) — or None when
    the batch mixes geometries and must go per-image. Each thunk builds its
    chunk's host arrays when called, so a caller can upload and launch one
    chunk before the next one's arrays are made."""
    parsed = [parse_jpeg(d) for d in datas]

    def _geom(p):
        # geometry INCLUDES the restart interval: the segment layout drives
        # the scan decode, so a mixed-DRI batch must go per-image
        return (p.height, p.width, p.subsampling, p.restart_interval)

    if any(_geom(p) != _geom(parsed[0]) for p in parsed):
        return None
    layout = layout_from_parsed(parsed[0])

    # across-image parallelism via the pool (the native call releases the
    # GIL); within-image segment threading (n_threads=0 auto) only when
    # there's a single image to decode — nesting both would oversubscribe
    # the cores
    nth = 1 if len(parsed) > 1 else 0
    with ThreadPoolExecutor(max_workers=min(8, len(datas))) as ex:
        packed = list(ex.map(
            lambda p: scan_packed(p, layout, n_threads=nth), parsed))
    redo = [f for f, p in enumerate(packed) if p is None]
    pairs = {}
    if redo:
        # reuse every already-decoded packed stream and entropy-decode
        # only the frames that lack one
        with ThreadPoolExecutor(max_workers=min(8, len(redo))) as ex:
            pairs = dict(zip(redo, ex.map(
                lambda f: scan_pairs(parsed[f], layout, n_threads=nth),
                redo)))

    n_comps = len(parsed[0].comps)
    qts_b = [_qts_of(p) for p in parsed]
    q_rows = _q_rows(layout, [np.stack([np.asarray(row[i]).reshape(64)
                                        for row in qts_b])
                              for i in range(n_comps)])
    b = len(datas)
    if chunk is None or chunk >= b:
        chunk = b
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")

    def job(c0: int) -> _Job:
        rows = range(c0, min(c0 + chunk, b))
        q = q_rows[rows.start:rows.stop]
        if not any(f in pairs for f in rows):
            return _job_from_packed(layout, [packed[f] for f in rows], q)
        return _job_from_pairs(
            layout, [pairs[f] if f in pairs
                     else _pairs_from_packed(packed[f], layout)
                     for f in rows], q)

    return layout, [lambda c0=c0: job(c0) for c0 in range(0, b, chunk)]


def decode_batch(datas: list[bytes], to_device: bool = False,
                 chunk: int | None = None, device="cuda"):
    """Decode same-geometry JPEGs with batched device reconstruction.

    Host side parses + entropy-decodes each scan (native C++, the GIL is
    released during the call so a thread pool gives real parallelism);
    device side runs one densify and one kernel launch per chunk. Falls
    back to per-image decode when geometries differ.

    chunk=N splits the batch into N-image chunks enqueued back to back: the
    host builds chunk i+1's arrays while the device reconstructs chunk i.
    Default (None) is one chunk for the whole batch.

    to_device=True returns the decoded pixels still on the device: a
    stacked [B, H, W(, 3)] uint8 tensor when chunk is None, or a LIST of
    per-chunk stacked tensors whenever chunk is set — even if the batch
    fits one chunk, so callers with a fixed chunk see one type regardless
    of batch size. to_device=False returns a list of numpy arrays, one per
    image.
    """
    if not datas:
        return []
    dev = resolve_device(device)
    prep = _recon_jobs(datas, chunk)
    if prep is None:
        if to_device:
            raise ValueError("to_device=True requires same-geometry inputs")
        return [decode(d, device=dev) for d in datas]
    layout, jobs = prep
    outs_d = [_run(layout, job(), dev) for job in jobs]
    if to_device:
        return outs_d if chunk is not None else outs_d[0]
    return [a[i] for o in outs_d for a in (o.cpu().numpy(),)
            for i in range(a.shape[0])]


def stage_recon(datas: list[bytes], chunk: int | None = None, device="cuda"):
    """Pre-stage a same-geometry batch's coefficient streams on the device
    and return `(run, h2d_bytes)`, where `run()` executes ONLY the device
    half (densify + reconstruction, returning the per-chunk pixel tensors)
    and `h2d_bytes` is what the staging uploaded, quant rows included.
    Measurement helper: separates the device decode rate from the host
    parse and entropy decode and from the upload."""
    dev = resolve_device(device)
    prep = _recon_jobs(datas, chunk)
    if prep is None:
        raise ValueError("stage_recon requires same-geometry inputs")
    layout, jobs = prep
    staged = []
    h2d = 0
    for thunk in jobs:
        job = thunk()
        h2d += job.h2d_bytes
        staged.append((job.form, *_upload(job, dev), job.nb))

    def run():
        return [_reconstruct(layout, form, arrays, q, nb)
                for form, arrays, q, nb in staged]
    return run, h2d
