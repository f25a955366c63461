"""Encode engine: per-layout device plan, capacities, fetch and host finalize
(counterpart of jpgenc_tpu/engine.py).

The fused path (standard tables):

  pixels (u8, device) -> [K1A] per-block packed words -> [kernel B, with
  the word compaction (bswap)] compact stream, nbits, ovf -> ONE copy of
  (prefix, nbits, ovf) to the host -> C++ stuffing finalize
  (jpgenc_tpu_torch.native) + JFIF headers

The split path (two-pass optimized Huffman):

  pass 1: pixels -> [K1] scan-ordered zigzag int16, kept on the device
          -> symbol histogram -> host: one Huffman table set per image
  pass 2: zigzag + tables -> [kernel A] per-block packed words -> [kernel B]
          -> the same fetch and finalize

The integer path (dct_method="islow", libjpeg-exact) is the split path
with ops/islow.py in K1's place: torch int32 ops -> scan gather -> the same
zigzag tensor -> kernel A -> kernel B, with the standard tables or, after a
histogram, the image's own.

Restart intervals change no stage's shape logic: every slot array is padded
to whole segments (S = n_segments * blocks_per_segment), kernel B sees
n_segments segments an image, aligns their starts in the stream and the host
finalize joins them with RSTn.

`EncodePlan` takes the role of the reference's `DevicePlan`: its buffers are
the transform operators, the quant rows, the packed standard Huffman tables
and the layout's symbol plan and scan gather. `EncodeJob` is the one order
of the encode on a plan (pass 1, tables, pass 2, fetch and finalize, the
re-code of an overflowed row) that api.encode and the distribution layer's
encode_batch and encode_striped run.
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from jpgenc_tpu_torch import layout as L, native, tables as T
from jpgenc_tpu_torch.container import jfif
from jpgenc_tpu_torch.huffman import build_codes, optimize_tables
from jpgenc_tpu_torch.ops import entropy, islow, pack
from jpgenc_tpu_torch.ops.cuda import block_pack, k1_dct, k1a_fused, seg_merge
from jpgenc_tpu_torch.ops.cuda.block_pack import packed_tables
from jpgenc_tpu_torch.ops.transform import _KDCT_ZZ
from jpgenc_tpu_torch.ref import encoder as ref_encoder
from jpgenc_tpu_torch.utils.profiling import span


def resolve_device(device) -> torch.device:
    """The explicit device rule: "cuda" needs CUDA and never falls back to
    the CPU; "cpu" runs the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but torch.cuda."
                "is_available() is False; pass device='cpu' to run the "
                "plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


class SymbolPlan(NamedTuple):
    """Static per-layout scan-order arrays (numpy), padded to whole
    segments."""
    prev_same: np.ndarray   # [S] int32, DC predecessor slot or -1
    dc_tab: np.ndarray      # [S] int32 table id per slot
    ac_tab: np.ndarray      # [S] int32
    valid: np.ndarray       # [S] bool (False for segment padding slots)


def make_symbol_plan(layout) -> SymbolPlan:
    """Pad the scan-order index arrays to whole segments
    (engine.py:39-57)."""
    pad = layout.n_segments * layout.blocks_per_segment - layout.n_scan

    def _pad(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)]) if pad else a

    dc_tab = np.array([layout.comps[ci].dc_tab for ci in layout.scan_comp],
                      np.int32)
    ac_tab = np.array([layout.comps[ci].ac_tab for ci in layout.scan_comp],
                      np.int32)
    return SymbolPlan(prev_same=_pad(layout.prev_same, -1),
                      dc_tab=_pad(dc_tab, 0), ac_tab=_pad(ac_tab, 0),
                      valid=_pad(np.ones(layout.n_scan, bool), False))


def make_scan_gather(layout) -> np.ndarray:
    """scan_flat padded to whole segments (engine.py:60-65): raster block
    index of every scan slot, 0 for padding slots."""
    flat = np.zeros(layout.n_segments * layout.blocks_per_segment, np.int32)
    flat[:layout.n_scan] = layout.scan_flat
    return flat


class EntropyLUTs(NamedTuple):
    """Dense Huffman encode tables (numpy [2, 256] int32, one row per table
    id), entries packed (code << 5) | code_len."""
    dc: np.ndarray
    ac: np.ndarray


def luts_from_tables(dc_tables, ac_tables) -> EntropyLUTs:
    """HuffTable lists -> packed LUTs (engine.py:68-77, numpy)."""
    def rows(tabs):
        out = np.zeros((2, 256), np.int64)
        for i, t in enumerate(tabs[:2]):
            out[i] = (np.asarray(t.code, np.int64) << 5) | np.asarray(t.length)
        if len(tabs) == 1:
            out[1] = out[0]
        return out.astype(np.int32)
    return EntropyLUTs(dc=rows(dc_tables), ac=rows(ac_tables))


def qtables_for_quality(quality: int) -> np.ndarray:
    """Host [2, 64] int32 natural-order quant tables (luma, chroma)."""
    return np.stack([T.scale_qtable(T.QTABLE_LUMA, quality),
                     T.scale_qtable(T.QTABLE_CHROMA, quality)])


def tables_from_freq(freq: np.ndarray, n_tabs: int):
    """Symbol histogram [2 (dc, ac), 2, 256] of one image -> (dc_tables,
    ac_tables), n_tabs optimized HuffTables each (T.81 K.2; api.py:65-69,
    mesh.py:317-322). n_tabs is 1 for gray."""
    dc = [build_codes(*optimize_tables(freq[0, t].astype(np.int64)))
          for t in range(n_tabs)]
    ac = [build_codes(*optimize_tables(freq[1, t].astype(np.int64)))
          for t in range(n_tabs)]
    return dc, ac


def tables_from_reference(qt_host, luts_dc, luts_ac, separable=None) -> dict:
    """The parameters carried across from the reference: its numpy quant
    tables [2, 64] (natural order) and packed Huffman LUTs ([2, 256] each,
    as `jpgenc_tpu.engine.luts_from_tables` makes them; a gray image's one
    table fills both rows; [B, 2, 256] for one optimized set per image) ->
    the port's CPU tensors: qzz [2, 64] f32 in zigzag order, qnat [2, 64]
    int32 in natural order (the islow path's), and ac_rows / dc_rows / misc
    (block_pack.packed_tables), with the same leading dimension as the LUTs.
    separable: the reference's (bd_y, sc, q_out) as its k1_dct.
    build_operators returns them, as numpy -> sep (k1_dct.
    separable_operator) and q_out [(nb+2)*64] f32, the separable K1 kernel's
    operands."""
    zz = np.asarray(T.ZIGZAG)
    qnat = np.asarray(qt_host).reshape(2, 64)
    qzz = qnat.astype(np.float32)[:, zz]
    ac_rows, dc_rows, misc = packed_tables(
        EntropyLUTs(dc=np.asarray(luts_dc), ac=np.asarray(luts_ac)))
    out = {"qzz": torch.from_numpy(np.ascontiguousarray(qzz)),
           "qnat": torch.from_numpy(np.ascontiguousarray(qnat, np.int32)),
           "ac_rows": ac_rows, "dc_rows": dc_rows, "misc": misc}
    if separable is not None:
        bd_y, sc, q_out = (np.asarray(a, np.float32) for a in separable)
        out["sep"] = torch.from_numpy(k1_dct.separable_operator(bd_y, sc))
        out["q_out"] = torch.from_numpy(q_out.reshape(-1).copy())
    return out


def scan_caps(layout, quality: int, tier: str = "safe") -> tuple[int, int]:
    """(cap_u, cap_s) byte capacities of the compact stream for a tier
    (engine.py:686-718). "tight" and "safe" share one capacity, 2 / 4 / 7
    bits a plane sample at Q <= 80 / <= 92 / above (about 3 bpp at 4:2:0
    Q75), which holds photographic and most noise-like content; "worst" can
    never overflow (paired with w_blk=56, which covers MAX_BLOCK_BITS).

    The reference sizes its tight tier at a quarter of that, because a TPU
    buffer's shape is compiled in and fetched whole. Here a larger stream
    capacity costs device memory only: the merge tail's stream is a
    torch.empty whose words past an image's prefix are never written, and
    the fetch copies prefix_guess words, not cap_u. So tight and safe
    differ only in w_blk (tiers_for), and photographs fit tier 0."""
    wal = pack.walign_for(layout.blocks_per_segment)
    worst = sum(c.n_blocks for c in layout.comps) * pack.MAX_BLOCK_BITS // 8 \
        + 4 * wal * layout.n_segments + 8
    if tier == "worst":
        return worst, 2 * worst + 16
    px = sum(c.plane_h * c.plane_w for c in layout.comps)
    bpp = 2.0 if quality <= 80 else (4.0 if quality <= 92 else 7.0)
    cap_u = min(int(px * bpp / 8) + 1024 + 4 * wal * layout.n_segments,
                worst)
    cap_u = -(-cap_u // 1024) * 1024
    cap_s = cap_u + cap_u // 16 + 64
    return cap_u, cap_s


def tiers_for(layout, quality: int) -> list[tuple[int, int]]:
    """The capacity ladder (api.py:51-55): (cap_u, w_blk) tight -> safe with
    max(w, 24) -> worst with 56, duplicates dropped, so tiers[0] is always
    (tight, w_blk_for_quality) and tiers[-1] always (worst, 56). Tight and
    safe share scan_caps' one stream capacity, so tiers[0] and tiers[1]
    differ only in w_blk, and merge where w_blk_for_quality is 24 already."""
    w_q = pack.w_blk_for_quality(quality)
    cap = scan_caps(layout, quality, "tight")[0]
    tiers = [(cap, w_q), (cap, max(w_q, 24)),
             (scan_caps(layout, quality, "worst")[0], 56)]
    return [t for i, t in enumerate(tiers) if t not in tiers[:i]]


EOI = b"\xff\xd9"

#: what an overflow at the worst tier raises: that tier covers
#: MAX_BLOCK_BITS, so it cannot overflow
OVERFLOW = ("overflow at the worst capacity tier, which covers "
            "MAX_BLOCK_BITS: the encode is broken")


def jfif_headers(layout, quality: int, dc_tables=None, ac_tables=None
                 ) -> bytes:
    """SOI..SOS headers at `quality`, with the standard tables unless an
    image's own (optimized) tables are given."""
    if dc_tables is None:
        dc_tables, ac_tables = ref_encoder.standard_tables()
    return jfif.build_headers(layout, list(qtables_for_quality(quality)),
                              dc_tables, ac_tables)


#: bytes that to_host_async has copied to the host since the last reset (the
#: bench's d2h_bytes), added to under _fetched_lock
fetched_bytes = 0
_fetched_lock = threading.Lock()


class HostCopy(NamedTuple):
    """A device -> host copy in flight (the handle of to_host_async): the
    host tensor it lands in and, for a CUDA source, the event recorded
    behind the copy on the source's stream."""
    host: torch.Tensor
    event: object = None

    def wait(self) -> np.ndarray:
        """Block until the copy has landed; the host data as numpy (a view
        of this handle's own buffer, which no later copy reuses)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def to_host_async(t: torch.Tensor) -> HostCopy:
    """Start copying t to the host and return at once (the counterpart of
    jax.Array.copy_to_host_async, engine.py:567-587): for a CUDA tensor, a
    non_blocking copy on the current stream into a pinned buffer of its own
    and an event recorded behind it, so the copy starts the moment the
    kernels before it finish and the caller blocks only in wait(). Each
    call allocates its buffer (PyTorch's caching host allocator recycles
    pinned blocks only after they are freed and their copies are done), so
    the arrays of an earlier fetch, which are views, are never overwritten.
    A CPU tensor is already on the host: it is its own copy."""
    global fetched_bytes
    with _fetched_lock:
        fetched_bytes += t.numel() * t.element_size()
    if t.device.type != "cuda":
        return HostCopy(t)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return HostCopy(host, event)


def combined_fetch(wstream: torch.Tensor, nbits: torch.Tensor,
                   ovf: torch.Tensor, k: int) -> tuple[HostCopy, int]:
    """Start ONE copy of (word prefix [B, k], nbits [B, n_seg], ovf [B]) to
    the host (engine.py:558-594) and return (handle, k): handle.wait()
    gives the array for split_fetch."""
    k = min(k, wstream.shape[-1])
    packed = torch.cat([wstream[:, :k], nbits.to(torch.int32),
                        ovf.to(torch.int32)[:, None]], dim=1)
    return to_host_async(packed), k


def split_fetch(arr: np.ndarray, k: int, n_seg: int):
    """Host unpack of a combined_fetch array -> (u_words_i32 [..., k],
    nbits [..., n_seg], ovf bool [...])."""
    return (arr[..., :k], arr[..., k:k + n_seg],
            arr[..., k + n_seg] != 0)


def finalize_host_w(up: np.ndarray, nbits: np.ndarray, first_rst: int,
                    n_rst: int, walign: int, head: bytes = b"",
                    tail: bytes = b"") -> bytes:
    """Word-compact stream -> stuffed scan with RSTn joins (engine.py:625-656):
    sets the T.81 F.1.2.3 1-padding, stuffs FF -> FF00 and inserts RSTn after
    the first n_rst segments; head and tail (a file's headers and EOI) come
    before and after it in the one bytes object. C++
    (jpgenc_tpu_torch.native.finalize_wcompact) with the reference's numpy
    fallback."""
    if native.available():
        out = native.finalize_wcompact(up, nbits, first_rst, n_rst, walign,
                                       head, tail)
        if out is not None:
            return out
    b = np.ascontiguousarray(up).view(np.uint8)
    parts = [head]
    wb = 0
    for s, bits in enumerate(np.asarray(nbits)):
        bits = int(bits)
        nbytes = (bits + 7) >> 3
        seg = b[4 * wb:4 * wb + nbytes].copy()
        pad = nbytes * 8 - bits
        if pad and nbytes:
            seg[-1] |= (1 << pad) - 1
        ff = np.flatnonzero(seg == 0xFF)
        parts.append((np.insert(seg, ff + 1, 0) if ff.size else seg).tobytes())
        if s < n_rst:
            parts.append(bytes([0xFF, 0xD0 + ((first_rst + s) & 7)]))
        wb += int(pack.seg_nwords_aligned(bits, walign))
    parts.append(tail)
    return b"".join(parts)


class EncodePlan(nn.Module):
    """Per-(layout, quant, tables) encode pipeline on one device.

    Buffers: the transform operator kdct (KDCT_ZZ [64, 64], the one operand
    of the shared per-block transform, colour and gray), the separable
    operator sep (colour), the quant row q (zigzag order; colour: luma tiled
    nb times then chroma twice), the natural-order int32 quant tables qnat
    (islow), the packed standard Huffman tables, the symbol plan of the
    split path and the scan gather of the islow path.
    forward(imgs, cap_u, w_blk) is the fused path; zz_and_histogram (or
    zz_islow) and entropy_from_zz are the two passes of the split path.
    Both return the compact word stream, per-segment bit counts and the
    per-image overflow flag. EncodeJob runs them in order."""

    def __init__(self, layout, tables: dict, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.layout = layout
        self.walign = pack.walign_for(layout.blocks_per_segment)
        c0 = layout.comps[0]
        nb = c0.hs * c0.vs
        qzz = tables["qzz"]
        if layout.is_gray:
            q = qzz[0]
        else:
            q = torch.cat([qzz[0].repeat(nb), qzz[1], qzz[1]])
            sep = tables.get("sep")
            if sep is None:
                sep = torch.from_numpy(k1_dct.separable_operator(
                    *k1_dct.build_operators(layout, tables["qnat"])[:2]))
            self.register_buffer("sep", sep.contiguous().to(dev))
        self.register_buffer(
            "kdct", torch.from_numpy(np.ascontiguousarray(_KDCT_ZZ)).to(dev))
        self.register_buffer("q", q.contiguous().to(dev))
        for name in ("qnat", "ac_rows", "dc_rows", "misc"):
            self.register_buffer(name, tables[name].contiguous().to(dev))
        sp = make_symbol_plan(layout)
        self.register_buffer("prev_same", torch.from_numpy(
            sp.prev_same.astype(np.int64)).to(dev))
        for name in ("dc_tab", "ac_tab", "valid"):
            self.register_buffer(name, torch.from_numpy(
                getattr(sp, name).astype(np.int32)).to(dev))
        self.register_buffer("scan_gather", torch.from_numpy(
            make_scan_gather(layout).astype(np.int64)).to(dev))
        #: adaptive length (u32 words) of the speculative one-copy fetch;
        #: the plan is shared through get_plan's cache, so the guess is read
        #: and written under a lock (each fetch keeps its own copy, k)
        self.prefix_guess = 1024
        self._guess_lock = threading.Lock()

    @property
    def standard_tables(self) -> tuple:
        """The plan's own packed Huffman tables (shared by every image)."""
        return self.ac_rows, self.dc_rows, self.misc

    def merge(self, buf, bits, cap_u: int, w_blk: int):
        """Per-block words -> the merge tail (kernel B with the compaction)
        -> (wstream, nbits, ovf): the shared tail of both paths."""
        return seg_merge.fused_merge(buf, bits, self.layout.n_segments, w_blk,
                                     cap_u // 4, self.walign)

    def forward(self, imgs: torch.Tensor, cap_u: int, w_blk: int):
        """[B, H, W, 3] (gray: [B, H, W]) u8 on the plan's device ->
        (wstream [B, cap_u/4] int32, nbits [B, n_seg] int32, ovf [B] bool),
        coded with the plan's tables."""
        buf, bits = k1a_fused.fused_pixels_to_pack(
            imgs, self.layout, self.kdct, self.q, self.standard_tables, w_blk)
        return self.merge(buf, bits, cap_u, w_blk)

    def zz_scan(self, imgs: torch.Tensor):
        """Float pass 1 without the histogram: (scan-ordered zigzag blocks
        [B, S, 64] int16, S padded to whole segments, and their DC
        differences [B, S] int32); both stay on the device for pass 2."""
        zz = k1_dct.fused_pixels_to_scan(
            imgs, self.layout, self.kdct, self.q,
            sep=None if self.layout.is_gray else self.sep)
        return zz, block_pack.slot_metadata(self.prev_same, zz)

    def zz_islow(self, imgs: torch.Tensor):
        """The same from the libjpeg-exact integer pipeline (ops/islow.py,
        engine.py:331-335): raster blocks -> scan gather -> int16. A pad
        slot repeats block 0; its valid flag is 0, so it codes to nothing."""
        zz = islow.image_to_zigzag_islow(imgs, self.layout, self.qnat)
        zz = zz.index_select(1, self.scan_gather).to(torch.int16)
        return zz, block_pack.slot_metadata(self.prev_same, zz)

    def histogram(self, zz: torch.Tensor, dcdiff: torch.Tensor):
        """Per-image symbol histogram [B, 2, 2, 256] int32."""
        return entropy.symbol_histogram(zz, dcdiff, self.ac_tab, self.dc_tab,
                                        self.valid)

    def zz_and_histogram(self, imgs: torch.Tensor, islow: bool = False):
        """Optimize-mode pass 1 (engine.py:337-341, :502-505): zz_scan (islow:
        zz_islow) and the histogram of its blocks. The span `jpgenc.pass1`
        covers both; on the card both are launches that do not wait for the
        device (the wait is optimized_tables' `jpgenc.hist_wait`)."""
        with span("jpgenc.pass1"):
            zz, dcdiff = (self.zz_islow if islow else self.zz_scan)(imgs)
            return zz, dcdiff, self.histogram(zz, dcdiff)

    def optimized_tables(self, hist: torch.Tensor):
        """Between the passes, on the host: the histogram [B, 2, 2, 256] ->
        ([(dc_tables, ac_tables)] per image, for the headers, and the same
        as packed tables with a leading image dimension on the plan's
        device, for pass 2). The wait for the histogram's copy is the span
        `jpgenc.hist_wait`, the table build and its upload `jpgenc.tables`."""
        n_tabs = 1 if self.layout.is_gray else 2
        with span("jpgenc.hist_wait"):
            freqs = to_host_async(hist).wait()
        with span("jpgenc.tables"):
            per_img = [tables_from_freq(f, n_tabs) for f in freqs]
            return per_img, device_tables(*zip(*per_img), self.q.device)

    def entropy_from_zz(self, zz: torch.Tensor, dcdiff: torch.Tensor, tables,
                        cap_u: int, w_blk: int):
        """Optimize-mode pass 2 (engine.py:227-261, :470-476): pass 1's zz
        [B, n_slots, 64] int16 and dcdiff [B, n_slots], and Huffman tables
        (packed_tables on the plan's device, shared or one set per image)
        -> as forward."""
        buf, bits = block_pack.fused_block_pack(
            zz, dcdiff, self.ac_tab, self.dc_tab, self.valid, tables, w_blk)
        return self.merge(buf, bits, cap_u, w_blk)

    def start_fetch(self, outs) -> tuple[HostCopy, int]:
        """Start the one host copy of (stream prefix, nbits, ovf) of a
        batch's outputs at the adaptive guess and return (handle, k) for
        fetch(started=...): a caller with several batches in flight starts
        every copy before it waits on any."""
        wstream, nbits, ovf = outs
        with self._guess_lock:
            guess = self.prefix_guess
        return combined_fetch(wstream, nbits, ovf, guess)

    def fetch(self, outs, cap_u: int, started=None):
        """One host copy of (stream prefix, nbits, ovf) for every image
        (started: start_fetch's result, else it starts here), refetching
        the prefix only when the adaptive guess fell short; both copies go
        through to_host_async. Returns [(u_words, nbits, ok)] per image; ok
        is False when the image overflowed its block tier or the stream
        capacity. The waits are the spans `jpgenc.fetch_wait` and
        `jpgenc.refetch_wait`."""
        wstream, nbits, ovf = outs
        handle, k = started or self.start_fetch(outs)
        with span("jpgenc.fetch_wait"):
            arr = handle.wait()
        up, nb, ov = split_fetch(arr, k, nbits.shape[-1])
        need = pack.seg_nwords_aligned(nb.astype(np.int64),
                                       self.walign).sum(axis=-1)
        ok = ~ov & (need <= cap_u // 4)
        t = int(need[ok].max()) if ok.any() else 0
        if t > k:
            with span("jpgenc.refetch_wait"):
                up = to_host_async(wstream[:, :t]).wait()
        with self._guess_lock:
            self.prefix_guess = max(t, 1024)
        return [(up[i], nb[i], bool(ok[i])) for i in range(len(nb))]

    def finalize(self, outs, cap_u: int, rst=None, started=None,
                 heads=None, tail: bytes = b"") -> list[bytes | None]:
        """fetch + host finalize: the entropy-coded scan (stuffed, no
        markers) per image; None for an image that overflowed this tier.
        heads (one bytes a image) and tail frame each scan in the same
        bytes object: with the file's headers and EOI, a whole file.

        rst gives, per image, (first_rst, n_rst, n_seg_keep) for stripe
        sub-images of a larger scan: keep the first n_seg_keep segments
        (a ragged tail drops its padding-row segments; the stream is
        segment-ordered, so a prefix is exact), and write RSTn after the
        first n_rst of them, numbered from first_rst. The default is a
        whole image: (0, n_segments - 1, n_segments). The host finalize,
        the fetch excluded, is the span `jpgenc.finalize_host`."""
        fetched = self.fetch(outs, cap_u, started)
        out = []
        with span("jpgenc.finalize_host"):
            for i, (up, nb, ok) in enumerate(fetched):
                first, n_rst, keep = (0, len(nb) - 1, len(nb)) \
                    if rst is None else rst[i]
                out.append(finalize_host_w(
                    up, nb[:keep], first, n_rst, self.walign,
                    b"" if heads is None else heads[i], tail) if ok else None)
        return out


@functools.lru_cache(maxsize=16)
def _cached_plan(height: int, width: int, subsampling: str, quality: int,
                 device: str, restart_interval: int) -> EncodePlan:
    luts = luts_from_tables(*ref_encoder.standard_tables())
    tables = tables_from_reference(qtables_for_quality(quality), luts.dc,
                                   luts.ac)
    return EncodePlan(L.make_layout(height, width, subsampling,
                                    restart_interval), tables, device)


def get_plan(height: int, width: int, subsampling: str, quality: int,
             device: str, restart_interval: int = 0) -> EncodePlan:
    """Cached plan for one geometry, quality, device and restart interval
    (MCUs per segment, 0: one segment), with the standard Annex K tables.
    subsampling is "gray" for single-component frames."""
    return _cached_plan(height, width, subsampling, quality, device,
                        restart_interval)


def as_device_batch(imgs, device: torch.device) -> torch.Tensor:
    """[B, H, W, 3] RGB or [B, H, W] gray: numpy uint8 (uploaded) or a uint8
    tensor already on `device` (used as is: the device-resident producer
    interface). device: as resolve_device returns it."""
    if isinstance(imgs, torch.Tensor):
        if imgs.device != device:
            raise ValueError(f"tensor input lives on {imgs.device}, not on "
                             f"{device}")
        t = imgs
    else:
        t = torch.from_numpy(np.ascontiguousarray(imgs)).to(device)
    if t.dtype != torch.uint8:
        raise ValueError("image must be uint8")
    if not (t.dim() == 3 or (t.dim() == 4 and t.shape[-1] == 3)):
        raise ValueError(f"expected [B, H, W, 3] RGB or [B, H, W] gray, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def device_tables(dc_tables, ac_tables, device) -> tuple:
    """Per-image optimized HuffTable lists (one (dc, ac) pair of lists per
    image) -> packed_tables with a leading image dimension, on `device`."""
    luts = [luts_from_tables(dc, ac) for dc, ac in zip(dc_tables, ac_tables)]
    stacked = EntropyLUTs(dc=np.stack([x.dc for x in luts]),
                          ac=np.stack([x.ac for x in luts]))
    return tuple(t.to(device) for t in packed_tables(stacked))


class EncodeJob:
    """One device entry's share of an encode, from pixels (or given
    coefficients) to files: the order of the encode, written once for
    api.encode, mesh.encode_batch and mesh.encode_striped.

      first_pass()   the fused K1A + merge tail at tiers[0] with its fetch
                     started, or pass 1's cached coefficients (K1 rows or
                     the islow pipeline; with optimize, their histogram)
      second_pass()  tables(), then, from cached coefficients, kernel A +
                     merge tail at tiers[0] with its fetch started
      finish()       fetch + host finalize at tiers[0]: one file a row,
                     None where a row overflowed
      climb(j, ladder)  row j alone again, up the caller's ladder

    A caller with several jobs runs each step over all of them before the
    next, so that every entry's kernels and fetch are enqueued before any
    entry waits. tiers is tiers_for(plan.layout, quality); one image climbs
    tiers[1:] (file()), a batch's overflowed row goes to tiers[-1], the
    worst tier, at once.

    x: the rows' pixels on the plan's device; zz instead: their
    scan-ordered zigzag coefficients ([B, S, 64] int16, as pass 1 leaves
    them), coded by kernel A. rst: per row, (first_rst, n_rst, n_seg_keep)
    for stripes of a larger scan (EncodePlan.finalize), which the caller
    frames; otherwise each row is a whole file, headers to EOI."""

    def __init__(self, plan, cfg, x=None, zz=None, rst=None):
        self.plan, self.cfg, self.x, self.zz, self.rst = plan, cfg, x, zz, rst
        self.n = len(x if x is not None else zz)
        self.tiers = tiers_for(plan.layout, cfg.quality)
        self.dcdiff = self.hist = self.tabs = self.heads = None
        self.outs = self.started = None

    def first_pass(self) -> None:
        """Enqueue pass 1; nothing here waits for the device."""
        plan, x = self.plan, self.x
        if x is None:
            self.dcdiff = block_pack.slot_metadata(plan.prev_same, self.zz)
            if self.cfg.optimize_huffman:
                self.hist = plan.histogram(self.zz, self.dcdiff)
        elif self.cfg.optimize_huffman:
            self.zz, self.dcdiff, self.hist = plan.zz_and_histogram(
                x, self.cfg.dct_method == "islow")
        elif self.cfg.dct_method == "islow":
            self.zz, self.dcdiff = plan.zz_islow(x)
        else:
            self.outs = plan(x, *self.tiers[0])
            self.started = plan.start_fetch(self.outs)

    def tables(self, shared=None) -> None:
        """Pass 2's Huffman tables and each row's headers: `shared` (packed
        tables, one set for all rows: the stripes of one scan, whose file
        the caller heads), else with optimize each image's own
        (optimized_tables: waits for the histogram), else the plan's
        standard set."""
        lay, q = self.plan.layout, self.cfg.quality
        if shared is not None:
            self.tabs = tuple(t.to(self.plan.q.device) for t in shared)
        elif self.cfg.optimize_huffman:
            per_img, self.tabs = self.plan.optimized_tables(self.hist)
            self.heads = [jfif_headers(lay, q, dc, ac) for dc, ac in per_img]
        else:
            self.tabs = self.plan.standard_tables
            self.heads = [jfif_headers(lay, q)] * self.n

    def second_pass(self, shared=None) -> None:
        """tables(shared), then pass 2 from the cached coefficients with its
        fetch started (the fused pass coded the rows already)."""
        self.tables(shared)
        if self.zz is not None:
            self.outs = self.plan.entropy_from_zz(
                self.zz, self.dcdiff, self.tabs, *self.tiers[0])
            self.started = self.plan.start_fetch(self.outs)

    def _finalize(self, outs, cap_u: int, rows: slice, started=None):
        if self.rst is not None:
            return self.plan.finalize(outs, cap_u, self.rst[rows], started)
        return self.plan.finalize(outs, cap_u, started=started,
                                  heads=self.heads[rows], tail=EOI)

    def finish(self) -> list[bytes | None]:
        """Fetch and finalize the rows coded at tiers[0]."""
        return self._finalize(self.outs, self.tiers[0][0], slice(None),
                              self.started)

    def recode(self, j: int, cap_u: int, w_blk: int) -> bytes | None:
        """Row j alone at (cap_u, w_blk): from the cached coefficients with
        row j's own tables where they are per image, else from its pixels;
        None if it overflows."""
        plan, r = self.plan, slice(j, j + 1)
        if self.zz is not None:
            tabs = tuple(t[r] for t in self.tabs) \
                if self.tabs[0].dim() == 3 else self.tabs
            outs = plan.entropy_from_zz(self.zz[r], self.dcdiff[r], tabs,
                                        cap_u, w_blk)
        else:
            outs = plan(self.x[r], cap_u, w_blk)
        return self._finalize(outs, cap_u, r)[0]

    def climb(self, j: int, ladder) -> bytes:
        """Row j recoded at each tier of `ladder` until one holds it."""
        for tier in ladder:
            out = self.recode(j, *tier)
            if out is not None:
                return out
        raise RuntimeError(OVERFLOW)

    def file(self) -> bytes:
        """The job's one image as a file (api.encode): the passes at
        tiers[0], then, while it overflows, the image again up tiers[1:]."""
        self.first_pass()
        self.second_pass()
        out = self.finish()[0]
        return out if out is not None else self.climb(0, self.tiers[1:])
