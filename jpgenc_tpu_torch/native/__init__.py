"""Native host tier: C++ scan codec bound via ctypes (copy of
jpgenc_tpu/native/__init__.py with the port's own build rule).

`csrc/scan_codec.cpp` is compiled with g++ at first use into the git-ignored
`jpgenc_tpu_torch/_build/`, under a name that hashes the source and the
flags (as kernels/build.py names the CUDA library), so a library built from
other sources is never loaded under a changed C interface and nothing is
ever written into the reference package's directory. Falls back cleanly
(``LIB is None``) when no compiler is available so the pure-Python paths
keep working; chip_smoke.py treats that as a failure on the GPU's machine.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "scan_codec.cpp")
_BUILD = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

LIB = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libscan_codec_{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    """Path of the built library, or None when it cannot be built."""
    try:
        so = library_path()
        if os.path.exists(so):
            return so
        os.makedirs(_BUILD, exist_ok=True)
        # build to a temp file then rename, so concurrent importers never
        # dlopen a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        r = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            os.unlink(tmp)
            return None
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


_LOAD_FAILED = False


def _load():
    global LIB, _LOAD_FAILED
    if LIB is not None:
        return LIB
    if _LOAD_FAILED:
        return None
    try:
        return _load_inner()
    except OSError:
        # e.g. a foreign-architecture .so: fall back to pure Python
        _LOAD_FAILED = True
        return None


def _load_inner():
    global LIB
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.decode_scan.restype = ctypes.c_int
    lib.decode_scan.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int,
        i32p, i32p, ctypes.c_int64,
        i32p, i32p,
        u8p, u8p, u8p, u8p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        i32p,
    ]
    lib.finalize_wcompact.restype = ctypes.c_int64
    lib.finalize_wcompact.argtypes = [
        u8p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p,
    ]
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.decode_scan_sparse.restype = ctypes.c_int64
    lib.decode_scan_sparse.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int,
        i32p, i32p, ctypes.c_int64,
        i32p, i32p,
        u8p, u8p, u8p, u8p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, i32p, i16p,
    ]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.decode_scan_packed.restype = ctypes.c_int64
    lib.decode_scan_packed.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int,
        i32p, i32p, ctypes.c_int64,
        i32p, i32p,
        u8p, u8p, u8p, u8p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64,
        u8p, i32p, i16p, i64p,
    ]
    lib.optimize_tables.restype = ctypes.c_int
    lib.optimize_tables.argtypes = [i64p, i32p, i32p]
    LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _pack_tables(tabs):
    """HuffTable sequence (indexed by table id, None = slot not defined in
    the file) -> flat (bits [4*16], vals [4*256]) u8 rows. T.81 allows Th
    0-3 in baseline files; an undefined slot stays all-zero (an empty
    decoder — callers validate referenced ids against the tables actually
    present, so it is never consulted)."""
    bits = np.zeros((4, 16), np.uint8)
    vals = np.zeros((4, 256), np.uint8)
    for i, t in enumerate(tabs[:4]):
        if t is None:
            continue
        b = np.asarray(t.bits, np.uint8)
        v = np.asarray(t.vals, np.uint8)
        bits[i, :b.size] = b
        vals[i, :v.size] = v
    return bits.reshape(-1), vals.reshape(-1)


def decode_scan_packed(scan_data: bytes, layout, comp_dc_tab, comp_ac_tab,
                       dc_tables, ac_tables, n_threads: int = 0
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Entropy-decode a stuffed scan to the PACKED 2-byte-per-coefficient
    form: (main [n, 2] u8 rows of (delta, val_s8), exception flat indices
    int32, exception values int16). The minimal host->device decode upload:
    idx = cumsum(delta) - 1; values |v| > 127 are escaped into the
    exception list (scattered second on device, overwriting the -128
    escape byte); gaps > 255 are bridged by harmless (255, 0) phantoms.
    n_threads: segment-parallel workers over restart segments (0 = auto,
    engaged only for large scans; 1 = serial — batch paths pass 1); the
    merged stream is identical to the serial walk's. Returns None when the
    native library is unavailable or a capacity heuristic overflows
    (callers fall back to the pair/dense forms)."""
    lib = _load()
    if lib is None:
        return None
    dc_bits, dc_vals = _pack_tables(dc_tables)
    ac_bits, ac_vals = _pack_tables(ac_tables)
    data = np.frombuffer(scan_data, np.uint8)
    # nonzeros bound (>= 2 bits each) + malformed-padding slack + phantom
    # bound (one per 255 scan positions — the delta chain lives in scan-
    # position space)
    cap_main = 4 * data.size + 8 + 128 * layout.n_segments \
        + layout.n_scan * 64 // 255 + 8
    cap_exc = 2 * data.size + 8 + 128 * layout.n_segments
    main = np.empty(cap_main * 2, np.uint8)
    eidx = np.empty(cap_exc, np.int32)
    eval_ = np.empty(cap_exc, np.int16)
    n_exc = np.zeros(1, np.int64)
    n = lib.decode_scan_packed(
        data, data.size, len(layout.comps),
        np.ascontiguousarray(layout.scan_comp, np.int32),
        np.ascontiguousarray(layout.scan_flat, np.int32),
        layout.n_scan,
        np.asarray(comp_dc_tab, np.int32), np.asarray(comp_ac_tab, np.int32),
        dc_bits, dc_vals, ac_bits, ac_vals,
        layout.blocks_per_segment, layout.n_segments, n_threads,
        cap_main, cap_exc, main, eidx, eval_, n_exc)
    if n == -9:
        return None          # capacity heuristic exceeded: pair fallback
    if n < 0:
        raise ValueError(f"native scan decode failed (code {n})")
    ne = int(n_exc[0])
    # copies, not views: a view would pin the worst-case-sized cap buffers
    # (~20x the real bytes) for as long as the caller holds the result —
    # decode_batch holds every frame's packed stream at once
    return (main[:2 * n].reshape(n, 2).copy(), eidx[:ne].copy(),
            eval_[:ne].copy())


def decode_scan(scan_data: bytes, layout, comp_dc_tab, comp_ac_tab,
                dc_tables, ac_tables, n_threads: int = 0
                ) -> np.ndarray | None:
    """Entropy-decode a full stuffed scan (with RSTn) -> [n_total, 64] int32.

    dc_tables/ac_tables: sequences of HuffTable (.bits [16] counts, .vals
    symbols in code order) indexed by table id. n_threads: segment-parallel
    workers over restart segments (0 = one per core, capped by segment
    count and scan size; 1 = serial). Returns None if the native library is
    unavailable; raises ValueError on malformed streams.
    """
    lib = _load()
    if lib is None:
        return None

    dc_bits, dc_vals = _pack_tables(dc_tables)
    ac_bits, ac_vals = _pack_tables(ac_tables)
    data = np.frombuffer(scan_data, np.uint8)
    n_total = sum(c.n_blocks for c in layout.comps)
    out = np.zeros(n_total * 64, np.int32)
    rc = lib.decode_scan(
        data, data.size, len(layout.comps),
        np.ascontiguousarray(layout.scan_comp, np.int32),
        np.ascontiguousarray(layout.scan_flat, np.int32),
        layout.n_scan,
        np.asarray(comp_dc_tab, np.int32), np.asarray(comp_ac_tab, np.int32),
        dc_bits, dc_vals, ac_bits, ac_vals,
        layout.blocks_per_segment, layout.n_segments, n_threads,
        out)
    if rc != 0:
        raise ValueError(f"native scan decode failed (code {rc})")
    return out.reshape(n_total, 64)


def optimize_tables(freq: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Histogram -> (BITS, HUFFVAL) via the C++ T.81 K.2 procedure.

    Exact port of jpgenc_tpu_torch.huffman's Python implementation (equality-tested
    in tests/test_native.py); ~100x faster, which matters for per-image
    optimized tables at batch scale (4 builds/image). Returns None when the
    native library is unavailable or reports an inconsistency.
    """
    lib = _load()
    if lib is None:
        return None
    freq = np.ascontiguousarray(freq, np.int64)
    bits = np.zeros(16, np.int32)
    vals = np.zeros(256, np.int32)
    n = lib.optimize_tables(freq, bits, vals)
    if n < 0:
        return None
    return bits, vals[:n]


_scratch = threading.local()


def _out_buffer(n: int) -> np.ndarray:
    """This thread's finalize buffer, at least n bytes. It is kept from call
    to call (grown to the largest file the thread has made), so the stuffing
    writes into memory already mapped and the one copy out of it is the
    returned bytes."""
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.size < n:
        buf = _scratch.buf = np.empty(n, np.uint8)
    return buf


def finalize_wcompact(u: np.ndarray, seg_nbits: np.ndarray,
                      first_rst: int, n_rst: int, walign: int,
                      head: bytes = b"", tail: bytes = b"") -> bytes | None:
    """Word-compact device stream (LE u32 memory image = byte stream) ->
    head + stuffed scan with RSTn joins + tail. u: the downloaded u32 buffer
    viewed or passed as bytes; seg_nbits: per-segment bit counts; walign:
    the layout's wcompact chunk width (ops.pack.walign_for); head and tail
    (a file's headers and EOI) are written around the scan in the same
    buffer."""
    lib = _load()
    if lib is None:
        return None
    u = np.ascontiguousarray(u).view(np.uint8)
    seg_nbits = np.ascontiguousarray(seg_nbits, np.int32)
    n_seg = seg_nbits.size
    total = int(((seg_nbits.astype(np.int64) + 7) >> 3).sum())
    h = len(head)
    out = _out_buffer(h + 2 * total + 2 * n_seg + 2 + len(tail))
    out[:h] = np.frombuffer(head, np.uint8)
    end = h + lib.finalize_wcompact(u, seg_nbits, n_seg, first_rst, n_rst,
                                    walign, out[h:])
    out[end:end + len(tail)] = np.frombuffer(tail, np.uint8)
    return out[:end + len(tail)].tobytes()


def decode_scan_sparse(scan_data: bytes, layout, comp_dc_tab, comp_ac_tab,
                       dc_tables, ac_tables, n_threads: int = 0
                       ) -> tuple[np.ndarray, np.ndarray] | None:
    """Entropy-decode a stuffed scan directly to the SPARSE coefficient form
    (flat idx int32, value int16) — what the device decode path uploads;
    skips the dense [n_total, 64] materialization entirely. n_threads:
    segment-parallel workers over restart segments (0 = one per core,
    capped by segment count and scan size; 1 = serial); the emitted pair
    order is segment order either way. Returns None if
    the native library is unavailable OR the capacity heuristic overflows
    (malformed multi-segment streams can decode coefficients from the
    bit-reader's zero padding, beyond the 2-bits-per-coefficient bound of
    well-formed data) — callers then fall back to the dense path, keeping
    behavior identical between the two. Raises ValueError on malformed
    streams the dense decoder would also reject."""
    lib = _load()
    if lib is None:
        return None

    dc_bits, dc_vals = _pack_tables(dc_tables)
    ac_bits, ac_vals = _pack_tables(ac_tables)
    data = np.frombuffer(scan_data, np.uint8)
    # well-formed data costs >= 2 bits/coefficient; + slack for per-segment
    # zero-fill padding a malformed stream can decode (~16 bytes/segment)
    cap = 4 * data.size + 8 + 128 * layout.n_segments
    idx = np.empty(cap, np.int32)
    val = np.empty(cap, np.int16)
    n = lib.decode_scan_sparse(
        data, data.size, len(layout.comps),
        np.ascontiguousarray(layout.scan_comp, np.int32),
        np.ascontiguousarray(layout.scan_flat, np.int32),
        layout.n_scan,
        np.asarray(comp_dc_tab, np.int32), np.asarray(comp_ac_tab, np.int32),
        dc_bits, dc_vals, ac_bits, ac_vals,
        layout.blocks_per_segment, layout.n_segments, n_threads,
        cap, idx, val)
    if n == -9:
        return None          # capacity heuristic exceeded: dense fallback
    if n < 0:
        raise ValueError(f"native scan decode failed (code {n})")
    return idx[:n], val[:n]
