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
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    rows = np.ctypeslib.ndpointer(np.int64, ndim=2, flags="C_CONTIGUOUS")
    lib.finalize_wcompact_rows.restype = ctypes.c_int64
    lib.finalize_wcompact_rows.argtypes = [
        ctypes.c_int, rows, i32p, ctypes.c_int, u8p, ctypes.c_int64, u8p,
        ctypes.c_int64, ctypes.c_int, u8p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.copy_rows.restype = ctypes.c_int
    lib.copy_rows.argtypes = [ctypes.c_int, rows, u8p, u64p, ctypes.c_int]
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


# The C API's PyBytes_FromStringAndSize(NULL, n): a bytes object of n bytes
# left unwritten. Its bytes lie _BYTES_DATA bytes past its address (id), as
# PyBytes_AsString reports it.
_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_new_bytes.restype = ctypes.py_object
_new_bytes.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
_bytes_at = ctypes.pythonapi.PyBytes_AsString
_bytes_at.restype = ctypes.c_void_p
_bytes_at.argtypes = [ctypes.py_object]
_BYTES_DATA = _bytes_at(b"finalize") - id(b"finalize")

#: finalize_rows calls and the workers they used, summed (how often the
#: row-parallel finalize engages), added to under _counter_lock
finalize_calls = 0
finalize_workers = 0
_counter_lock = threading.Lock()


def finalize_rows(up: np.ndarray, nbits: np.ndarray, causes, walign: int,
                  rst=None, heads=None, tail: bytes = b"",
                  n_threads: int = 0) -> list[bytes | None] | None:
    """finalize_wcompact of a batch's rows in one native call, the rows split
    over C++ workers with the GIL released. up: [n, k] the rows' word-compact
    streams (read in place where each row's words are contiguous, as in
    engine.EncodePlan.fetch's view of its buffer); nbits: [n, n_seg] their
    segments' bit counts; causes: per row None, or why it overflowed (that
    row is None in the result). rst: per row (first_rst, n_rst,
    n_seg_keep), default (0, n_seg - 1, n_seg); heads: per row the bytes
    before its scan, tail the bytes after every scan. n_threads: 0 (what
    every caller in the package passes) sizes the workers from the batch:
    about one a MiB of scan bytes, capped by the rows and the cores, so a
    small batch stays on the calling thread, and one row goes through
    finalize_wcompact. A count fixes them (1 = the calling thread alone);
    the tests use it to reach every split of their batches, which are far
    under a MiB, whatever the host's cores.
    Returns the files in row order, or None when the native library is
    unavailable."""
    global finalize_calls, finalize_workers
    lib = _load()
    if lib is None:
        return None
    n = len(causes)
    if n == 0:
        return []
    if n == 1:
        # one row (api.encode, a retry) takes the row-at-a-time call: the
        # same core on the calling thread, with less to build than a table
        # (19 gray 512 x 512 retries a call on the H100 machine's host:
        # 6.2 ms against 7.5)
        nb = np.asarray(nbits).reshape(-1)
        first, n_rst, keep = (0, nb.size - 1, nb.size) if rst is None \
            else rst[0]
        files = [None if causes[0] is not None else finalize_wcompact(
            np.asarray(up).reshape(-1), nb[:keep], first, n_rst, walign,
            b"" if heads is None else heads[0], tail)]
        with _counter_lock:
            finalize_calls += 1
            finalize_workers += 1
        return files
    if up.ndim != 2 or up.strides[1] != up.itemsize or up.strides[0] < 0:
        up = np.ascontiguousarray(up).reshape(n, -1)
    nbits = np.ascontiguousarray(nbits, np.int32).reshape(n, -1)
    n_seg = nbits.shape[1]
    # the row table (scan_codec.cpp's FinalizeRow)
    t = np.empty((n, 9), np.int64)
    t[:, 0] = up.ctypes.data + np.arange(n) * up.strides[0]
    t[:, 1] = up.shape[1] * up.itemsize
    t[:, 2:5] = (0, n_seg - 1, n_seg) if rst is None else rst
    # a head shared by many rows (the standard tables) is held once
    heads = [b""] * n if heads is None else heads
    offset, blob, size, head_off = {}, [], 0, []
    for h in heads:
        o = offset.get(id(h))
        if o is None:
            o = offset[id(h)] = size
            blob.append(h)
            size += len(h)
        head_off.append(o)
    t[:, 5] = head_off
    t[:, 6] = np.fromiter(map(len, heads), np.int64, n)
    t[:, 8] = np.fromiter((-(c is not None) for c in causes), np.int64, n)
    args = (n, t, nbits, n_seg,
            np.frombuffer(b"".join(blob) or b"\0", np.uint8), size,
            np.frombuffer(tail or b"\0", np.uint8), len(tail), walign)
    out = _out_buffer(0)
    workers = lib.finalize_wcompact_rows(*args, out, out.size, n_threads)
    if workers < -1:            # this thread's buffer is short: grow it
        out = _out_buffer(-workers)
        workers = lib.finalize_wcompact_rows(*args, out, out.size, n_threads)
    if workers < 0:
        raise ValueError("a row's segments, stream or head lie outside what "
                         "it was given")
    with _counter_lock:
        finalize_calls += 1
        finalize_workers += workers
    # each file's own bytes object, left unwritten here and filled by the
    # same workers: the first touch of fresh memory costs a fault a page
    files = [None if k < 0 else _new_bytes(None, k) for k in t[:, 8].tolist()]
    dst = np.fromiter(map(id, files), np.uint64, n) + np.uint64(_BYTES_DATA)
    lib.copy_rows(n, t, out, dst, workers)      # skips the None rows
    return files


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
