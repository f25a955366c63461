"""Huffman code-table machinery (host side).

- `build_codes`: BITS/HUFFVAL -> canonical (code, length) per symbol, T.81 section C.
- `optimize_tables`: symbol histogram -> length-limited (<=16 bit) BITS/HUFFVAL via the
  T.81 Annex K.2 adjust-BITS procedure (the same algorithm libjpeg implements in
  `jpeg_gen_optimal_table`), reserving the all-ones codeword (SURVEY.md section 8 item 4).

These run on host: inputs are tiny (256-bin histograms / <=162-symbol tables).
Frozen copy for the benchmark's reference: the pure-Python Annex K.2
procedure only, with no native dispatch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_CODE_LEN = 16


@dataclass(frozen=True)
class HuffTable:
    """One Huffman table: spec form (bits/vals) plus dense encode LUTs."""

    bits: np.ndarray      # [16] int32, count of codes per length 1..16
    vals: np.ndarray      # [n]  int32, symbols in code order
    code: np.ndarray      # [256] uint32, code for symbol s (0 if absent)
    length: np.ndarray    # [256] int32, code length for symbol s (0 if absent)

    @property
    def nsymbols(self) -> int:
        return int(self.vals.size)


def build_codes(bits: np.ndarray, vals: np.ndarray) -> HuffTable:
    """Canonical Huffman code assignment (T.81 sections C.1-C.3, Figures C.1/C.2)."""
    bits = np.asarray(bits, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.int32)
    if bits.shape != (16,):
        raise ValueError("bits must have shape (16,)")
    if int(bits.sum()) != vals.size:
        raise ValueError("sum(bits) must equal len(vals)")

    code = np.zeros(256, dtype=np.uint32)
    length = np.zeros(256, dtype=np.int32)
    c = 0
    k = 0
    for l in range(1, MAX_CODE_LEN + 1):
        for _ in range(int(bits[l - 1])):
            sym = int(vals[k])
            if length[sym] != 0:
                raise ValueError(f"duplicate symbol {sym} in HUFFVAL")
            if c >= (1 << l):
                raise ValueError("BITS table overfull: code overflow")
            code[sym] = c
            length[sym] = l
            c += 1
            k += 1
        c <<= 1
    return HuffTable(bits=bits, vals=vals, code=code, length=length)


def optimize_tables(freq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Histogram -> (BITS, HUFFVAL), lengths limited to 16 bits.

    Implements the T.81 Annex K.2 procedure (Figures K.1-K.4): repeated merge of
    the two least-frequent non-zero entries chaining code sizes, then ADJUST_BITS
    to push lengths above 16 back down, then symbol sort. A phantom 257th symbol
    with count 1 reserves the all-ones code so real symbols never get it
    (decoder-robustness convention shared with libjpeg).

    freq: [256] nonneg int counts. Returns (bits[16], vals[n]).
    """
    freq = np.asarray(freq, dtype=np.int64)
    if freq.shape != (256,):
        raise ValueError("freq must have shape (256,)")
    return _optimize_tables_py(freq)


def _optimize_tables_py(freq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pure-Python/NumPy reference implementation of optimize_tables."""
    f = np.zeros(257, dtype=np.int64)
    f[:256] = freq
    f[256] = 1  # reserved: guarantees the all-ones code is never assigned

    codesize = np.zeros(257, dtype=np.int64)
    others = np.full(257, -1, dtype=np.int64)

    big = np.iinfo(np.int64).max
    while True:
        # find two least-frequent nonzero entries (ties: highest symbol value,
        # matching libjpeg so optional golden comparisons line up).
        # Vectorized — the scalar scan made this loop the batch-mode
        # bottleneck (4 tables x O(256 merges x 257) Python steps per image).
        masked = np.where(f > 0, f, big)
        m1 = masked.min()
        if m1 == big:
            break
        c1 = int(np.flatnonzero(masked == m1)[-1])
        masked[c1] = big
        m2 = masked.min()
        if m2 == big:
            break
        c2 = int(np.flatnonzero(masked == m2)[-1])

        f[c1] += f[c2]
        f[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1

    # count codes per length (may exceed 16 at this point)
    max_size = int(codesize.max()) if codesize.max() > 0 else 0
    counts = np.zeros(max(max_size, MAX_CODE_LEN) + 1, dtype=np.int64)
    for i in range(257):
        if codesize[i] > 0:
            counts[codesize[i]] += 1

    # ADJUST_BITS (T.81 Figure K.3): fold lengths > 16 down
    i = int(counts.size - 1)
    while i > MAX_CODE_LEN:
        while counts[i] > 0:
            j = i - 2
            while counts[j] == 0:
                j -= 1
            counts[i] -= 2
            counts[i - 1] += 1
            counts[j + 1] += 2
            counts[j] -= 1
        i -= 1
    # remove the reserved symbol's code from the longest used length
    while counts[i] == 0:
        i -= 1
    counts[i] -= 1

    bits = np.zeros(MAX_CODE_LEN, dtype=np.int32)
    bits[: min(i, MAX_CODE_LEN)] = counts[1 : min(i, MAX_CODE_LEN) + 1]
    # SORT_INPUT (T.81 Figure K.4): symbols ordered by their ORIGINAL code
    # size (which may exceed 16 before ADJUST_BITS — those symbols still get
    # codes, at the shortened lengths BITS now describes), then by value
    order = []
    for size in range(1, int(max(codesize.max(), 1)) + 1):
        for sym in range(256):
            if codesize[sym] == size:
                order.append(sym)
    vals = np.array(order, dtype=np.int32)
    if int(bits.sum()) != vals.size:
        raise AssertionError("optimize_tables: bits/vals inconsistency")
    return bits, vals


def magnitude_category(v: np.ndarray) -> np.ndarray:
    """SSSS = number of bits needed for |v| (T.81 Tables F.1/F.2). Vectorized."""
    v = np.abs(np.asarray(v, dtype=np.int64))
    ssss = np.zeros(v.shape, dtype=np.int32)
    nz = v > 0
    ssss[nz] = np.floor(np.log2(v[nz])).astype(np.int32) + 1
    return ssss


def magnitude_bits(v: np.ndarray, ssss: np.ndarray) -> np.ndarray:
    """Amplitude bits: v>=0 -> v; v<0 -> one's complement in SSSS bits (T.81 F.1.2.1)."""
    v = np.asarray(v, dtype=np.int64)
    return np.where(v >= 0, v, v + (1 << ssss.astype(np.int64)) - 1).astype(np.int64)
