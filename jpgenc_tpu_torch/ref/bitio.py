"""Host bit-level IO for the reference encoder and the scan decoder.

MSB-first bit packing with 1-bit padding at byte alignment and FF->FF00 byte
stuffing (T.81 section F.1.2.3). SURVEY.md components #15-#17 (reference tier).
Copy of jpgenc_tpu/ref/bitio.py.
"""
from __future__ import annotations

import numpy as np


class BitWriter:
    """MSB-first bit accumulator producing stuffed entropy bytes."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0      # bits accumulated, MSB-aligned within _nbits
        self._nbits = 0

    def put(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (int(value) & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            b = (self._acc >> self._nbits) & 0xFF
            self._bytes.append(b)
            if b == 0xFF:
                self._bytes.append(0x00)  # byte stuffing
        self._acc &= (1 << self._nbits) - 1

    def align(self) -> None:
        """Pad to byte boundary with 1-bits (T.81 F.1.2.3)."""
        if self._nbits:
            pad = 8 - self._nbits
            self.put((1 << pad) - 1, pad)

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "call align() before getvalue()"
        return bytes(self._bytes)

    @property
    def bit_length(self) -> int:
        return len(self._bytes) * 8 + self._nbits  # note: includes stuffed zeros


def stuff_bytes(raw: np.ndarray) -> bytes:
    """Vectorized FF->FF00 stuffing over already byte-aligned entropy data."""
    raw = np.asarray(raw, dtype=np.uint8)
    is_ff = raw == 0xFF
    n_ff = int(is_ff.sum())
    if n_ff == 0:
        return raw.tobytes()
    out = np.zeros(raw.size + n_ff, dtype=np.uint8)
    # output position of each input byte = index + number of FFs before it
    pos = np.arange(raw.size, dtype=np.int64) + np.cumsum(is_ff) - is_ff
    out[pos] = raw
    # stuffed zeros already in place (array initialized to 0)
    return out.tobytes()


def unstuff_bytes(data: bytes) -> np.ndarray:
    """Remove 0x00 after 0xFF in entropy data (decoder side)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size == 0:
        return arr
    drop = np.zeros(arr.size, dtype=bool)
    drop[1:] = (arr[:-1] == 0xFF) & (arr[1:] == 0x00)
    return arr[~drop]
