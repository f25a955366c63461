"""JPEG constant tables: ITU-T T.81 Annex K data, zigzag maps, IJG quality scaling.

Capability parity: reference `Nuos/jpgEnc` layer A (SURVEY.md section 2, component #1).
The reference mount is empty (SURVEY.md section 0); every constant below is fixed by
the JPEG standard (ITU-T T.81 / ISO-IEC 10918-1 Annex K) and was byte-verified against
libjpeg-turbo output (SURVEY.md Appendix A.2-A.5).

All tables here are plain numpy (host-side, frozen); device code lifts them to
tensors. Frozen copy for the benchmark's reference.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Zigzag scan (T.81 Figure 5 / section A.3.6).
# ZIGZAG[k] = natural (row-major) index of the k-th element in zigzag order.
# ---------------------------------------------------------------------------
ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# INV_ZIGZAG[n] = zigzag position of natural index n (so a[ZIGZAG] scatter-inverse).
INV_ZIGZAG = np.zeros(64, dtype=np.int32)
INV_ZIGZAG[ZIGZAG] = np.arange(64, dtype=np.int32)

# ---------------------------------------------------------------------------
# Annex K quantization tables, NATURAL (row-major) order.
# DQT marker payloads are written in ZIGZAG order (classic trap — SURVEY.md A.2).
# ---------------------------------------------------------------------------
QTABLE_LUMA = np.array([
    16, 11, 10, 16,  24,  40,  51,  61,
    12, 12, 14, 19,  26,  58,  60,  55,
    14, 13, 16, 24,  40,  57,  69,  56,
    14, 17, 22, 29,  51,  87,  80,  62,
    18, 22, 37, 56,  68, 109, 103,  77,
    24, 35, 55, 64,  81, 104, 113,  92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103,  99,
], dtype=np.int32)

QTABLE_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)


def scale_qtable(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling, verified against libjpeg for Q in {10..95} (SURVEY.md A.4).

    quality in [1, 100]; Q=50 is identity. Returns int32 natural-order table.
    """
    q = int(quality)
    if not 1 <= q <= 100:
        raise ValueError(f"quality must be in [1, 100], got {quality}")
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = (base.astype(np.int64) * scale + 50) // 100
    return np.clip(out, 1, 255).astype(np.int32)


# ---------------------------------------------------------------------------
# Annex K Huffman table specs: (BITS[1..16], HUFFVAL) — T.81 Tables K.3-K.6.
# BITS[i] = number of codes of length i+1; HUFFVAL = symbols in code order.
# ---------------------------------------------------------------------------
DC_LUMA_BITS = np.array([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], np.int32)
DC_LUMA_VALS = np.arange(12, dtype=np.int32)

DC_CHROMA_BITS = np.array([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], np.int32)
DC_CHROMA_VALS = np.arange(12, dtype=np.int32)

AC_LUMA_BITS = np.array([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], np.int32)
AC_LUMA_VALS = np.array([
      1,   2,   3,   0,   4,  17,   5,  18,  33,  49,  65,   6,  19,  81,  97,   7,
     34, 113,  20,  50, 129, 145, 161,   8,  35,  66, 177, 193,  21,  82, 209, 240,
     36,  51,  98, 114, 130,   9,  10,  22,  23,  24,  25,  26,  37,  38,  39,  40,
     41,  42,  52,  53,  54,  55,  56,  57,  58,  67,  68,  69,  70,  71,  72,  73,
     74,  83,  84,  85,  86,  87,  88,  89,  90,  99, 100, 101, 102, 103, 104, 105,
    106, 115, 116, 117, 118, 119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137,
    138, 146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167,
    168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197,
    198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225, 226,
    227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245, 246, 247, 248,
    249, 250,
], dtype=np.int32)

AC_CHROMA_BITS = np.array([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], np.int32)
AC_CHROMA_VALS = np.array([
      0,   1,   2,   3,  17,   4,   5,  33,  49,   6,  18,  65,  81,   7,  97, 113,
     19,  34,  50, 129,   8,  20,  66, 145, 161, 177, 193,   9,  35,  51,  82, 240,
     21,  98, 114, 209,  10,  22,  36,  52, 225,  37, 241,  23,  24,  25,  26,  38,
     39,  40,  41,  42,  53,  54,  55,  56,  57,  58,  67,  68,  69,  70,  71,  72,
     73,  74,  83,  84,  85,  86,  87,  88,  89,  90,  99, 100, 101, 102, 103, 104,
    105, 106, 115, 116, 117, 118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135,
    136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165,
    166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195,
    196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246, 247, 248,
    249, 250,
], dtype=np.int32)

# AC symbol semantics (RRRRSSSS): high nibble = zero run, low nibble = magnitude
# category. T.81 section F.1.2.2.
EOB = 0x00  # end of block
ZRL = 0xF0  # run of 16 zeros

# ---------------------------------------------------------------------------
# Marker bytes (T.81 Table B.1).
# ---------------------------------------------------------------------------
M_SOI = 0xFFD8
M_EOI = 0xFFD9
M_APP0 = 0xFFE0
M_DQT = 0xFFDB
M_SOF0 = 0xFFC0
M_DHT = 0xFFC4
M_DRI = 0xFFDD
M_SOS = 0xFFDA
M_RST0 = 0xFFD0  # RSTn = 0xFFD0 + (n mod 8)
