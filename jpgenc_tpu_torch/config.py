"""Encode configuration (copy of jpgenc_tpu/config.py's EncodeConfig).

One frozen, hashable dataclass; no global flags.
"""
from __future__ import annotations

from dataclasses import dataclass

VALID_SUBSAMPLING = ("444", "422", "420")


@dataclass(frozen=True)
class EncodeConfig:
    quality: int = 75
    # chroma subsampling for color inputs ('444' | '422' | '420'); ignored for
    # grayscale inputs.
    subsampling: str = "420"
    # restart interval in MCUs (DRI value); 0 disables restart markers.
    restart_interval: int = 0
    # two-pass encode with custom Huffman tables built from the symbol histogram.
    optimize_huffman: bool = False
    # 'float': float32 DCT, one 64x64 product per block (the throughput
    # path, default); 'islow': libjpeg-exact integer pipeline — output files are
    # byte-identical to libjpeg-turbo's at matched settings (the
    # conformance mode: torch int32 ops feeding kernel A).
    dct_method: str = "float"

    def __post_init__(self):
        if not 1 <= self.quality <= 100:
            raise ValueError(f"quality must be in [1,100], got {self.quality}")
        if self.subsampling not in VALID_SUBSAMPLING:
            raise ValueError(f"subsampling must be one of {VALID_SUBSAMPLING}")
        if self.restart_interval < 0 or self.restart_interval > 0xFFFF:
            raise ValueError("restart_interval must be in [0, 65535]")
        if self.dct_method not in ("float", "islow"):
            raise ValueError("dct_method must be 'float' or 'islow'")
