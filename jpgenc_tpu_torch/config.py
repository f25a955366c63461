"""Encode and device configuration (copies of jpgenc_tpu/config.py's
EncodeConfig and MeshConfig).

Frozen, hashable dataclasses; no global flags.
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


@dataclass(frozen=True)
class MeshConfig:
    """Declarative device choice (copy of jpgenc_tpu/config.py's MeshConfig).

    batch/stripe: devices along each axis; 0 = use all remaining devices.
    A (batch=0, stripe=1) default gives the 1-D data-parallel list; striped
    single-image encodes set stripe>1. Resolve to a device list with
    parallel.mesh.resolve_devices(cfg, device) — hashable, like the
    original."""
    batch: int = 0
    stripe: int = 1
    batch_axis: str = "batch"
    stripe_axis: str = "stripe"

    def __post_init__(self):
        if self.batch < 0 or self.stripe < 1:
            raise ValueError("batch must be >= 0 and stripe >= 1")
        if self.batch_axis == self.stripe_axis:
            raise ValueError("mesh axis names must differ")
