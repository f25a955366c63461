"""Frame layout: component geometry, MCU tiling, interleaved scan order, segments.

Capability parity: reference layers B/D glue (SURVEY.md section 2) — sampling-factor
machinery (h/v per component, cf. /usr/include/jpeglib.h:125-126), MCU-tiled planes,
the interleaved data-unit order Y00 Y01 Y10 Y11 Cb Cr (T.81 section A.2.3), and
restart-segment bookkeeping (T.81 sections B.2.4.4, F.1.2.3).

Everything here is host-side numpy, computed once per (shape, config) and cached;
the index arrays it produces drive gathers on device, so the device pipeline sees
only static shapes (SURVEY.md section 8 design stance). Frozen copy for the
benchmark's reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

DCTSIZE = 8


@dataclass(frozen=True)
class ComponentLayout:
    comp_id: int          # JFIF component identifier (1=Y/gray, 2=Cb, 3=Cr)
    hs: int               # horizontal sampling factor
    vs: int               # vertical sampling factor
    qtab: int             # quant table id (0 luma, 1 chroma)
    dc_tab: int           # DC Huffman table id
    ac_tab: int           # AC Huffman table id
    plane_h: int          # padded plane height (multiple of 8)
    plane_w: int          # padded plane width (multiple of 8)

    @property
    def blocks_y(self) -> int:
        return self.plane_h // DCTSIZE

    @property
    def blocks_x(self) -> int:
        return self.plane_w // DCTSIZE

    @property
    def n_blocks(self) -> int:
        return self.blocks_y * self.blocks_x


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class FrameLayout:
    """Static per-(H, W, subsampling, restart) encode/decode geometry."""

    height: int                     # original image height
    width: int                      # original image width
    subsampling: str                # '444' | '422' | '420' | 'gray'
    restart_interval: int           # MCUs per restart segment; 0 = one segment
    comps: tuple[ComponentLayout, ...]
    mcu_h: int                      # MCU height in pixels (luma plane)
    mcu_w: int                      # MCU width in pixels
    mcus_y: int
    mcus_x: int
    blocks_per_mcu: int
    # Scan-order index arrays, each of length n_scan = n_mcus * blocks_per_mcu:
    scan_comp: np.ndarray           # component index (into comps) per scan slot
    scan_flat: np.ndarray           # index into the concatenated raster block array
    prev_same: np.ndarray           # scan index of DC predecessor, -1 at predictor reset
    scan_seg: np.ndarray            # restart segment id per scan slot

    @property
    def n_mcus(self) -> int:
        return self.mcus_y * self.mcus_x

    @property
    def n_scan(self) -> int:
        return int(self.scan_flat.size)

    @property
    def n_segments(self) -> int:
        return int(self.scan_seg[-1]) + 1

    @property
    def blocks_per_segment(self) -> int:
        """Blocks in a full segment (last segment may be shorter)."""
        r = self.restart_interval if self.restart_interval else self.n_mcus
        return r * self.blocks_per_mcu

    @property
    def comp_offsets(self) -> tuple[int, ...]:
        """Offsets of each component's raster blocks in the concatenated array."""
        offs = [0]
        for c in self.comps[:-1]:
            offs.append(offs[-1] + c.n_blocks)
        return tuple(offs)

    @property
    def is_gray(self) -> bool:
        return self.subsampling == "gray"


_SAMP = {  # luma sampling factors per mode
    "444": (1, 1),
    "422": (2, 1),
    "420": (2, 2),
    # decode-side coverage of the rarer legal baseline samplings (the
    # encoder emits only the three above + gray; all machinery below is
    # factor-general)
    "411": (4, 1),
    "440": (1, 2),
    "410": (4, 2),
}


@lru_cache(maxsize=256)
def make_layout(height: int, width: int, subsampling: str,
                restart_interval: int = 0) -> FrameLayout:
    if subsampling == "gray":
        # Single-component scan: the MCU is one data unit (T.81 A.2.2);
        # declared sampling factors are 1x1.
        comps = (ComponentLayout(1, 1, 1, 0, 0, 0,
                                 _ceil_to(height, 8), _ceil_to(width, 8)),)
        mcu_h = mcu_w = DCTSIZE
        hmax = vmax = 1
    else:
        hmax, vmax = _SAMP[subsampling]
        mcu_h = DCTSIZE * vmax
        mcu_w = DCTSIZE * hmax
        ph = _ceil_to(height, mcu_h)
        pw = _ceil_to(width, mcu_w)
        comps = (
            ComponentLayout(1, hmax, vmax, 0, 0, 0, ph, pw),
            ComponentLayout(2, 1, 1, 1, 1, 1, ph // vmax, pw // hmax),
            ComponentLayout(3, 1, 1, 1, 1, 1, ph // vmax, pw // hmax),
        )
    mcus_y = comps[0].plane_h // mcu_h if subsampling == "gray" else comps[0].plane_h // mcu_h
    mcus_x = comps[0].plane_w // mcu_w
    blocks_per_mcu = sum(c.hs * c.vs for c in comps)
    n_mcus = mcus_y * mcus_x
    n_scan = n_mcus * blocks_per_mcu

    # --- interleaved scan order (T.81 A.2.3): MCUs raster order; within an MCU,
    # components in order, each raster over its vs x hs block group.
    scan_comp = np.empty(n_scan, dtype=np.int32)
    scan_flat = np.empty(n_scan, dtype=np.int32)
    offs = [0]
    for c in comps[:-1]:
        offs.append(offs[-1] + c.n_blocks)

    mcu_r = np.repeat(np.arange(mcus_y, dtype=np.int64), mcus_x)   # [n_mcus]
    mcu_c = np.tile(np.arange(mcus_x, dtype=np.int64), mcus_y)     # [n_mcus]
    slot = 0
    for ci, c in enumerate(comps):
        for v in range(c.vs):
            for h in range(c.hs):
                by = mcu_r * c.vs + v
                bx = mcu_c * c.hs + h
                flat = offs[ci] + by * c.blocks_x + bx
                scan_flat[slot::blocks_per_mcu] = flat.astype(np.int32)
                scan_comp[slot::blocks_per_mcu] = ci
                slot += 1

    # --- restart segments
    r = restart_interval if restart_interval else n_mcus
    mcu_of_slot = np.arange(n_scan, dtype=np.int64) // blocks_per_mcu
    scan_seg = (mcu_of_slot // r).astype(np.int32)

    # --- DC predecessor per scan slot: previous slot of the same component within
    # the same segment; -1 where the predictor resets (scan start / after RSTn).
    prev_same = np.full(n_scan, -1, dtype=np.int32)
    key = scan_comp.astype(np.int64) * (scan_seg.max() + 1) + scan_seg
    last_slot: dict[int, int] = {}
    for j in range(n_scan):
        k = int(key[j])
        if k in last_slot:
            prev_same[j] = last_slot[k]
        last_slot[k] = j

    return FrameLayout(
        height=height, width=width, subsampling=subsampling,
        restart_interval=restart_interval, comps=comps,
        mcu_h=mcu_h, mcu_w=mcu_w, mcus_y=mcus_y, mcus_x=mcus_x,
        blocks_per_mcu=blocks_per_mcu,
        scan_comp=scan_comp, scan_flat=scan_flat,
        prev_same=prev_same, scan_seg=scan_seg,
    )
