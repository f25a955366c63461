"""JFIF container writer (T.81 section B; SURVEY.md component #18).

Marker layout byte-verified against libjpeg-turbo (SURVEY.md Appendix A.1;
frozen copy for the benchmark's reference):

  gray : SOI APP0 DQT SOF0 DHT(dc0) DHT(ac0) [DRI] SOS scan EOI
  color: SOI APP0 DQT DQT SOF0 DHT(dc0) DHT(ac0) DHT(dc1) DHT(ac1) [DRI] SOS scan EOI

DQT payloads are written in ZIGZAG order; all segment lengths are big-endian
and include the two length bytes.
"""
from __future__ import annotations

import struct

import numpy as np

from . import tables as T
from .huffman import HuffTable
from .layout import FrameLayout


def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def write_app0() -> bytes:
    # "JFIF\0", version 1.01, no density units, 1:1 aspect, no thumbnail.
    return _seg(T.M_APP0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))


def write_dqt(tq: int, qtable_natural: np.ndarray) -> bytes:
    zz = qtable_natural[T.ZIGZAG].astype(np.uint8)
    return _seg(T.M_DQT, struct.pack(">B", tq) + zz.tobytes())  # Pq=0 (8-bit)


def write_sof0(layout: FrameLayout) -> bytes:
    body = struct.pack(">BHHB", 8, layout.height, layout.width, len(layout.comps))
    for c in layout.comps:
        body += struct.pack(">BBB", c.comp_id, (c.hs << 4) | c.vs, c.qtab)
    return _seg(T.M_SOF0, body)


def write_dht(tc: int, th: int, table: HuffTable) -> bytes:
    body = struct.pack(">B", (tc << 4) | th)
    body += table.bits.astype(np.uint8).tobytes()
    body += table.vals.astype(np.uint8).tobytes()
    return _seg(T.M_DHT, body)


def write_dri(interval: int) -> bytes:
    return _seg(T.M_DRI, struct.pack(">H", interval))


def write_sos(layout: FrameLayout) -> bytes:
    body = struct.pack(">B", len(layout.comps))
    for c in layout.comps:
        body += struct.pack(">BB", c.comp_id, (c.dc_tab << 4) | c.ac_tab)
    body += struct.pack(">BBB", 0, 63, 0)  # Ss, Se, Ah/Al (baseline sequential)
    return _seg(T.M_SOS, body)


def build_headers(layout: FrameLayout, qtables: list[np.ndarray],
                  dc_tables: list[HuffTable], ac_tables: list[HuffTable]) -> bytes:
    """Everything from SOI through SOS, ready to prepend to the entropy scan.

    qtables / dc_tables / ac_tables are indexed by table id; ids actually used
    by `layout.comps` are emitted, in id order.
    """
    used_q = sorted({c.qtab for c in layout.comps})
    used_h = sorted({(c.dc_tab, c.ac_tab) for c in layout.comps})
    out = struct.pack(">H", T.M_SOI)
    out += write_app0()
    for tq in used_q:
        out += write_dqt(tq, qtables[tq])
    out += write_sof0(layout)
    for td, ta in used_h:
        out += write_dht(0, td, dc_tables[td])
        out += write_dht(1, ta, ac_tables[ta])
    if layout.restart_interval:
        out += write_dri(layout.restart_interval)
    out += write_sos(layout)
    return out
