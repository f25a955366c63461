"""JFIF marker parser (T.81 section B; SURVEY.md component #19).

Walks the segment structure of a baseline JPEG produced by this engine (or any
baseline encoder emitting SOI/APP/DQT/SOF0/DHT/DRI/SOS), collecting quant
tables, Huffman tables, frame geometry, and the raw entropy-coded scan. Copy
of jpgenc_tpu/container/parser.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from jpgenc_tpu_torch import tables as T
from jpgenc_tpu_torch.huffman import HuffTable, build_codes


@dataclass
class FrameComponent:
    comp_id: int
    hs: int
    vs: int
    qtab: int
    dc_tab: int = 0
    ac_tab: int = 0


@dataclass
class ParsedJpeg:
    height: int = 0
    width: int = 0
    precision: int = 8
    comps: list[FrameComponent] = field(default_factory=list)
    qtables: dict[int, np.ndarray] = field(default_factory=dict)   # natural order
    dc_tables: dict[int, HuffTable] = field(default_factory=dict)
    ac_tables: dict[int, HuffTable] = field(default_factory=dict)
    restart_interval: int = 0
    scan_data: bytes = b""     # entropy bytes incl. RSTn, excl. EOI
    app0: bytes = b""

    @property
    def subsampling(self) -> str:
        if len(self.comps) == 1:
            return "gray"
        if len(self.comps) != 3:
            raise ValueError(
                f"unsupported component count {len(self.comps)} "
                "(baseline gray or YCbCr only)")
        hs, vs = self.comps[0].hs, self.comps[0].vs
        # decode-side coverage includes the rarer legal baseline samplings
        # (4:1:1 e.g. DV sources, 4:4:0, 4:1:0); the encoder emits only
        # 444/422/420/gray
        mode = {(1, 1): "444", (2, 1): "422", (2, 2): "420",
                (4, 1): "411", (1, 2): "440", (4, 2): "410"}.get((hs, vs))
        if mode is None or any((c.hs, c.vs) != (1, 1) for c in self.comps[1:]):
            factors = "".join(f" {c.hs}x{c.vs}" for c in self.comps)
            raise ValueError(
                f"unsupported sampling factors{factors} "
                "(supported: 4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0, 4:1:0, "
                "grayscale)")
        return mode


def parse_jpeg(data: bytes) -> ParsedJpeg:
    out = ParsedJpeg()
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG: missing SOI")
    i = 2
    n = len(data)
    while i < n:
        if data[i] != 0xFF:
            raise ValueError(f"expected marker at offset {i}")
        if i + 1 >= n:
            raise ValueError("truncated JPEG: lone 0xFF at end of data")
        marker = data[i + 1]
        i += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7:
            raise ValueError("unexpected RST outside scan")
        if marker == 0x01 or 0xD0 <= marker <= 0xD9:
            continue  # standalone markers carry no length field
        if i + 2 > n:
            raise ValueError("truncated JPEG: marker without length")
        seg_len = int.from_bytes(data[i:i + 2], "big")
        if seg_len < 2 or i + seg_len > n:
            raise ValueError(
                f"truncated JPEG: segment 0xFF{marker:02X} length {seg_len} "
                f"overruns data")
        payload = data[i + 2:i + seg_len]
        i += seg_len

        if marker == 0xE0:
            out.app0 = payload
        elif marker == 0xDB:  # DQT (possibly several tables in one segment)
            p = 0
            while p < len(payload):
                pq, tq = payload[p] >> 4, payload[p] & 0xF
                p += 1
                if pq != 0:
                    raise ValueError("only 8-bit quant tables supported")
                if len(payload) < p + 64:
                    raise ValueError("truncated DQT payload")
                zz = np.frombuffer(payload[p:p + 64], dtype=np.uint8).astype(np.int32)
                nat = np.zeros(64, dtype=np.int32)
                nat[T.ZIGZAG] = zz  # payload is zigzag; store natural
                out.qtables[tq] = nat
                p += 64
        elif marker == 0xC0:  # SOF0
            if len(payload) < 6:
                raise ValueError("truncated SOF0 payload")
            out.precision = payload[0]
            out.height = int.from_bytes(payload[1:3], "big")
            out.width = int.from_bytes(payload[3:5], "big")
            if out.height == 0 or out.width == 0:
                raise ValueError("SOF0 declares zero image dimensions")
            nc = payload[5]
            if len(payload) < 6 + 3 * nc:
                raise ValueError("truncated SOF0 component list")
            for c in range(nc):
                cid, samp, tq = payload[6 + 3 * c:9 + 3 * c]
                hs, vs = samp >> 4, samp & 0xF
                if hs == 0 or vs == 0:
                    raise ValueError("SOF0 declares zero sampling factor")
                out.comps.append(FrameComponent(cid, hs, vs, tq))
        elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise ValueError(f"unsupported SOF marker 0xFF{marker:02X} (baseline only)")
        elif marker == 0xC4:  # DHT (possibly several)
            p = 0
            while p < len(payload):
                tc, th = payload[p] >> 4, payload[p] & 0xF
                if len(payload) < p + 17:
                    raise ValueError("truncated DHT payload")
                bits = np.frombuffer(payload[p + 1:p + 17], dtype=np.uint8).astype(np.int32)
                nv = int(bits.sum())
                if len(payload) < p + 17 + nv:
                    raise ValueError("truncated DHT symbol list")
                vals = np.frombuffer(payload[p + 17:p + 17 + nv], dtype=np.uint8).astype(np.int32)
                tbl = build_codes(bits, vals)
                (out.ac_tables if tc else out.dc_tables)[th] = tbl
                p += 17 + nv
        elif marker == 0xDD:  # DRI
            out.restart_interval = int.from_bytes(payload[:2], "big")
        elif marker == 0xDA:  # SOS
            if not payload or len(payload) < 1 + 2 * payload[0]:
                raise ValueError("truncated SOS payload")
            ns = payload[0]
            for s in range(ns):
                cs, tda = payload[1 + 2 * s], payload[2 + 2 * s]
                for c in out.comps:
                    if c.comp_id == cs:
                        c.dc_tab, c.ac_tab = tda >> 4, tda & 0xF
            # entropy data runs until the next non-RST marker (EOI for
            # baseline). Vectorized: the per-byte Python walk cost
            # ~9 ms/MB and dominated batch-decode host time.
            arr = np.frombuffer(data, np.uint8)
            ff = np.flatnonzero(arr[i:n - 1] == 0xFF)
            if ff.size:
                nxt = arr[i + ff + 1]
                term = (nxt != 0x00) & ((nxt < 0xD0) | (nxt > 0xD7))
                hits = ff[term]
                j = i + int(hits[0]) if hits.size else n - 1
            else:
                j = n - 1
            out.scan_data = data[i:j]
            i = j
        # other APPn/COM markers: skipped
    return out
