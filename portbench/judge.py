"""The comparison that decides `correct`, against the plain reference.

Encode cells: for each sampled image, the reference
- reads the program's file back to its coefficients (`reference.decoder`;
  a file it cannot read counts as unlike);
- rebuilds the whole file from those coefficients at the configuration's
  quality (its tables: the standard ones, or with `optimize` the ones the
  reference builds from their histogram) and counts the files that are not
  byte for byte that file (`files_unlike_reference_coding`: headers,
  tables, scan, stuffing, padding and EOI exact);
- computes its own coefficients from the frame's pixels and compares them
  with the program's: the share that differ (`coef_diff_frac`) and the
  largest difference (`coef_max_abs`).

Decode cells: the reference decodes each sampled file itself (parse,
Huffman decoding, float32 reconstruction) and compares the program's
pixels: the share of bytes that differ (`pixel_diff_frac`) and the largest
difference (`pixel_max_abs`). The files themselves are the program's too
(its encoder makes them in set-up): each is held against its frame as an
encode cell's file is, under the names above prefixed `input_`.

Each cell's limits live in `limits/<cell>.json`; a reading with no limit
there is printed and not compared.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import decoder as ref_dec
from portbench.reference import encoder as ref_enc

_UNREADABLE = (ref_dec.DecodeError, IndexError, KeyError, ValueError)


def _geometry(layout) -> tuple:
    return (layout.height, layout.width, layout.subsampling,
            layout.restart_interval)


def judge_encode(samples, config: dict, matmul: str = "float32") -> dict:
    """samples: [(frame uint8 [H, W(, 3)], file bytes)]."""
    unlike, differ, total, worst = 0, 0, 0, 0
    qts = ref_enc.qtables_for(config["quality"])
    for frame, data in samples:
        layout = ref_enc.layout_for(frame.shape, config["subsampling"],
                                    config["restart_interval"])
        ref = ref_enc.image_to_zigzag(frame, layout, qts, matmul)
        total += ref.size
        try:
            parsed = ref_dec.parse(data)
            if _geometry(ref_dec.layout_of(parsed)) != _geometry(layout):
                raise ref_dec.DecodeError("another frame geometry")
            got = ref_dec.decode_coefficients(parsed, layout)
        except _UNREADABLE:
            unlike += 1
            differ += ref.size
            continue
        if ref_enc.encode_blocks(layout, got, config["quality"],
                                 config["optimize"]) != data:
            unlike += 1
        d = np.abs(got.astype(np.int64) - ref)
        differ += int(np.count_nonzero(d))
        worst = max(worst, int(d.max()))
    return {"files_unlike_reference_coding": unlike,
            "coef_diff_frac": differ / total if total else 1.0,
            "coef_max_abs": worst}


def judge_decode(samples, matmul: str = "float32") -> dict:
    """samples: [(file bytes, the program's pixels uint8)]."""
    differ, total, worst = 0, 0, 0
    for data, pixels in samples:
        try:
            ref = ref_dec.decode(data, matmul)
        except _UNREADABLE:          # an input file the reference cannot read
            differ, total, worst = differ + 1, total + 1, 255
            continue
        total += ref.size
        if pixels is None or pixels.shape != ref.shape:
            differ += ref.size
            worst = max(worst, 255)
            continue
        d = np.abs(pixels.astype(np.int16) - ref.astype(np.int16))
        differ += int(np.count_nonzero(d))
        worst = max(worst, int(d.max()))
    return {"pixel_diff_frac": differ / total if total else 1.0,
            "pixel_max_abs": worst}


def held(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every reading that has a limit."""
    return {k: {"value": v, "limit": limits[k]}
            for k, v in readings.items() if k in limits}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
