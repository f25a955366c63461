"""Public API: encode, decode, decode_batch (counterpart of
jpgenc_tpu/api.py: encode, api.py:18-101, in every mode: float or islow,
standard or optimized tables, with or without a restart interval; and the
decoder's entry points, api.py:14)."""
from __future__ import annotations

import numpy as np
import torch

from jpgenc_tpu_torch import config
from jpgenc_tpu_torch.container import jfif
from jpgenc_tpu_torch.decoder import decode, decode_batch  # noqa: F401  (public API re-exports)
from jpgenc_tpu_torch.engine import (as_device_batch, get_plan,
                                     qtables_for_quality, resolve_device,
                                     tiers_for)
from jpgenc_tpu_torch.ref import encoder as ref_encoder

EOI = b"\xff\xd9"


def jfif_headers(layout, quality: int, dc_tables=None, ac_tables=None
                 ) -> bytes:
    """SOI..SOS headers at `quality`, with the standard tables unless an
    image's own (optimized) tables are given."""
    if dc_tables is None:
        dc_tables, ac_tables = ref_encoder.standard_tables()
    return jfif.build_headers(layout, list(qtables_for_quality(quality)),
                              dc_tables, ac_tables)


def encode(img, quality: int = 75, subsampling: str = "420",
           restart_interval: int = 0, optimize: bool = False,
           dct_method: str = "float", device="cuda") -> bytes:
    """Baseline JFIF encode of one [H, W, 3] RGB or [H, W] gray uint8 image
    on `device`, with every argument `jpgenc_tpu.api.encode` takes.

    img is a numpy array (uploaded per call) or a uint8 tensor already on
    `device`. The bytes equal `jpgenc_tpu.api.encode`'s. device="cuda" runs
    the CUDA kernels and raises if CUDA is absent; device="cpu" runs their
    plain PyTorch versions. restart_interval is the number of MCUs per
    restart segment (0: none); the file carries DRI and RSTn markers.
    The capacity ladder is tight -> safe -> worst (api.py:51-55); the worst
    tier (w_blk=56) cannot overflow, so an overflow there raises.
    optimize=True is the two-pass mode (api.py:57-77): pass 1 keeps the
    scan-ordered coefficients on the device and counts symbols, the host
    builds the image's own Huffman tables, and pass 2 climbs the ladder from
    the cached coefficients. dct_method="islow" is the libjpeg-exact integer
    pipeline (api.py:78-88): the file is byte-identical to libjpeg-turbo's
    at matched settings; it also climbs the ladder from cached
    coefficients, with the standard tables or, with optimize, its own."""
    cfg = config.EncodeConfig(quality=quality, subsampling=subsampling,
                              restart_interval=restart_interval,
                              optimize_huffman=optimize, dct_method=dct_method)
    dev = resolve_device(device)
    if not isinstance(img, torch.Tensor):
        img = np.ascontiguousarray(img)
        if img.dtype != np.uint8:
            raise ValueError("image must be uint8")
    x = as_device_batch(img[None], dev)
    mode = "gray" if x.dim() == 3 else cfg.subsampling
    plan = get_plan(x.shape[1], x.shape[2], mode, cfg.quality, str(dev),
                    cfg.restart_interval)
    lay = plan.layout
    islow = cfg.dct_method == "islow"
    cached = cfg.optimize_huffman or islow     # pass 1 keeps zz on the device
    hdr = jfif_headers(lay, cfg.quality)
    if cfg.optimize_huffman:
        zz, dcdiff, hist = (plan.zz_islow_and_histogram(x) if islow
                            else plan.zz_and_histogram(x))
        per_img, tabs = plan.optimized_tables(hist)
        hdr = jfif_headers(lay, cfg.quality, *per_img[0])
    elif islow:
        (zz, dcdiff), tabs = plan.zz_islow(x), plan.standard_tables
    for cap_u, w_blk in tiers_for(lay, cfg.quality):
        if cached:
            scan = plan.entropy_scans_zz(zz, dcdiff, tabs, cap_u, w_blk)[0]
        else:
            scan = plan.encode_scans(x, cap_u, w_blk)[0]
        if scan is not None:
            break
    else:
        raise RuntimeError("overflow at the worst capacity tier, which "
                           "covers MAX_BLOCK_BITS: the encode is broken")
    return hdr + scan + EOI
