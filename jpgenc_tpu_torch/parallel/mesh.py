"""Batched encode on one device (counterpart of jpgenc_tpu/parallel/mesh.py
`encode_batch`, mesh.py:371-474, without sharding or the host exchange:
data-parallel and stripe distribution over several GPUs are ROADMAP.md
Queue 1 item 8)."""
from __future__ import annotations

import numpy as np
import torch

from jpgenc_tpu_torch import config
from jpgenc_tpu_torch.api import EOI, jfif_headers
from jpgenc_tpu_torch.engine import (as_device_batch, get_plan,
                                     resolve_device, scan_caps)
from jpgenc_tpu_torch.ops.pack import w_blk_for_quality


def encode_batch(imgs, quality: int = 75, subsampling: str = "420",
                 restart_interval: int = 0, optimize: bool = False,
                 dct_method: str = "float", device="cuda") -> list[bytes]:
    """Encode a [B, H, W, 3] RGB or [B, H, W] gray uint8 batch on `device`;
    one JFIF bytestring per image, identical to per-image `api.encode`, with
    every mode it takes (restart_interval, optimize, dct_method).

    imgs is a numpy array (uploaded once) or a uint8 tensor already on
    `device` (the device-resident producer interface, mesh.py:382-386). The
    whole batch runs at the tight tier; an image that overflows it is
    re-encoded alone at the worst tier (w_blk=56), which cannot overflow
    (mesh.py:446-469). With optimize=True every image gets its own Huffman
    tables (mesh.py:403-416): pass 1 is K1 (islow: the integer pipeline) +
    per-image histograms, the host builds the tables, pass 2 codes the
    cached coefficients with per-image tables. With islow and the standard
    tables pass 2 codes them with the shared tables (mesh.py:420-422).
    Whenever coefficients are cached the worst-tier retry reuses them."""
    cfg = config.EncodeConfig(quality=quality, subsampling=subsampling,
                              restart_interval=restart_interval,
                              optimize_huffman=optimize, dct_method=dct_method)
    dev = resolve_device(device)
    if not isinstance(imgs, torch.Tensor):
        imgs = np.ascontiguousarray(imgs)
    x = as_device_batch(imgs, dev)
    mode = "gray" if x.dim() == 3 else cfg.subsampling
    plan = get_plan(x.shape[1], x.shape[2], mode, cfg.quality, str(dev),
                    cfg.restart_interval)
    lay = plan.layout
    tight = scan_caps(lay, cfg.quality, "tight")[0]
    worst = scan_caps(lay, cfg.quality, "worst")[0]
    w_blk = w_blk_for_quality(cfg.quality)
    islow = cfg.dct_method == "islow"
    zz = None
    if cfg.optimize_huffman:
        zz, dcdiff, hist = (plan.zz_islow_and_histogram(x) if islow
                            else plan.zz_and_histogram(x))
        per_img, tabs = plan.optimized_tables(hist)
        hdrs = [jfif_headers(lay, cfg.quality, dc, ac) for dc, ac in per_img]
    else:
        hdrs = [jfif_headers(lay, cfg.quality)] * x.shape[0]
        if islow:
            (zz, dcdiff), tabs = plan.zz_islow(x), plan.standard_tables
    if zz is not None:
        scans = plan.entropy_scans_zz(zz, dcdiff, tabs, tight, w_blk)
    else:
        scans = plan.encode_scans(x, tight, w_blk)
    out = []
    for i, scan in enumerate(scans):
        if scan is None and zz is not None:
            tabs_i = tuple(t[i:i + 1] for t in tabs) \
                if cfg.optimize_huffman else tabs
            scan = plan.entropy_scans_zz(zz[i:i + 1], dcdiff[i:i + 1],
                                         tabs_i, worst, 56)[0]
        elif scan is None:
            scan = plan.encode_scans(x[i:i + 1], worst, 56)[0]
        if scan is None:
            raise RuntimeError("overflow at the worst capacity tier, "
                               "which covers MAX_BLOCK_BITS")
        out.append(hdrs[i] + scan + EOI)
    return out
