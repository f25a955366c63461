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
                                     reject_unported, resolve_device,
                                     scan_caps)
from jpgenc_tpu_torch.ops.pack import w_blk_for_quality


def encode_batch(imgs, quality: int = 75, subsampling: str = "420",
                 restart_interval: int = 0, optimize: bool = False,
                 dct_method: str = "float", device="cuda") -> list[bytes]:
    """Encode a [B, H, W, 3] RGB or [B, H, W] gray uint8 batch on `device`;
    one JFIF bytestring per image, identical to per-image `api.encode`.

    imgs is a numpy array (uploaded once) or a uint8 tensor already on
    `device` (the device-resident producer interface, mesh.py:382-386). The
    whole batch runs at the tight tier; an image that overflows it is
    re-encoded alone at the worst tier (w_blk=56), which cannot overflow
    (mesh.py:446-469). With optimize=True every image gets its own Huffman
    tables (mesh.py:403-416): pass 1 is K1 + per-image histograms, the host
    builds the tables, pass 2 codes the cached coefficients with per-image
    tables, and the worst-tier retry reuses the cached coefficients."""
    cfg = config.EncodeConfig(quality=quality, subsampling=subsampling,
                              restart_interval=restart_interval,
                              optimize_huffman=optimize, dct_method=dct_method)
    dev = resolve_device(device)
    if not isinstance(imgs, torch.Tensor):
        imgs = np.ascontiguousarray(imgs)
    reject_unported(restart_interval=restart_interval, dct_method=dct_method)
    x = as_device_batch(imgs, dev)
    mode = "gray" if x.dim() == 3 else cfg.subsampling
    plan = get_plan(x.shape[1], x.shape[2], mode, cfg.quality, str(dev))
    lay = plan.layout
    tight = scan_caps(lay, cfg.quality, "tight")[0]
    worst = scan_caps(lay, cfg.quality, "worst")[0]
    w_blk = w_blk_for_quality(cfg.quality)
    if cfg.optimize_huffman:
        zz, dcdiff, hist = plan.zz_and_histogram(x)
        per_img, tabs = plan.optimized_tables(hist)
        scans = plan.entropy_scans_zz(zz, dcdiff, tabs, tight, w_blk)
        hdrs = [jfif_headers(lay, cfg.quality, dc, ac) for dc, ac in per_img]
    else:
        scans = plan.encode_scans(x, tight, w_blk)
        hdrs = [jfif_headers(lay, cfg.quality)] * len(scans)
    out = []
    for i, scan in enumerate(scans):
        if scan is None and cfg.optimize_huffman:
            scan = plan.entropy_scans_zz(
                zz[i:i + 1], dcdiff[i:i + 1],
                tuple(t[i:i + 1] for t in tabs), worst, 56)[0]
        elif scan is None:
            scan = plan.encode_scans(x[i:i + 1], worst, 56)[0]
        if scan is None:
            raise RuntimeError("overflow at the worst capacity tier, "
                               "which covers MAX_BLOCK_BITS")
        out.append(hdrs[i] + scan + EOI)
    return out
