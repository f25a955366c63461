"""Public API: encode, decode, decode_batch (counterpart of
jpgenc_tpu/api.py: encode, api.py:18-101, in every mode: float or islow,
standard or optimized tables, with or without a restart interval; and the
decoder's entry points, api.py:14)."""
from __future__ import annotations

import numpy as np
import torch

from jpgenc_tpu_torch import config
from jpgenc_tpu_torch.decoder import decode, decode_batch  # noqa: F401  (public API re-exports)
from jpgenc_tpu_torch.engine import (EncodeJob, as_device_batch, get_plan,
                                     resolve_device)


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
    coefficients, with the standard tables or, with optimize, its own.
    The image is an engine.EncodeJob of one row (EncodeJob.file)."""
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
    return EncodeJob(plan, cfg, x).file()
