"""Quality metrics for the smoke test and differential tests (copy of
jpgenc_tpu/utils/metrics.py)."""
from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def bpp(jpeg_bytes: bytes, height: int, width: int) -> float:
    return 8.0 * len(jpeg_bytes) / (height * width)
