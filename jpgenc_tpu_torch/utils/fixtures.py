"""Shared synthetic test/benchmark frames (copy of jpgenc_tpu/utils/fixtures.py:
one definition, so chip_smoke.py, the tests and the reference's bench agree on
their content)."""
from __future__ import annotations

import numpy as np


def synth_frame(h: int, w: int, channels: int = 3,
                noise: float = 12.0, seed: int = 7) -> np.ndarray:
    """Deterministic gradient+sinusoid (+ optional noise) uint8 image."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96.0 * np.sin(xx / 17.0) * np.cos(yy / 23.0) + \
        0.35 * xx + 0.2 * yy + 96.0
    if channels:
        rng = np.random.default_rng(seed)
        chans = [base + 25.0 * c + (rng.normal(0, noise, (h, w))
                                    if noise else 0.0)
                 for c in range(channels)]
        img = np.stack(chans, axis=-1)
    else:
        img = base
    return np.clip(img, 0, 255).astype(np.uint8)


def synth_batch(h: int, w: int, b: int, channels: int = 3) -> np.ndarray:
    return np.stack([synth_frame(h, w, channels, seed=7 + i)
                     for i in range(b)])



def dense_coefficients(b: int, my: int, mx: int, lanes: int, seed: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Reconstruction input with every coefficient nonzero (this port's own;
    the reference has no such fixture): x4 [b, my, mx, lanes] int16 of
    +-1..+-3 and two natural-order quant tables [2, 64] int32 (luma,
    chroma) of 4..12, which keep most samples off the clamps of [0, 255].
    Photographs at Q75 code at 1-3 bpp, far denser than synth_frame's 0.2;
    this input times the products with no term left out."""
    rng = np.random.default_rng(seed)
    mag = rng.integers(1, 4, (b, my, mx, lanes), dtype=np.int16)
    x4 = np.where(rng.random((b, my, mx, lanes)) < 0.5, -mag, mag)
    return x4.astype(np.int16), rng.integers(4, 13, (2, 64)).astype(np.int32)
