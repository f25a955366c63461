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
