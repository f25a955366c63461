"""Transform-stage constants and the quantizer rounding rule
(counterpart of jpgenc_tpu/ops/transform.py)."""
from __future__ import annotations

import numpy as np
import torch

from jpgenc_tpu_torch import tables as T
from jpgenc_tpu_torch.ref import encoder as ref_encoder

_C = np.asarray(ref_encoder.dct_matrix(np.float32))

# [64, 64] fused FDCT+zigzag operator: column k computes zigzag coefficient k
# of the 2-D DCT from a row-major flattened 8x8 block (transform.py:58).
_KDCT_ZZ = np.kron(_C, _C).T[:, np.asarray(T.ZIGZAG)].astype(np.float32)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """trunc(x + copysign(0.5, x)) in the dtype of x — the frozen quantizer
    rounding rule (transform.py:49-51; ref.encoder.round_half_away)."""
    return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))
