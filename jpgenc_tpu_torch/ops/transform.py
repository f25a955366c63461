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


# [64, 64] fused dezigzag+IDCT operator (_KDCT_ZZ's inverse: kron(C, C) is
# orthogonal): row k is the pixel-domain basis image of zigzag coefficient k
# (transform.py:75-79).
_KIDCT_ZZ = np.kron(_C, _C)[np.asarray(T.ZIGZAG), :].astype(np.float32)


def deblockify(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., h//8 * w//8, 8, 8] raster blocks -> [..., h, w]
    (transform.py:29-32, with leading batch dimensions)."""
    lead = blocks.shape[:-3]
    n = len(lead)
    return (blocks.reshape(*lead, h // 8, w // 8, 8, 8)
            .permute(*range(n), n, n + 2, n + 1, n + 3)
            .reshape(*lead, h, w))


def zigzag_to_plane(zz: torch.Tensor, qtable_nat: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    """Decoder reconstruction: [..., n, 64] zigzag ints and [..., 64]
    natural-order quant tables -> float32 plane [..., h, w], unclipped
    (transform.py:82-93): dequant in zigzag order, the fused dezigzag+IDCT
    matmul, + 128."""
    zig = torch.from_numpy(np.asarray(T.ZIGZAG, np.int64)).to(zz.device)
    q_zz = qtable_nat.to(torch.float32).index_select(-1, zig)
    coef = zz.to(torch.float32) * q_zz.unsqueeze(-2)
    k = torch.from_numpy(_KIDCT_ZZ).to(zz.device)
    px = torch.matmul(coef, k) + 128.0
    return deblockify(px.reshape(*px.shape[:-1], 8, 8), h, w)
