"""Symbol statistics of the entropy stage: the per-image symbol histogram of
the two-pass optimized-Huffman mode (counterpart of
jpgenc_tpu/ops/entropy.py `symbol_histogram` with `analyze`, :70-95,
:169-218).

The reference formulates the count as XLA tensor code, a compare-reduce
over 160 bins, because data-dependent indices are costly on its platform.
Here a CUDA tensor goes through one hand-written kernel
(`ops/cuda/symbol_hist.py`, `csrc/symbol_hist.cu`) and a CPU tensor through
its plain version, a `bincount` over (image, table, symbol) keys; both are
exact.
"""
from __future__ import annotations

import torch

from jpgenc_tpu_torch.ops.cuda import symbol_hist


def symbol_histogram(zz: torch.Tensor, dcdiff: torch.Tensor,
                     actab: torch.Tensor, dctab: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Per-image, per-table symbol frequencies [B, 2 (dc, ac), 2 (table id),
    256] int32 of zz [B, n_slots, 64] int16 and dcdiff [B, n_slots] int32
    under the layout's symbol plan actab, dctab, valid [n_slots] int32
    (symbol_hist.fused_symbol_histogram)."""
    return symbol_hist.fused_symbol_histogram(zz, dcdiff, actab, dctab, valid)
