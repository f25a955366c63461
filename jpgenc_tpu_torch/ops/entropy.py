"""Symbol statistics of the entropy stage: the per-image symbol histogram of
the two-pass optimized-Huffman mode (counterpart of
jpgenc_tpu/ops/entropy.py `symbol_histogram` with `analyze`, :70-95,
:169-218).

The reference formulates the count as a compare-reduce over 160 bins because
data-dependent indices are costly on its platform; here it is a `bincount`
over (image, table, symbol) keys. Neither is a Pallas kernel: this is tensor
code on whatever device holds the coefficients, and it is exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """SSSS (T.81 Table F.1): bit length of |v| as int32, through the f32
    exponent (exact for |v| < 2^24)."""
    av = v.abs().to(torch.int32)
    e = (av.to(torch.float32).view(torch.int32) >> 23) & 0xFF
    return torch.where(av == 0, 0, e - 126)


def symbol_histogram(zz: torch.Tensor, dcdiff: torch.Tensor,
                     actab: torch.Tensor, dctab: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Per-image, per-table symbol frequencies.

    zz [B, n_slots, 64] quantized zigzag blocks in scan order (any integer
    type); dcdiff [B, n_slots] the DC differences (block_pack.slot_metadata);
    actab, dctab, valid [n_slots] the layout's symbol plan. Returns
    [B, 2 (dc, ac), 2 (table id), 256] int32: DC SSSS symbols, AC RRRRSSSS
    value symbols, one ZRL (0xF0) per 16 zeros of a run before a nonzero
    value and one EOB (0x00) per block whose last coefficient is zero
    (T.81 F.1.2.2); padding slots (valid == 0) count nothing."""
    b, n_slots = zz.shape[0], zz.shape[1]
    dev = zz.device
    ok = valid != 0                                           # [S]
    pos = torch.arange(64, dtype=torch.int16, device=dev)
    nz = (zz != 0) & (pos > 0)                                # [B, S, 64]

    # run of zeros before each position: a running max of nonzero positions
    # by log-step shifts (block_pack._ac_analysis), in int16 to stay small
    incl = torch.where(nz, pos, 0)
    for sh in (1, 2, 4, 8, 16, 32):
        incl = torch.maximum(incl, F.pad(incl, (sh, 0))[..., :-sh])
    run = (pos - F.pad(incl, (1, 0))[..., :-1] - 1).to(torch.int32)

    on = nz & ok[:, None]
    sym = ((run & 15) << 4) | bit_length(zz)
    img = torch.arange(b, dtype=torch.int32, device=dev)[:, None, None]
    key = img * 512 + actab.to(torch.int32)[:, None] * 256 + sym
    # count the nonzero positions only: most positions are zero, and one
    # shared bin for them would serialise the count on a single address
    ac = torch.bincount(key[on], minlength=b * 512).reshape(b, 2, 256)

    tabs = torch.arange(2, device=dev)[:, None]
    at = (actab[None, :] == tabs) & ok                        # [2, S]
    n_zrl = torch.where(on, run >> 4, 0).sum(dim=-1)          # [B, S]
    eob = (zz[..., 63] == 0).to(torch.int64)                  # [B, S]
    ac[:, :, 0xF0] += (n_zrl[:, None, :] * at).sum(dim=-1)
    ac[:, :, 0] += (eob[:, None, :] * at).sum(dim=-1)

    dkey = img[..., 0] * 512 + dctab.to(torch.int32) * 256 \
        + bit_length(dcdiff)
    dc = torch.bincount(dkey[:, ok].reshape(-1), minlength=b * 512) \
        .reshape(b, 2, 256)
    return torch.stack([dc, ac], dim=1).to(torch.int32)
