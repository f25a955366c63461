"""The symbol histogram of the optimize mode's pass 1: per image and table,
the count of every DC and AC Huffman symbol of scan-ordered zigzag blocks
(counterpart of jpgenc_tpu/ops/entropy.py `symbol_histogram` with
`analyze`, :70-95, :169-218).

`fused_symbol_histogram` launches the CUDA kernel in `csrc/symbol_hist.cu`
for a CUDA tensor and takes the plain version `histogram_plain` only for a
CPU tensor. The kernel replaces no Pallas kernel: the reference's histogram
is XLA tensor code, a compare-reduce over 160 bins because data-dependent
indices are costly on its platform. The plain version is a `bincount` over
(image, table, symbol) keys, about 20 torch launches and a device sync; the
kernel reads each block once and counts in shared memory. Both are exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from jpgenc_tpu_torch.kernels import build

#: launches of the CUDA kernel, and calls of the plain version
launches = 0
plain_calls = 0

#: the output's last two dimensions (csrc/symbol_hist.cu's kTables, kBins)
TABLES, BINS = 2, 256
#: slots of one image a thread block counts (kSlots)
TILE = 1024


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """SSSS (T.81 Table F.1): bit length of |v| as int32, through the f32
    exponent (exact for |v| < 2^24)."""
    av = v.abs().to(torch.int32)
    e = (av.to(torch.float32).view(torch.int32) >> 23) & 0xFF
    return torch.where(av == 0, 0, e - 126)


def histogram_plain(zz: torch.Tensor, dcdiff: torch.Tensor,
                    actab: torch.Tensor, dctab: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel, as fused_symbol_histogram."""
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


def fused_symbol_histogram(zz: torch.Tensor, dcdiff: torch.Tensor,
                           actab: torch.Tensor, dctab: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Per-image, per-table symbol frequencies.

    zz [B, n_slots, 64] int16 quantized zigzag blocks in scan order; dcdiff
    [B, n_slots] int32 the DC differences (block_pack.slot_metadata);
    actab, dctab, valid [n_slots] int32 the layout's symbol plan. Returns
    [B, 2 (dc, ac), 2 (table id), 256] int32: DC SSSS symbols, AC RRRRSSSS
    value symbols, one ZRL (0xF0) per 16 zeros of a run before a nonzero
    value and one EOB (0x00) per block whose last coefficient is zero
    (T.81 F.1.2.2); padding slots (valid == 0) count nothing. On a CUDA
    tensor this launches the kernel (or raises); on a CPU tensor it runs
    the plain version."""
    global launches, plain_calls
    b, n_slots = zz.shape[0], zz.shape[1]
    args = [(zz, torch.int16, (b, n_slots, 64)),
            (dcdiff, torch.int32, (b, n_slots)),
            (actab, torch.int32, (n_slots,)), (dctab, torch.int32, (n_slots,)),
            (valid, torch.int32, (n_slots,))]
    for t, dt, shape in args:
        if t.dtype != dt or tuple(t.shape) != shape or t.device != zz.device:
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} {t.device}: "
                             f"expected {shape} {dt} on {zz.device}")
    if zz.device.type == "cpu":
        plain_calls += 1
        return histogram_plain(zz, dcdiff, actab, dctab, valid)
    if zz.device.type != "cuda":
        raise ValueError(f"unsupported device {zz.device}")
    if not all(t.is_contiguous() for t, _, _ in args):
        raise ValueError("the histogram's operands must be contiguous")
    if zz.data_ptr() % 16:
        raise ValueError("zz must be 16-byte aligned (the kernel reads it "
                         "16 bytes a lane)")
    out = torch.zeros((b, 2, TABLES, BINS), dtype=torch.int32,
                      device=zz.device)
    lib = build.library()
    with torch.cuda.device(zz.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.symbol_hist_launch(
            zz.data_ptr(), dcdiff.data_ptr(), actab.data_ptr(),
            dctab.data_ptr(), valid.data_ptr(), b, n_slots, out.data_ptr(),
            stream)
    build.check(rc, "symbol_hist")
    launches += 1
    return out
