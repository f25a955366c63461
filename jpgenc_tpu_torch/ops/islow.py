"""Device (torch) twin of ref/islow.py: the libjpeg-exact integer encode
path (counterpart of jpgenc_tpu/ops/islow.py), over a batch of images.

Everything is int32 (libjpeg's own working width; the largest islow
intermediate is about 4.1e8 < 2^31) with arithmetic shifts, never float.
The edge-expansion and dummy-block geometry is resolved to numpy index maps
per layout, so the pixels -> zigzag pipeline is pad / reshape / integer
arithmetic plus one gather for the jccoefct dummy-DC chains. Bit-identical
to ref/islow.py, which is byte-identical to libjpeg-turbo.

It holds no kernel: it feeds kernel A. It is the conformance mode, not the
throughput mode.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from jpgenc_tpu_torch import tables as T
from jpgenc_tpu_torch.layout import make_layout
from jpgenc_tpu_torch.ops.color import pad_replicate
from jpgenc_tpu_torch.ref import islow as R

_I32 = torch.int32


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: torch.Tensor, pass1: bool) -> torch.Tensor:
    """One 8-point islow pass over the last axis ([..., 8] int32)."""
    c = d.unbind(-1)
    tmp0, tmp7 = c[0] + c[7], c[0] - c[7]
    tmp1, tmp6 = c[1] + c[6], c[1] - c[6]
    tmp2, tmp5 = c[2] + c[5], c[2] - c[5]
    tmp3, tmp4 = c[3] + c[4], c[3] - c[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    if pass1:
        out0 = (tmp10 + tmp11) << R.PASS1_BITS
        out4 = (tmp10 - tmp11) << R.PASS1_BITS
        shift = R.CONST_BITS - R.PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, R.PASS1_BITS)
        out4 = _descale(tmp10 - tmp11, R.PASS1_BITS)
        shift = R.CONST_BITS + R.PASS1_BITS

    z1 = (tmp12 + tmp13) * R._F_0_541196100
    out2 = _descale(z1 + tmp13 * R._F_0_765366865, shift)
    out6 = _descale(z1 - tmp12 * R._F_1_847759065, shift)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * R._F_1_175875602
    t4 = tmp4 * R._F_0_298631336
    t5 = tmp5 * R._F_2_053119869
    t6 = tmp6 * R._F_3_072711026
    t7 = tmp7 * R._F_1_501321110
    z1 = z1 * -R._F_0_899976223
    z2 = z2 * -R._F_2_562915447
    z3 = z3 * -R._F_1_961570560 + z5
    z4 = z4 * -R._F_0_390180644 + z5

    out7 = _descale(t4 + z1 + z3, shift)
    out5 = _descale(t5 + z2 + z4, shift)
    out3 = _descale(t6 + z2 + z3, shift)
    out1 = _descale(t7 + z1 + z4, shift)
    return torch.stack([out0, out1, out2, out3, out4, out5, out6, out7],
                       dim=-1)


def fdct8x8_islow(blocks: torch.Tensor) -> torch.Tensor:
    """Level-shifted int32 blocks [..., 8, 8] -> x8-scaled islow DCT."""
    x = _fdct_1d(blocks.to(_I32), pass1=True)
    x = _fdct_1d(x.transpose(-1, -2), pass1=False)
    return x.transpose(-1, -2)


def quantize_islow(coef: torch.Tensor, qtable64: torch.Tensor) -> torch.Tensor:
    """Magnitude-space rounded division by 8*q (libjpeg forward_DCT)."""
    q = (qtable64.to(_I32) << 3).reshape((1,) * (coef.dim() - 2) + (8, 8))
    mag = coef.abs() + (q >> 1)
    return coef.sign() * torch.div(mag, q, rounding_mode="floor")


def rgb_to_ycbcr_islow(rgb: torch.Tensor):
    """[..., 3] uint8 -> 3 int32 planes, libjpeg rgb_ycc table arithmetic."""
    r = rgb[..., 0].to(_I32)
    g = rgb[..., 1].to(_I32)
    b = rgb[..., 2].to(_I32)
    f = R._fix
    y = (f(0.29900) * r + f(0.58700) * g + f(0.11400) * b
         + R._ONE_HALF) >> R.SCALEBITS
    cb = (-f(0.16874) * r - f(0.33126) * g + f(0.50000) * b
          + R._CBCR_OFFSET + R._ONE_HALF - 1) >> R.SCALEBITS
    cr = (f(0.50000) * r - f(0.41869) * g - f(0.08131) * b
          + R._CBCR_OFFSET + R._ONE_HALF - 1) >> R.SCALEBITS
    return y, cb, cr


def _downsample(p: torch.Tensor, rx: int, ry: int) -> torch.Tensor:
    """Alternating-bias box mean (h2v2 / h2v1) of [..., H, W] int32."""
    if ry == 2:
        s = (p[..., 0::2, 0::2] + p[..., 0::2, 1::2]
             + p[..., 1::2, 0::2] + p[..., 1::2, 1::2])
        bias = 1 + torch.arange(s.shape[-1], device=p.device,
                                dtype=_I32) % 2          # 1, 2, 1, 2, ...
        return (s + bias) >> 2
    s = p[..., :, 0::2] + p[..., :, 1::2]
    bias = torch.arange(s.shape[-1], device=p.device, dtype=_I32) % 2
    return (s + bias) >> 1


def _dummy_maps(layout):
    """Numpy geometry per component: (cw, ch, wib, hib, dc_src, real).

    dc_src [bh*bw]: for every block in the padded grid, the flat index of
    the REAL block whose quantized DC it carries (jccoefct dummy chains
    resolved); real [bh*bw] bool: True where the block's AC survives."""
    out = []
    H, W = layout.height, layout.width
    hs_max, vs_max = layout.comps[0].hs, layout.comps[0].vs
    for c in layout.comps:
        cw = -(-W * c.hs // hs_max)
        ch = -(-H * c.vs // vs_max)
        wib, hib = -(-cw // 8), -(-ch // 8)
        bw, bh = layout.mcus_x * c.hs, layout.mcus_y * c.vs
        src = np.zeros((bh, bw), np.int64)
        src[:hib, :wib] = (np.arange(hib)[:, None] * bw
                           + np.arange(wib)[None, :])
        for x in range(wib, bw):                      # dummy columns
            src[:hib, x] = src[:hib, wib - 1]
        for y in range(hib, bh):                      # dummy rows (chained)
            for x in range(bw):
                if x % c.hs == 0:
                    src[y, x] = src[y - 1, x - x % c.hs + c.hs - 1]
                else:
                    src[y, x] = src[y, x - 1]
        real = np.zeros((bh, bw), bool)
        real[:hib, :wib] = True
        out.append((cw, ch, wib, hib, src.reshape(-1), real.reshape(-1)))
    return out


@functools.lru_cache(maxsize=16)
def _gather_maps(height: int, width: int, subsampling: str, device: str):
    """Per component of the layout, on `device`: (wib, hib, row index into
    the real-block grid for every padded-grid block, keep mask [bh*bw, 64]
    bool: all of a real block, the DC of a dummy one)."""
    layout = make_layout(height, width, subsampling)
    maps = []
    for c, (_, _, wib, hib, dc_src, real) in zip(layout.comps,
                                                 _dummy_maps(layout)):
        bw = layout.mcus_x * c.hs
        full_src = (dc_src // bw) * wib + dc_src % bw
        keep = real[:, None] | (np.arange(64) == 0)
        maps.append((wib, hib, torch.from_numpy(full_src).to(device),
                     torch.from_numpy(keep).to(device)))
    return maps


def _pad_edge(p: torch.Tensor, bottom: int, right: int) -> torch.Tensor:
    """Edge-replicate [B, H, W] by `bottom` rows and `right` columns."""
    if bottom == 0 and right == 0:
        return p
    h, w = p.shape[-2:]
    return pad_replicate(p[..., None], h + bottom, w + right)[..., 0]


def image_to_zigzag_islow(imgs: torch.Tensor, layout,
                          qtabs: torch.Tensor) -> torch.Tensor:
    """uint8 batch [B, H, W, 3] (gray: [B, H, W]) -> [B, n_total, 64] int32
    zigzag blocks, raster per component: the batched twin of
    ref.islow.image_to_zigzag_islow. qtabs: [n_tables, 64] int32 natural
    order on imgs' device."""
    H, W = layout.height, layout.width
    if layout.is_gray:
        planes = [imgs.to(_I32) if imgs.dim() == 3 else imgs[..., 0].to(_I32)]
    else:
        planes = list(rgb_to_ycbcr_islow(imgs))
    b = imgs.shape[0]
    hs_max, vs_max = layout.comps[0].hs, layout.comps[0].vs
    zz = torch.from_numpy(np.asarray(T.ZIGZAG, np.int64)).to(imgs.device)
    maps = _gather_maps(H, W, layout.subsampling, str(imgs.device))

    parts = []
    for ci, c in enumerate(layout.comps):
        wib, hib, full_src, keep = maps[ci]
        rx, ry = hs_max // c.hs, vs_max // c.vs
        plane = planes[ci]
        if rx == 1 and ry == 1:
            p = _pad_edge(plane, hib * 8 - H, wib * 8 - W)
        else:
            # horizontal: FULL-RES edge expansion to rx*wib*8 BEFORE the
            # box mean (jcsample expand_right_edge); vertical: full-res
            # only to a sampling-ratio multiple, then the last DOWNSAMPLED
            # row fills the block grid (jcprepct): asymmetric on purpose
            fr = _pad_edge(plane, (-H) % ry, rx * wib * 8 - W)
            ds = _downsample(fr, rx, ry)
            p = _pad_edge(ds, hib * 8 - ds.shape[-2], 0)
        blocks = (p.reshape(b, hib, 8, wib, 8).permute(0, 1, 3, 2, 4)
                  .reshape(b, hib * wib, 8, 8) - 128)
        q = quantize_islow(fdct8x8_islow(blocks),
                           qtabs[c.qtab]).reshape(b, hib * wib, 64)
        # embed into the padded MCU grid with the dummy-block rule: every
        # padded-grid block gathers its DC-source block's row (a real block
        # maps to itself), then dummy AC is zeroed
        out = torch.where(keep, q.index_select(1, full_src), 0)
        parts.append(out.index_select(-1, zz))
    return torch.cat(parts, dim=1)

