"""The kernels' bounds: the least time one H100 could take for a stage's
work, from the cell's shapes and the bytes the run really produced.

A stage's bound is the larger of its bytes over the HBM rate and its
operations over the float32 rate outside the tensor cores (NVIDIA's H100
SXM data sheet, at the 700 W limit). Each input byte is read once and each
output byte written once, whatever a kernel reads again; where the output
depends on the data (the entropy-coded stream) the bytes the files hold are
counted, not the most a kernel could write. The operations are counted for
the stage's function in a separable float32 form, whatever kernel computes
it: 15 per pixel for BT.601, one add or scale per pixel averaged into a
chroma sample, 16 eight-point passes of 40 (Loeffler's 11 multiplies and 29
adds) per block, 2 per coefficient to divide and round, 6 integer
operations per coefficient to code it and 4 per output word to merge. The
reconstruction: per block one multiply per coefficient, the 16 passes and 3
per sample for + 128, round and clamp; per pixel 12 for the chroma taps, 8
for the colour matrix and 6 for three rounds and clamps. (A frozen copy of
the arithmetic of the port's `chip_smoke.py` `kernels` line.)
"""
from __future__ import annotations

from portbench.reference.layout import FrameLayout, make_layout

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

DCT_OPS = 16 * 40 + 2 * 64          # per block: 8-point passes, divide, round
CODE_OPS = 6                        # per coefficient, entropy coding
MERGE_OPS = 4                       # per output word
RECON_BLOCK_OPS = 64 + 16 * 40 + 3 * 64
RECON_PIXEL_OPS = 12 + 8 + 6
TABLE_BYTES = 4 * (512 + 256 + 4)   # the Huffman rows a coding kernel reads


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def layout(config: dict) -> FrameLayout:
    mode = config["subsampling"] if config["channels"] else "gray"
    return make_layout(config["height"], config["width"], mode,
                       config["restart_interval"])


def _pixels_bytes(config: dict) -> int:
    return config["height"] * config["width"] * max(config["channels"], 1)


def _operator_bytes(lay: FrameLayout) -> int:
    """The transform's operands a launch reads: the 64 x 64 KDCT_ZZ and the
    quantizer of each block of an MCU (float32)."""
    return 4 * (64 * 64 + lay.blocks_per_mcu * 64)


def _transform_ops(lay: FrameLayout) -> float:
    px_mcu = lay.mcu_h * lay.mcu_w
    sub = 2 * px_mcu if lay.blocks_per_mcu > 1 and px_mcu > 64 else 0
    colour = 15 * px_mcu if lay.blocks_per_mcu > 1 else 64   # gray: shift
    return float(lay.n_mcus) * (colour + sub + lay.blocks_per_mcu * DCT_OPS)


def k1a(config: dict, images: int, scan_bytes: int, launches: int) -> float:
    """Pixels -> entropy-coded blocks (K1A: colour, subsampling, DCT,
    quantization and coding in one pass)."""
    lay = layout(config)
    nbytes = images * _pixels_bytes(config) + scan_bytes + \
        launches * (_operator_bytes(lay) + TABLE_BYTES)
    ops = images * (_transform_ops(lay) + CODE_OPS * 64.0 * lay.n_scan)
    return bound_s(nbytes, ops)


def merge_tail(config: dict, images: int, scan_bytes: int) -> float:
    """Coded blocks and their bit counts -> each image's stream, its
    segment lengths and its overflow flag."""
    lay = layout(config)
    nbytes = 2 * scan_bytes + images * (4 * lay.n_scan
                                        + 4 * lay.n_segments + 1)
    return bound_s(nbytes, MERGE_OPS * scan_bytes / 4.0)


def k1_rows(config: dict, images: int, launches: int) -> float:
    """Pixels -> quantized int16 coefficients (pass 1's transform)."""
    lay = layout(config)
    nbytes = images * (_pixels_bytes(config) + 128 * lay.n_scan) + \
        launches * _operator_bytes(lay)
    return bound_s(nbytes, images * _transform_ops(lay))


def kernel_a(config: dict, images: int, scan_bytes: int) -> float:
    """Cached coefficients and DC differences -> entropy-coded blocks with
    each image's own tables."""
    lay = layout(config)
    nbytes = images * (lay.n_scan * (128 + 4 + 4) + TABLE_BYTES) + scan_bytes
    return bound_s(nbytes, images * CODE_OPS * 64.0 * lay.n_scan)


def recon(config: dict, images: int, launches: int) -> float:
    """Dense int16 coefficients and quantizers -> uint8 pixels."""
    lay = layout(config)
    px_mcu = lay.mcu_h * lay.mcu_w
    nbytes = images * (128 * lay.n_scan + 4 * lay.blocks_per_mcu * 64
                       + _pixels_bytes(config)) + launches * 4 * 64 * 64
    ops = images * float(lay.n_mcus) * (lay.blocks_per_mcu * RECON_BLOCK_OPS
                                        + RECON_PIXEL_OPS * px_mcu)
    return bound_s(nbytes, ops)


def share(ctx, pattern: str, bound: float):
    """A stage's share of its roofline in %: its bound over the window over
    the device seconds of the kernels matching `pattern`; None where the
    trace holds none of them."""
    spent = ctx.trace.seconds(pattern)
    if not spent:
        return None
    return 100.0 * bound / spent
