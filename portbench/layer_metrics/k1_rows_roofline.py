"""k1_rows_roofline: K1 rows' share of its roofline (`csrc/k1_dct.cu`,
`k1_kernel`): pass 1's pixels to int16 coefficients.

The bound (`portbench/roofline.py`) counts the stage's work over the window
from the cell's shapes and the bytes the files hold; the time is the device
seconds of the matching kernels in the trace."""
from portbench import roofline

PATTERN = r"\bk1_kernel\b"


def read(ctx):
    bound = roofline.k1_rows(
        ctx.config, ctx.images, ctx.trace.count(PATTERN))
    return roofline.share(ctx, PATTERN, bound)
