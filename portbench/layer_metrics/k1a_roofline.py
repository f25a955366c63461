"""k1a_roofline: K1A's share of its roofline (`csrc/k1a_fused.cu`,
`k1a_kernel`): pixels to entropy-coded blocks in one pass.

The bound (`portbench/roofline.py`) counts the stage's work over the window
from the cell's shapes and the bytes the files hold; the time is the device
seconds of the matching kernels in the trace."""
from portbench import roofline

PATTERN = r"\bk1a_kernel\b"


def read(ctx):
    bound = roofline.k1a(
        ctx.config, ctx.images, ctx.scan_bytes, ctx.trace.count(PATTERN))
    return roofline.share(ctx, PATTERN, bound)
