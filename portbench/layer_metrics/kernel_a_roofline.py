"""kernel_a_roofline: kernel A's share of its roofline
(`csrc/block_pack.cu`, `block_pack_kernel`): pass 2's coefficients to
entropy-coded blocks.

The bound (`portbench/roofline.py`) counts the stage's work over the window
from the cell's shapes and the bytes the files hold; the time is the device
seconds of the matching kernels in the trace."""
from portbench import roofline

PATTERN = r"\bblock_pack_kernel\b"


def read(ctx):
    bound = roofline.kernel_a(
        ctx.config, ctx.images, ctx.scan_bytes)
    return roofline.share(ctx, PATTERN, bound)
