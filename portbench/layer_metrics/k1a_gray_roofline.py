"""k1a_gray_roofline: gray K1A's share of its roofline (`csrc/k1a_gray.cu`,
`k1a_gray_kernel`): gray pixels to entropy-coded blocks in one pass (level
shift, DCT, quantization and coding).

The bound (`portbench/roofline.py`, `k1a` of a configuration with
`channels` 0: one byte a pixel read, the level shift's 64 operations a
block) counts the stage's work over the window from the cell's shapes and
the bytes the files hold; the time is the device seconds of the matching
kernels in the trace. The worst-tier retries' one-frame launches count
against the window's bound too: each codes a row again at w_blk 56 and adds
its time but no pixel, so retries lower the share."""
from portbench import roofline

PATTERN = r"\bk1a_gray_kernel\b"


def read(ctx):
    bound = roofline.k1a(
        ctx.config, ctx.images, ctx.scan_bytes, ctx.trace.count(PATTERN))
    return roofline.share(ctx, PATTERN, bound)
