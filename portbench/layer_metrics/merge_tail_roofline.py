"""merge_tail_roofline: the merge tail's share of its roofline
(`csrc/seg_merge.cu`: `merge_tiles`, `merge_scan`, `merge_write`): coded
blocks to each image's stream.

The bound (`portbench/roofline.py`) counts the stage's work over the window
from the cell's shapes and the bytes the files hold; the time is the device
seconds of the matching kernels in the trace."""
from portbench import roofline

PATTERN = r"\bmerge_(tiles|scan|write)\b"


def read(ctx):
    bound = roofline.merge_tail(
        ctx.config, ctx.images, ctx.scan_bytes)
    return roofline.share(ctx, PATTERN, bound)
