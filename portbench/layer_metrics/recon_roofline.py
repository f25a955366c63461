"""recon_roofline: the reconstruction's share of its roofline
(`csrc/recon.cu`, `recon_kernel`): coefficients to pixels.

The bound (`portbench/roofline.py`) counts the stage's work over the window
from the cell's shapes and the bytes the files hold; the time is the device
seconds of the matching kernels in the trace."""
from portbench import roofline

PATTERN = r"\brecon_kernel\b"


def read(ctx):
    bound = roofline.recon(
        ctx.config, ctx.images, ctx.trace.count(PATTERN))
    return roofline.share(ctx, PATTERN, bound)
