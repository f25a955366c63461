"""symbol_hist_roofline: the symbol histogram's share of its roofline
(`csrc/symbol_hist.cu`, `symbol_hist_kernel`): pass 1's int16 coefficients
and DC differences to each image's symbol counts.

The bound counts the stage's bytes over the window: per image 128 bytes of
coefficients and 4 of DC difference a block and the 4096-byte histogram,
and per launch the slot plan (three int32 a block). Its operations, a few
integer steps per nonzero coefficient, are left out: bytes bound it by
about 20 times. The time is the device seconds of the matching kernels in
the trace; None where the trace holds none (a program without the
kernel)."""
from portbench import roofline

PATTERN = r"\bsymbol_hist_kernel\b"


def read(ctx):
    n_scan = roofline.layout(ctx.config).n_scan
    nbytes = ctx.images * (n_scan * (128 + 4) + 4096) + \
        ctx.trace.count(PATTERN) * n_scan * 12
    return roofline.share(ctx, PATTERN, roofline.bound_s(nbytes, 0.0))
