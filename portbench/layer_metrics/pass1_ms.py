"""pass1_ms.<cell>: milliseconds a call of the two-pass encode's first pass
as the host waits for it: the union of the port's `jpgenc.pass1` spans
(`engine.EncodePlan.zz_and_histogram`: K1's launch and the symbol
histogram, whose boolean-mask count waits for the device) and
`jpgenc.hist_wait` spans (`EncodePlan.optimized_tables`: the wait for the
histogram's copy to the host) over the window. None where the program has
no `jpgenc.pass1` span.

Assumes pass 1 is enqueued and waited for on the calling thread:
`Trace.host` holds that thread's operations alone, so a pass 1 moved to
another thread drops out of the reading without getting any faster."""
from portbench import spans


def read(ctx):
    if not spans.count(ctx, "jpgenc.pass1"):
        return None
    return spans.ms_per_call(ctx, "jpgenc.pass1", "jpgenc.hist_wait")
