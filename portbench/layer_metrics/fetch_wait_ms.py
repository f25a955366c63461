"""fetch_wait_ms.<cell>: milliseconds a call that the host waits for a
fetch to land (the card's work before it and the device-to-host copy):
the union of the port's `jpgenc.fetch_wait` and `jpgenc.refetch_wait`
spans (`engine.EncodePlan.fetch`) over the window.

Assumes the fetches wait on the calling thread: `Trace.host` holds that
thread's operations alone, so a fetch moved to another thread drops out of
the reading without getting any faster."""
from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "jpgenc.fetch_wait", "jpgenc.refetch_wait")
