"""pin_ms.<cell>: milliseconds a call of `mesh.stage_batch`'s copy of the
batch into pinned memory (one thread): the union of the port's
`jpgenc.stage.pin` spans over the window.

Assumes the pinned copy runs on the calling thread: `Trace.host` holds that
thread's operations alone, so a copy moved to other threads drops out of
the reading without getting any faster."""
from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "jpgenc.stage.pin")
