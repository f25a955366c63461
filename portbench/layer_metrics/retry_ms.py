"""retry_ms.<cell>: milliseconds a call that the worst-tier re-encodes of
single images take (`mesh._Entry.retry`: launch, merge tail, fetch and
finalize), the union of the port's `jpgenc.retry` spans over the window.

Assumes the retries run one by one on the calling thread: `Trace.host`
holds that thread's operations alone, so retries moved to other threads
drop out of the reading without getting any faster."""
from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "jpgenc.retry")
