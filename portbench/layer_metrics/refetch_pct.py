"""refetch_pct.<cell>: the share of the port's fetches whose prefix guess
fell short, so that a second copy followed, in percent: the window's
`jpgenc.refetch_wait` spans over its `jpgenc.fetch_wait` spans (one of
those a fetch, in `engine.EncodePlan.fetch`).

Assumes the fetches run on the calling thread, as `Trace.host` holds that
thread's operations alone, and one `jpgenc.fetch_wait` a fetch."""
from portbench import spans


def read(ctx):
    fetches = spans.count(ctx, "jpgenc.fetch_wait")
    if not fetches:
        return None
    return 100.0 * spans.count(ctx, "jpgenc.refetch_wait") / fetches
