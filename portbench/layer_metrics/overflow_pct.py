"""overflow_pct.<cell>: the share of the window's images that overflowed
the tight tier, in percent. `mesh.encode_batch` re-encodes each such image
alone at the worst tier, one `jpgenc.retry` span an image, so the count of
those spans over the window's images is the share.

Assumes one retry span an overflowed image, on the calling thread. A change
that retries the overflowed images together, or on other threads, changes
what this counts, not how many overflowed: before such a change is judged
by it, the metric has to be read from an overflow counter of the program
that the harness takes over the window."""
from portbench import spans


def read(ctx):
    if not ctx.images or not spans.present(ctx):
        return None
    return 100.0 * spans.count(ctx, "jpgenc.retry") / ctx.images
