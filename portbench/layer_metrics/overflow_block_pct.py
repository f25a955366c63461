"""overflow_block_pct.<cell>: the share of the window's images, in percent,
that overflowed the tight tier because the merge tail flagged a block past
its w_blk words. `mesh.encode_batch` opens, inside each retried image's
`jpgenc.retry` span, one span of the cause that `EncodePlan.fetch` found:
`jpgenc.retry.block` here, else `jpgenc.retry.stream` (the image's words
past the stream's capacity). The stream's share is `overflow_pct` less
this one.

None without any span of the program, as `overflow_pct`, and None where
the window holds retries but no cause span: a program that does not name
the cause. Assumes one cause span a retried image, on the calling thread,
as `overflow_pct` does."""
from portbench import spans

CAUSES = ("jpgenc.retry.block", "jpgenc.retry.stream")


def read(ctx):
    if not ctx.images or not spans.present(ctx):
        return None
    if spans.count(ctx, "jpgenc.retry") and not spans.count(ctx, *CAUSES):
        return None
    return 100.0 * spans.count(ctx, CAUSES[0]) / ctx.images
