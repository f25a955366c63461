"""d2h_bytes_per_image: bytes the port's fetch copied to the host over the
window (`engine.fetched_bytes`, reset when the window opens), per image."""


def read(ctx):
    if not ctx.images:
        return None
    return ctx.counters["fetched_bytes"] / ctx.images
