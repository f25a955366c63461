"""h2d_ms.<cell>: milliseconds of host-to-device copies a call, on the
card that copies most (the profiler's `Memcpy HtoD` rows)."""

PATTERN = r"Memcpy HtoD"


def read(ctx):
    per_card = [ctx.trace.seconds(PATTERN, c) for c in ctx.cards]
    if not ctx.calls or not any(per_card):
        return None
    return 1e3 * max(per_card) / ctx.calls
