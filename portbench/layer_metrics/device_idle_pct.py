"""device_idle_pct.<cell>: the share of the traced window in which a card
runs no kernel, memcpy or memset: 100 minus the union of those intervals
over the window, averaged over the cards the cell uses."""


def read(ctx):
    if not ctx.trace.device:
        return None
    busy = sum(ctx.trace.busy_s(c) for c in ctx.cards) / len(ctx.cards)
    return 100.0 * (1.0 - busy / ctx.window_s)
