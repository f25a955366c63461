"""The port's own spans in a traced window, for the per-layer readers.

The port marks stretches of its host work with profiler ranges named
`jpgenc.<what>` (`jpgenc_tpu_torch.utils.profiling.span`). They are
function-scope ranges, so `tracing.Trace` keeps them among the calling
thread's host operations (`Trace.host`), beside the aten and runtime
operations they hold, and never among a card's device work. `Trace.host`
holds the calling thread's operations alone: a span on another thread is
not seen. A program that has no spans leaves the trace without any: every
reader then returns None, and the metric is left out of the line.
"""
from __future__ import annotations

from portbench.tracing import _union

PREFIX = "jpgenc."


def _in_window(ctx, names) -> list:
    tr = ctx.trace
    return [(max(s, tr.t0), min(e, tr.t1)) for s, e, n in tr.host
            if n in names and e > tr.t0 and s < tr.t1]


def present(ctx) -> bool:
    """Whether the program marked any of the window's work with a span."""
    tr = ctx.trace
    return any(n.startswith(PREFIX) and e > tr.t0 and s < tr.t1
               for s, e, n in tr.host)


def seconds(ctx, *names: str) -> float:
    """Seconds of the window covered by the spans of these names (their
    union: a span nested in another of the same names counts once)."""
    return sum(e - s for s, e in _union(_in_window(ctx, names))) / 1e9


def count(ctx, *names: str) -> int:
    """How many spans of these names the window holds."""
    return len(_in_window(ctx, names))


def ms_per_call(ctx, *names: str):
    """Milliseconds a call covered by the spans; None without a call or
    without any span of the program."""
    if not ctx.calls or not present(ctx):
        return None
    return 1e3 * seconds(ctx, *names) / ctx.calls
