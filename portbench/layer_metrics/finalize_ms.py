"""finalize_ms.<cell>: milliseconds a call of the host finalize (the C++
stuffing and RSTn joins of every image, the fetch excluded): the union of
the port's `jpgenc.finalize_host` spans (`engine.EncodePlan.finalize`)
over the window.

Assumes the finalize runs on the calling thread: `Trace.host` holds that
thread's operations alone, so a finalize spread over a pool of threads
reads near 0, or None, without getting any faster. Before a change that
threads it is judged by this metric, the benchmark has to read the spans of
every thread (`tracing.Trace`)."""
from portbench import spans


def read(ctx):
    return spans.ms_per_call(ctx, "jpgenc.finalize_host")
