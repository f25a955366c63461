"""tables_ms.<cell>: milliseconds a call of the two-pass encode's host
table build: the union of the port's `jpgenc.tables` spans
(`engine.EncodePlan.optimized_tables`: each image's T.81 K.2 Huffman
tables from its histogram, one image after another, and their upload)
over the window. None where the program has no `jpgenc.tables` span.

Assumes the tables are built on the calling thread: `Trace.host` holds
that thread's operations alone, so a build spread over a pool of threads
reads near 0, or None, without getting any faster. Before a change that
threads it is judged by this metric, the benchmark has to read the spans of
every thread (`tracing.Trace`)."""
from portbench import spans


def read(ctx):
    if not spans.count(ctx, "jpgenc.tables"):
        return None
    return spans.ms_per_call(ctx, "jpgenc.tables")
