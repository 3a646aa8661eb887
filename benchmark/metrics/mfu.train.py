"""The window's useful operations (benchmark/harness/counts.py) over its
seconds at the published peak of the cell's dtype, in %."""

from benchmark.harness import trace


def read(ctx):
    return trace.mfu_pct(ctx)
