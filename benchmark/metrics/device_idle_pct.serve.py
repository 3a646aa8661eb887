"""Share of the traced window in which no kernel, copy or set ran, from the
union of the device's intervals, in %."""

from benchmark.harness import trace


def read(ctx):
    return trace.idle_pct(ctx)
