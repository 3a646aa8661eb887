"""Kernel launches of the traced window per training step."""

from benchmark.harness import trace


def read(ctx):
    n = trace.count_of(ctx["events"])
    return n / ctx["steps"] if n and ctx["steps"] else None
