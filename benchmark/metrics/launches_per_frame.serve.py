"""Kernel launches of the traced window per frame its windows computed."""

from benchmark.harness import trace


def read(ctx):
    n = trace.count_of(ctx["events"])
    return n / ctx["frames"] if n and ctx["frames"] else None
