"""Kernel B2 (csrc/fused_tail.cu): the roofline's least time for the
conv + pixel-shuffle tail calls, over the profiled time of its kernel, in %."""

from benchmark.harness import trace


def read(ctx):
    return trace.roofline_pct(ctx, trace.B2_KERNELS, "b2_least_s")
