"""Kernel B1 (csrc/conv5x5.cu): the roofline's least time for the SpyNet
convs of the levels the port runs on it, over the profiled time of its
kernels, in %."""

from benchmark.harness import trace


def read(ctx):
    return trace.roofline_pct(ctx, trace.B1_KERNELS, "b1_least_s")
