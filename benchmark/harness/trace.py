"""The device trace of a traced run, and the arithmetic that reads it.

``Trace`` records device activity only (kernels, copies, sets) with
``torch.profiler`` (CUPTI) over a window that starts and ends on a
synchronise, so every operation launched in it finishes in it. Its readers
work on plain (name, start_s, end_s, kind) tuples on the device's own
timeline: the busy time is the union of the intervals (overlapping
operations count once), idle gaps are the holes between them.
"""

import time


class Trace:
    """A device-only profile of one window; ``events`` holds its device
    operations as (name, start_s, end_s, kind), kind one of "kernel",
    "memcpy", "memset". ``arm`` starts the profiler in set-up, in a warm-up
    phase whose events are dropped (CUPTI's first activity costs seconds);
    ``begin`` and ``end`` then bound the recorded window."""

    def __init__(self):
        self.events, self.window_s = [], 0.0

    def arm(self):
        import torch

        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                                                              active=1))
        self._prof.start()

    def begin(self):
        import torch

        torch.cuda.synchronize()
        self._prof.step()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def end(self):
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.events = device_events(self._prof.profiler.kineto_results.events())


def device_events(kineto_events):
    """(name, start_s, end_s, kind) of every device-side event."""
    import torch

    out = []
    for e in kineto_events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        kind = "memcpy" if name.startswith("Memcpy") else "memset" if name.startswith("Memset") else "kernel"
        start = e.start_ns() * 1e-9
        out.append((name, start, start + e.duration_ns() * 1e-9, kind))
    return out


def union(events):
    """The merged [start, end] intervals of the events, in order."""
    spans = []
    for _, s, e, _ in sorted(events, key=lambda ev: ev[1]):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return spans


def busy_seconds(events):
    return sum(e - s for s, e in union(events))


def seconds_of(events, names, kind="kernel"):
    """Summed duration of the events of ``kind`` whose name contains one of
    ``names``."""
    return sum(e - s for n, s, e, k in events if k == kind and any(x in n for x in names))


def count_of(events, kind="kernel"):
    return sum(1 for ev in events if ev[3] == kind)


def short_name(name):
    """A kernel's name without its return type, anonymous namespaces,
    template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        name = name.split(stop)[0]
    return name.strip()[:96] or "?"


def breakdown(events, top=10):
    """The device operations that took most time, summed by short name, and
    the longest idle gaps, each named by the operations on either side:
    {"device_ops": [[name, seconds]], "idle_gaps": [[name, seconds]]}."""
    by_name = {}
    for n, s, e, _ in events:
        key = short_name(n)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ordered = sorted(events, key=lambda ev: ev[1])
    gaps, end, last = [], None, None
    for n, s, e, _ in ordered:
        if end is not None and s > end:
            gaps.append((f"{short_name(last)} -> {short_name(n)}", s - end))
        if end is None or e > end:
            end, last = e, n
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps[:top]]}


# the kernels of the port's CUDA sources, by the names the trace gives them
B1_KERNELS = ("conv5x5_wgmma_kernel", "conv5x5_tf32_kernel", "conv5x5_tf32_wgmma_kernel")  # csrc/conv5x5.cu
B2_KERNELS = ("fused_tail_mma_kernel",)  # csrc/fused_tail.cu


def roofline_pct(ctx, kernels, least_key):
    """The roofline's least time of the work the window sent to a kernel
    (``ctx[least_key]``) over the kernel's profiled time, in %; None where
    the kernel did not run."""
    t = seconds_of(ctx["events"], kernels)
    return 100.0 * ctx[least_key] / t if t > 0 else None


def mfu_pct(ctx):
    """Useful operations of the window over its seconds at the peak of the
    cell's dtype, in %."""
    from benchmark.harness.counts import PEAK_FLOPS

    return 100.0 * ctx["useful_flops"] / (ctx["window_s"] * PEAK_FLOPS[ctx["dtype"]])


def idle_pct(ctx):
    """The share of the traced window in which no kernel, copy or set ran on
    the device, in %."""
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
