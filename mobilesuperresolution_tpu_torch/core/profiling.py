"""Tracing and profiling helpers (counterpart of
mobilesuperresolution_tpu/core/profiling.py), on ``torch.profiler``.

``trace(job_dir)`` writes a trace of everything inside the context, and
``StepProfiler`` one trace of a run's first N optimizer steps
(``--xla_profile_steps``; the flag keeps the JAX package's name), each to
``<job_dir>/profile/<name>/trace.json`` in Chrome's trace format (open it
in Perfetto or chrome://tracing). On the card the trace holds the device's
activity (every kernel and copy, by name); tracing the host's too costs
seconds per step at the port's thousands of launches a step. On the CPU it
holds the host's operators. ``Span`` is a wall-clock scope.
"""

import contextlib
import os
import time

import torch


def _activities():
    act = torch.profiler.ProfilerActivity
    return [act.CUDA] if torch.cuda.is_available() else [act.CPU]


def _out_dir(job_dir, name):
    out = os.path.join(job_dir, "profile", name)
    os.makedirs(out, exist_ok=True)
    return out


def _export(prof, out):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


@contextlib.contextmanager
def trace(job_dir, name="trace"):
    """Trace the body to ``<job_dir>/profile/<name>/trace.json``; yields
    the directory."""
    out = _out_dir(job_dir, name)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield out
    finally:
        _export(prof, out)


class StepProfiler:
    """One trace spanning the first ``steps`` optimizer steps of a run (0 =
    off), written to ``<job_dir>/profile/<name>/trace.json`` when the count
    is reached or at ``close()``. The first step's trace holds the kernels'
    first launches (and on the card their build, on the host), so pass
    N >= 2 to also see a steady step. ``close()`` is idempotent; the
    trainers call it in a ``finally`` so an early exit still writes the
    trace."""

    def __init__(self, job_dir, steps=0, name="train"):
        self.remaining = int(steps or 0)
        self.out = None
        self._prof = None
        if self.remaining > 0:
            self.out = _out_dir(job_dir, name)
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()

    def step(self):
        """Call once per completed optimizer step."""
        if self.remaining > 0:
            self.remaining -= 1
            if self.remaining == 0:
                self.close()

    def close(self):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            _export(prof, self.out)


class Span:
    """with Span() as s: ...; s.ms"""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1e3
        return False
