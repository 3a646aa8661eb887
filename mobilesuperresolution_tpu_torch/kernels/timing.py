"""Kernel timing harness: measured latency tables for the NAS search
(counterpart of mobilesuperresolution_tpu/kernels/timing.py).

Times the searched split block itself on the device and writes the
``(N, 4)`` table ``[ch_in, ch_split, kernel, ms]`` the search consumes
(``--speed_table``, nas/speed_estimator.py): for each config, the block's
ms per call less the ms of a zero block (``a * 1.0`` on the same tensor),
clamped at 0, as the reference subtracts its zero-block baseline from its
mobile benchmark logs.

On the card each block call is one launch of kernel B5
(kernels/fused_convsep.py) plus the residual add, the slice and the concat;
its weights are derived once, outside the timed region, as XLA folds the
weight norm into constants in the JAX harness. On a CUDA tensor the block
launches B5 or raises (a width B5 does not take is refused, never run on
the plain version). Times on the card come from CUDA events, and on the
CPU from the host clock.

Two timers: ``time_fn``, the median of per-call times, and
``time_fn_loop``, ``iters`` chained calls between two events with one
synchronisation per rep. Each chained call's input is ``c + k·1e-12``, as
in the JAX harness, where the dependence on k keeps XLA from hoisting the
body out of its loop; the zero block pays the same add, so the
subtraction removes it.
"""

import time

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.core.device import resolve_device
from mobilesuperresolution_tpu_torch.kernels.fused_convsep import fused_convsep
from mobilesuperresolution_tpu_torch.models.wdsr_nas import ConvSep
from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters, random_jax_params

CH_IN_CHOICES = (8, 16, 24, 32, 48, 64)
SPLIT_FRACTIONS = (0.25, 0.5, 0.75, 1.0)


class _Clock:
    """Start / stop timer in ms on ``device``: CUDA events on the card, the
    host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t1 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.t1.record()
            self.t1.synchronize()
            return self.t0.elapsed_time(self.t1)
        return (time.perf_counter() - self.t0) * 1e3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn, *args, runs=20, warmup=3):
    """Median ms of one call of ``fn(*args)``; args[0] names the device."""
    device = args[0].device
    with torch.inference_mode():
        for _ in range(1 + warmup):
            fn(*args)
        _sync(device)
        clock, times = _Clock(device), []
        for _ in range(runs):
            clock.start()
            fn(*args)
            times.append(clock.stop())
    return float(np.median(times))


def time_fn_loop(fn, x, iters=50, reps=5, warmup=1):
    """Median ms per call of ``fn`` chained ``iters`` times (each call's
    input the last one's output plus k·1e-12), over ``reps`` reps after one
    untimed pass and ``warmup`` more; ``fn`` maps a tensor to one of the
    same shape and dtype. Each rep synchronises once, at its end."""

    def loop(c):
        for k in range(iters):
            c = fn(c + k * 1e-12)
        return c

    with torch.inference_mode():
        for _ in range(1 + warmup):
            loop(x)
        _sync(x.device)
        clock, times = _Clock(x.device), []
        for _ in range(reps):
            clock.start()
            loop(x)
            times.append(clock.stop() / iters)
    return float(np.median(times))


def loop_calls(iters=50, reps=5, warmup=1):
    """The calls of ``fn`` one ``time_fn_loop`` makes."""
    return (1 + warmup + reps) * iters


def split_block_weights(ch_split, kernel, seed=0, device=None, params=None):
    """The derived weights of a split block's branch (w_depth (k, k, C),
    b_depth, w_point (C, C), b_point), float32 on ``device``, from the
    port's ``ConvSep`` holding ``params`` (the JAX layout: ``WNConv_0/v``
    ... ``WNConv_1/b``) or, without them, seeded random weights from the
    JAX initializers."""
    branch = ConvSep(ch_split, ch_split, kernel)
    src = params if params is not None else random_jax_params(branch, seed)
    with torch.no_grad():
        for key, p in jax_named_parameters(branch).items():
            p.copy_(torch.tensor(np.asarray(src[key], np.float32)))
        wd = branch.WNConv_0.effective_kernel()[:, :, 0, :]
        wp = branch.WNConv_1.effective_kernel()[0, 0]
        ws = (wd, branch.WNConv_0.b, wp, branch.WNConv_1.b)
        return tuple(t.detach().float().contiguous().to(device) for t in ws)


def split_block(x, ch_split, weights, branch=fused_convsep):
    """The discrete split block the search's latency model scores: the last
    ``ch_split`` channels through ``branch`` (depthwise k×k + bias, ReLU,
    1×1 + bias) plus themselves, the first ``ch_in - ch_split`` passed
    through."""
    ch_in = x.shape[-1]
    active = x[..., ch_in - ch_split:].contiguous()
    y = branch(active, *weights) + active
    if ch_in == ch_split:
        return y
    return torch.cat([x[..., : ch_in - ch_split], y], dim=-1)


def _split_block_forward(ch_in, ch_split, kernel, hw, seed=0, device=None, params=None):
    """(block function, its zero input (1, *hw, ch_in) float32) for one
    config, its weights derived once here."""
    device = resolve_device(device)
    weights = split_block_weights(ch_split, kernel, seed, device, params)
    x = torch.zeros((1, *hw, ch_in), dtype=torch.float32, device=device)
    return (lambda inp: split_block(inp, ch_split, weights)), x


def _measure(fn, x, runs, method, iters):
    if method == "loop":
        return time_fn_loop(fn, x, iters=iters, reps=max(runs // 4, 3))
    return time_fn(fn, x, runs=runs)


def benchmark_split_block(ch_in, ch_split, kernel, hw=(240, 426), runs=20, method="dispatch", iters=50,
                          device=None):
    """Latency (ms) of one split block at the config and resolution."""
    fwd, x = _split_block_forward(ch_in, ch_split, kernel, hw, device=device)
    return _measure(fwd, x, runs, method, iters)


def latency_grid(ch_in_choices=CH_IN_CHOICES, kernel_choices=(3, 5, 7)):
    """The (ch_in, ch_split, kernel) configs of ``build_latency_table``, in
    its row order: splits at max(round(ch_in·f), 1) for f in ¼, ½, ¾, 1."""
    return [(ch_in, max(int(round(ch_in * frac)), 1), k)
            for ch_in in ch_in_choices for frac in SPLIT_FRACTIONS for k in kernel_choices]


def build_latency_table(ch_in_choices=CH_IN_CHOICES, kernel_choices=(3, 5, 7), hw=(240, 426), runs=20,
                        out_path=None, progress=None, method="dispatch", iters=50, device=None):
    """Measure the config grid (``latency_grid``) → (N, 4) float32 table
    [ch_in, ch_split, kernel, ms], less each ch_in's zero-block ms and
    clamped at 0; saved to ``out_path`` (.npy) if given. ``progress(row)``
    sees each row. method="loop" times each config with ``time_fn_loop``,
    "dispatch" with ``time_fn``. ``device`` defaults to CUDA."""
    device = resolve_device(device)
    base_ms, rows = {}, []
    for ch_in, ch_split, k in latency_grid(ch_in_choices, kernel_choices):
        if ch_in not in base_ms:
            x = torch.zeros((1, *hw, ch_in), dtype=torch.float32, device=device)
            base_ms[ch_in] = _measure(lambda a: a * 1.0, x, runs, method, iters)
        ms = benchmark_split_block(ch_in, ch_split, k, hw, runs, method, iters, device)
        rows.append((ch_in, ch_split, k, max(ms - base_ms[ch_in], 0.0)))
        if progress:
            progress(rows[-1])
    table = np.asarray(rows, dtype=np.float32)
    if out_path:
        np.save(out_path, table)
    return table
