"""Streaming driver: lockstep streams pushed in a closed loop through the
port's serving entry (``cli/serve.py::make_stream``), each delivered HR frame
timed and a seeded sample of them checked against the plain reference.

Traffic keys: ``streams``; ``lr_hw`` and ``out_hw``; ``chunk`` and
``overlap`` (the window scheme); ``flow_cache`` and ``flow_downscale``;
``dtype``
(``float32`` as ``cli.serve`` runs by default, ``bfloat16`` as with
``--bf16``) and ``quantize`` (``int8`` as ``--quantize int8``, default
none); the clip pool (``clips`` of ``clip_frames`` frames, ``motions``);
``warm_windows`` delivered in set-up; ``check_windows``, the windows of the
measured window drawn for the check (besides the stream's first window, whose
left edge is replicated, and its last, flushed with the right edge
replicated).

Set-up: the model and its seeded weights, the stream and its ``warmup``,
the pool, then the stream's first ``warm_windows`` windows, so every shape
has run before the window opens. In the window the next frame is pushed as
soon as ``push`` returns. A frame's latency runs from the push of the last
input frame its window needs (``chunk + overlap - 1`` frames after the
window's first kept frame, the lookahead that arrival sets) to the return
of the ``push`` that delivered it.
"""

import time

import numpy as np

from benchmark.harness import cell as cells
from benchmark.harness import counts
from benchmark.harness import traffic as inputs
from benchmark.harness import trace as tracing
from benchmark.harness import weights
from benchmark.reference import basicvsr as ref


BLOCK = 32  # pixels a side of the blocks whose mean error rel_err_32 reports


class _Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length,
    drawn from ``rng`` (reservoir sampling)."""

    def __init__(self, k, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


def run(cell):
    import torch

    from mobilesuperresolution_tpu_torch.cli.serve import make_stream
    from mobilesuperresolution_tpu_torch.models import get_vsr_model

    tr, cfg, dev = cell.traffic, cell.config, cell.device
    on_card = dev.type == "cuda"
    s_n, (h, w), (oh, ow) = tr["streams"], tr["lr_hw"], tr["out_hw"]
    chunk, overlap = tr["chunk"], tr["overlap"]
    need_after = chunk + overlap - 1  # the last input a window needs, after its first kept frame

    pool = inputs.clip_pool(cell.seed, tr["clips"], tr["clip_frames"], h, w, tr["motions"])
    orders = inputs.stream_orders(cell.seed, s_n, tr["clips"])
    model = get_vsr_model(cfg["model_type"], scale=cfg["scale"], compute_dtype=getattr(torch, tr["dtype"]),
                          device=dev, flow_downscale=tr["flow_downscale"], quantized=tr.get("quantize") == "int8")
    params = weights.make(cfg, cell.seed, dev)
    weights.load_into(model, params)
    stream = make_stream(model, None, oh, ow, chunk, overlap, s_n, dev, flow_cache=tr["flow_cache"])
    stream.warmup((h, w, 3))

    push_t = []  # push time of every stream index
    kept = {}  # window id -> [frames (S, OH, OW, 3)] while it fills
    sample = _Reservoir(tr["check_windows"], np.random.default_rng([cell.seed, 4]))
    state = {"delivered": 0, "phase": "setup", "lat": [], "in_window": 0}

    def take(frames, t_ret):
        """Record delivered frames: their latency in the window; the frames
        of the stream's first window, of the windows the sample draws in
        the window, and of the windows ``flush`` delivers."""
        for fr in frames:
            k = state["delivered"]
            state["delivered"] += 1
            wid = k // chunk
            phase = state["phase"]
            if phase == "window":
                state["lat"].append(t_ret - push_t[wid * chunk + need_after])
                state["in_window"] += 1
            if wid == 0 or phase != "setup":
                kept.setdefault(wid, []).append(fr if fr.ndim == 4 else fr[None])
            if phase == "window" and len(kept[wid]) == chunk:
                sample.offer((wid, kept.pop(wid)))

    def push(k):
        frame = inputs.stream_frame(pool, orders, k)
        push_t.append(time.perf_counter())
        out = stream.push(frame)
        t_ret = time.perf_counter()
        take(out, t_ret)
        return t_ret

    trace = tracing.Trace() if cell.trace else None
    if trace:
        trace.arm()
    k = 0
    while state["delivered"] < tr["warm_windows"] * chunk:
        push(k)
        k += 1
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_process
    first_k = k
    state["phase"] = "window"
    if trace:
        trace.begin()
    delivered_before = state["delivered"]
    t_end = t0
    while t_end - t0 < cell.seconds:
        t_end = push(k)
        k += 1
    if trace:
        trace.end()
    state["phase"] = "flush"
    window_s = t_end - t0
    n_pushed = k
    # windows dispatched in the window: one at each push of a window's last needed frame
    dispatched = sum(1 for i in range(first_k, n_pushed) if i >= need_after and (i - need_after) % chunk == 0)
    harvested = state["delivered"] - delivered_before

    tail = stream.flush()
    take(tail, time.perf_counter())
    if state["delivered"] != n_pushed:
        raise RuntimeError(f"pushed {n_pushed} frames, delivered {state['delivered']}")
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    del stream, model
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the first window, the sample, and the last window flush delivered
    last_wid = (n_pushed - 1) // chunk
    to_check = sorted([(0, kept[0]), (last_wid, kept[last_wid])] + sample.items, key=lambda item: item[0])
    checks, notes = compare(cell, params, pool, orders, to_check, n_pushed)
    lat = state["lat"]
    result = {
        "end_to_end": {
            "frames_per_s": state["in_window"] * s_n / window_s,
            "frame_latency_p95_ms": 1e3 * cells.quantile(lat, 0.95) if lat else None,
            "setup_s": setup_s,
        },
        "attempted": dispatched * chunk * s_n,
        "failed": 0,
        "memory_peak_bytes": memory_peak,
        "checks": checks,
        "notes": dict(notes, frames_in_window=state["in_window"] * s_n, window_s=window_s,
                      latency_p50_ms=1e3 * cells.quantile(lat, 0.5) if lat else None, pushed=n_pushed * s_n),
    }
    if trace:
        flops, _, b1_s, b2_s = counts.serve_window(cell.config, cell.traffic)
        result["trace"] = {
            "events": trace.events, "window_s": trace.window_s, "busy_s": tracing.busy_seconds(trace.events),
            "breakdown": tracing.breakdown(trace.events), "windows": dispatched,
            "frames": dispatched * chunk * s_n, "frames_harvested": harvested * s_n,
            "useful_flops": dispatched * flops,
            "b1_least_s": dispatched * b1_s, "b2_least_s": dispatched * b2_s, "dtype": tr["dtype"],
            "latency_p95_ms": result["end_to_end"]["frame_latency_p95_ms"],
        }
    return result


def compare(cell, params, pool, orders, windows, n_pushed):
    """The reference's frames of each checked window against the delivered
    ones: (checks, notes). The reference runs in float32 with TF32 off on the
    window's frames, edges replicated as the window scheme asks,
    reconstructing the kept frames only.

    The compared number, ``rel_err``: the root mean square of the error over
    every pixel of every checked frame, over the root mean square of the
    detail the reference adds to the bilinear base (the detail's scale takes
    out how much a seed's weights amplify rounding). A per-pixel number, so
    an error whose mean is about zero over a block (sub-pixels out of order,
    a one-pixel shift) counts in full. ``rel_err_32`` (the same over the
    error's means over blocks of ``BLOCK`` x ``BLOCK`` pixels),
    ``max_abs_err`` and ``rms_err`` are reported beside it."""
    import torch
    import torch.nn.functional as F

    tr, dev = cell.traffic, cell.device
    chunk, overlap = tr["chunk"], tr["overlap"]
    block = min(BLOCK, *tr["out_hw"])
    saved = ref.set_full_float32()
    acc = {"max": 0.0, "sq": 0.0, "n": 0, "sq_block": 0.0, "n_block": 0, "sq_detail": 0.0}
    try:
        with torch.no_grad():
            for wid, frames in windows:
                start = wid * chunk
                last = min(start + chunk + overlap - 1, n_pushed - 1)
                idx = ref.window_indices(start, chunk, overlap, last)
                lrs = np.stack([inputs.stream_frame(pool, orders, i) for i in idx], axis=1)  # (S, T, h, w, 3)
                lrs = torch.from_numpy(lrs).to(dev).permute(0, 1, 4, 2, 3)
                kept = range(overlap, overlap + len(frames))
                want = ref.forward(params, cell.config, lrs, tr["out_hw"], tr["flow_downscale"], keep=kept).flatten(0, 1)
                base = ref.resize(lrs[:, kept].flatten(0, 1), tr["out_hw"])
                got = torch.from_numpy(np.stack(frames, axis=1)).to(dev).permute(0, 1, 4, 2, 3).flatten(0, 1)
                diff = got.double() - want.double()
                acc["max"] = max(acc["max"], float(diff.abs().max()))
                acc["sq"] += float((diff * diff).sum())
                acc["n"] += diff.numel()
                means = F.avg_pool2d(diff, block)
                acc["sq_block"] += float((means * means).sum())
                acc["n_block"] += means.numel()
                acc["sq_detail"] += float((want.double() - base.double()).pow(2).sum())
    finally:
        ref.restore_float32(saved)
    detail = (acc["sq_detail"] / acc["n"]) ** 0.5
    stats = {"rel_err": (acc["sq"] / acc["n"]) ** 0.5 / detail,
             "rel_err_32": (acc["sq_block"] / acc["n_block"]) ** 0.5 / detail,
             "max_abs_err": acc["max"], "rms_err": (acc["sq"] / acc["n"]) ** 0.5}
    checks = [cells.check(name, stats[name], limit) for name, limit in cell.limits.items()]
    return checks, {"checked_windows": [wid for wid, _ in windows], "checked_values": acc["n"], "errors": stats}

