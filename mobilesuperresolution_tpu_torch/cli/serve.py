"""Streaming VSR serving entry (counterpart of
mobilesuperresolution_tpu/cli/serve.py).

Reads an ordered directory of frames, pushes them in arrival order through
``serve.StreamingVSR`` (windows are enqueued ahead of result fetches, outputs
leave with a bounded lookahead of chunk + overlap - 1 frames), writes SR PNGs
and prints one JSON line of end-to-end throughput/latency stats (end to end:
host decode, host-to-device, device-to-host and PNG encode included).
Several comma-separated input directories serve as lockstep streams batched
into one window. ``--flow_cache`` computes each SpyNet pair flow once and
reuses it across overlapping windows (``serve.FlowCachedStreamingVSR``,
BasicVSR only); ``--flow_downscale d`` runs SpyNet on 1/d-res frames.
``--model_type`` serves mobile BasicVSR ('basic'), the faithful BasicVSR
('basic_origin', also with ``--flow_cache``), the per-frame 'single' or the
searched 'multi' / 'multi_v1' (``--model_path`` its block_index.txt).
``--spatial_shards S`` splits each window's height into S shards with a
halo exchange at every propagation step (parallel/vsr_spatial.py, 'basic'
and 'basic_origin', plain or with ``--flow_cache``; flow dy clipped to
``--spatial_max_disp``), shard ``i`` on the process's card ``i`` mod the
visible cards. ``--quantize int8`` serves the int8 dynamic-range model (SpyNet and the
trunks, or 'multi''s and 'single''s convs, on kernel Q1; not 'multi_v1').
'basic_mv' is refused: it needs the codec's motion vectors beside each
frame, and serving reads RGB frames only.

    python -m mobilesuperresolution_tpu_torch.cli.serve --job_dir runs/serve \\
        --input_dir frames/ --bf16 --chunk_frames 4 --chunk_overlap 3 --flow_cache

Runs on CUDA unless ``--device cpu`` is given. ``--eval_model`` is an npz
or a reference / mmedit ``.pt`` / ``.pth`` (``common_cli.
load_vsr_eval_params``). The log goes to stdout and ``<job_dir>/result.log``.
"""

import argparse
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.cli.common_cli import load_vsr_eval_params
from mobilesuperresolution_tpu_torch.core.device import resolve_device
from mobilesuperresolution_tpu_torch.core.logging_tool import LoggingTool
from mobilesuperresolution_tpu_torch.core.utils import attr_extractor
from mobilesuperresolution_tpu_torch.data.io_cache import load_image, save_png
from mobilesuperresolution_tpu_torch.models import get_vsr_model
from mobilesuperresolution_tpu_torch.parallel.mesh import make_mesh
from mobilesuperresolution_tpu_torch.parallel.vsr_spatial import spatial_basicvsr_forward
from mobilesuperresolution_tpu_torch.serve import FlowCachedStreamingVSR, StreamingVSR, make_flow_sr_fns
from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

log = logging.getLogger("msr_torch.serve")


def build_parser():
    p = argparse.ArgumentParser(description="Streaming VSR serving (PyTorch/CUDA)")
    p.add_argument("--job_dir", type=str, required=True)
    p.add_argument("--input_dir", type=str, required=True,
                   help="Directory of ordered frames (sorted by name). Comma-separate "
                   "several directories to serve lockstep streams batched into one "
                   "window (outputs land in stream<i>/ subdirectories).")
    p.add_argument("--output_dir", type=str, default=None,
                   help="Where SR PNGs go (default: job_dir/serve).")
    p.add_argument("--model_type", default="basic",
                   choices=["basic", "basic_origin", "basic_mv", "single", "multi", "multi_v1"],
                   help="'basic_mv' is refused: it needs motion vectors, and frames are RGB.")
    p.add_argument("--model_path", type=str, default=None,
                   help="block_index.txt for the 'multi' and 'multi_v1' models.")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--eval_model", type=str, default=None,
                   help="Weights to serve: a JAX params .npz or a reference/mmedit .pt/.pth "
                   "(default: seeded random weights).")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute.")
    p.add_argument("--chunk_frames", type=int, default=0,
                   help="Output frames per window (0 = 4).")
    p.add_argument("--chunk_overlap", type=int, default=4,
                   help="Context frames on each side of a window.")
    p.add_argument("--flow_cache", action="store_true",
                   help="Compute each SpyNet pair flow once and reuse it across overlapping "
                   "windows (serve/flow_cache.py). Matches the plain stream to float tolerance.")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="int8 dynamic-range inference convs (the numerics class of the reference's int8 "
                   "TFLite deployment; kernel Q1 on the card).")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="Split each window's height into this many shards ('basic' / 'basic_origin'), shard i on "
                   "the visible card (own + i) mod n (one process serves).")
    p.add_argument("--spatial_max_disp", type=int, default=8,
                   help="Halo row budget of --spatial_shards: flow dy is clipped to +-this many rows.")
    p.add_argument("--flow_downscale", type=int, default=1,
                   help="Run SpyNet on 1/d-res frames and upsample the flow (1 = exact reference flows).")
    p.add_argument("--height", type=int, default=None,
                   help="Output height (default: input height x scale).")
    p.add_argument("--width", type=int, default=None,
                   help="Output width (default: input width x scale).")
    p.add_argument("--no_save", action="store_true",
                   help="Skip PNG writes (pure throughput measurement).")
    p.add_argument("--arrival_fps", type=float, default=0,
                   help="Pace input frames at this rate (0 = as fast as they decode).")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'.")
    return p


def main(argv=None):
    params = build_parser().parse_args(argv)
    LoggingTool(params.job_dir)
    log.info(attr_extractor(params))
    if params.model_type == "basic_mv":
        raise ValueError("serving 'basic_mv' needs the codec's motion vectors of every frame, and cli.serve reads "
                         "RGB frames with no motion-vector source; serve 'basic' or 'basic_origin' (SpyNet flows)")
    device = resolve_device(params.device)
    chunk = params.chunk_frames or 4
    dtype = torch.bfloat16 if params.bf16 else torch.float32
    model = get_vsr_model(params.model_type, scale=params.scale, compute_dtype=dtype, device=device,
                          flow_downscale=params.flow_downscale, block_index_path=params.model_path,
                          quantized=params.quantize == "int8")
    if params.eval_model:
        load_vsr_eval_params(params.eval_model, params.model_type, model)
    else:
        load_params_npz(model, random_jax_params(model, params.seed))

    in_dirs = [d for d in params.input_dir.split(",") if d]
    per_stream_names = []
    for d in in_dirs:
        names = sorted(f for f in os.listdir(d) if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
        if not names:
            raise SystemExit(f"no frames in {d}")
        per_stream_names.append(names)
    n_frames = min(len(n) for n in per_stream_names)
    n_streams = len(in_dirs)
    h, w, c = load_image(os.path.join(in_dirs[0], per_stream_names[0][0])).shape
    out_h = params.height or h * params.scale
    out_w = params.width or w * params.scale

    mesh = make_mesh(spatial=params.spatial_shards, device=device) if params.spatial_shards > 1 else None

    def apply_fn(x, oh, ow):
        with torch.inference_mode():
            if mesh is not None:
                return spatial_basicvsr_forward(model, x, oh, ow, mesh, max_disp=params.spatial_max_disp)
            return model(x, oh, ow)

    if params.flow_cache:
        flow_fn, sr_fn = make_flow_sr_fns(model, out_h, out_w, mesh=mesh, max_disp=params.spatial_max_disp)
        stream = FlowCachedStreamingVSR(flow_fn, sr_fn, out_h, out_w, chunk=chunk, overlap=params.chunk_overlap,
                                        num_streams=n_streams, device=device)
    else:
        stream = StreamingVSR(apply_fn, out_h, out_w, chunk=chunk, overlap=params.chunk_overlap,
                              num_streams=n_streams, device=device)
    stream.warmup((h, w, c))

    out_dir = params.output_dir or os.path.join(params.job_dir, "serve")
    stream_dirs = [out_dir] if n_streams == 1 else [os.path.join(out_dir, f"stream{i}") for i in range(n_streams)]
    if not params.no_save:
        for d in stream_dirs:
            os.makedirs(d, exist_ok=True)

    emitted = 0  # emitted time steps (each carries n_streams frames)
    push_times = []
    emit_lat = []
    # PNG encode on a writer pool and decode of the next frame on one worker
    # keep host IO off the critical path; fps includes the writers' drain
    writers = ThreadPoolExecutor(max_workers=2)
    decoder = ThreadPoolExecutor(max_workers=1)
    pending_writes = []

    def emit(steps):
        nonlocal emitted
        now = time.perf_counter()
        for fr in steps:
            emit_lat.append(now - push_times[emitted])
            if not params.no_save:
                per_stream = fr[None] if fr.ndim == 3 else fr
                for d, sfr in zip(stream_dirs, per_stream):
                    pending_writes.append(writers.submit(save_png, os.path.join(d, f"{emitted:08d}.png"), sfr))
            emitted += 1

    def decode(i):
        return np.stack([
            load_image(os.path.join(d, names[i])).astype(np.float32) / 255.0
            for d, names in zip(in_dirs, per_stream_names)
        ])

    try:
        t0 = time.perf_counter()
        next_frame = decoder.submit(decode, 0)
        for i in range(n_frames):
            frame = next_frame.result()
            if i + 1 < n_frames:
                next_frame = decoder.submit(decode, i + 1)
            if params.arrival_fps > 0:
                delay = t0 + i / params.arrival_fps - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            push_times.append(time.perf_counter())
            emit(stream.push(frame if n_streams > 1 else frame[0]))
        emit(stream.flush())
        for f in pending_writes:
            f.result()  # surface write errors; the drain counts in the wall time
        wall = time.perf_counter() - t0
    finally:
        writers.shutdown()
        decoder.shutdown()
    if emitted != n_frames:
        raise RuntimeError(f"emitted {emitted} of {n_frames} frames")

    stats = {
        "streams": n_streams,
        "frames": emitted * n_streams,
        "arrival_fps": params.arrival_fps or None,
        "fps_end_to_end": round(emitted * n_streams / wall, 2),
        "latency_p50_ms": round(1e3 * float(np.percentile(emit_lat, 50)), 1),
        "latency_p95_ms": round(1e3 * float(np.percentile(emit_lat, 95)), 1),
        "lookahead_frames": chunk + params.chunk_overlap - 1,
        "out": None if params.no_save else out_dir,
    }
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
