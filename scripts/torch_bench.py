"""Headline benchmark of the PyTorch/CUDA port: 1080p x4 video super-resolution
throughput on one GPU.

    python3 scripts/torch_bench.py

Times the program bench.py times for the JAX package: BasicVSR x4 (mobile
configuration, nf 24, 8 blocks) on a 10-frame 426x240 → 1920x1080 window in
bfloat16, with seeded random weights through the JAX-checkpoint bridge.
``value`` is T over the MEAN of the timed window forwards (CUDA events, 15
forwards in three runs of five, after two warm-up forwards), in frames/s;
``vs_baseline`` is value / 30, as bench.py computes it.

An earlier line gives the flow-cached steady state (serve/flow_cache.py, chunk
4): one window forward with its flows given (``sr_fn``) plus SpyNet on one
group of 4 new pairs (``flow_fn``), in ms and as output frames/s (4 frames
per window), beside the plain window. The card's name and power limit are
printed too. The last line is one JSON object:
{"metric", "value", "unit", "vs_baseline"}. Needs CUDA.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import CHUNK, H_LR, OH, OW, T_WIN, W_LR, cuda_ms, synthetic_stream  # noqa: E402


def mean_ms(fn, runs=3, iters=5, warmup=2):
    """The mean ms of ``runs`` x ``iters`` calls (CUDA events), with each
    run's mean."""
    per_run = [cuda_ms(fn, iters=iters, warmup=warmup if i == 0 else 0) for i in range(runs)]
    return sum(per_run) / runs, per_run


def main():
    if not torch.cuda.is_available():
        print("torch_bench: CUDA is not available", file=sys.stderr)
        return 1
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.models.basicvsr import compute_flows
    from mobilesuperresolution_tpu_torch.serve import make_flow_sr_fns
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    model = get_vsr_model("basic", scale=4, compute_dtype=torch.bfloat16)
    load_params_npz(model, random_jax_params(model, seed=0))
    x = torch.from_numpy(np.stack(synthetic_stream(T_WIN, H_LR, W_LR, seed=0))[None]).cuda()
    flow_fn, sr_fn = make_flow_sr_fns(model, OH, OW)
    with torch.inference_mode():
        out = model(x, OH, OW)
        if tuple(out.shape) != (1, T_WIN, OH, OW, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"window output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
        window_ms, window_runs = mean_ms(lambda: model(x, OH, OW))
        ff, fb = compute_flows(model.spynet, x.to(torch.bfloat16))
        sr_ms, _ = mean_ms(lambda: sr_fn(x, ff, fb))
        # one group: CHUNK pairs x 2 directions, laid out as the cache lays it out
        ab = x[0, : 2 * CHUNK]
        ba = torch.cat([ab[CHUNK:], ab[:CHUNK]])
        flow_ms, _ = mean_ms(lambda: flow_fn(ab, ba))
    cached_ms = sr_ms + flow_ms
    print(json.dumps({
        "card": card, "window_ms": window_ms, "window_runs_ms": window_runs, "window_fps": T_WIN / window_ms * 1e3,
        "cached_sr_fn_ms": sr_ms, "cached_flow_fn_ms_per_group": flow_ms, "cached_window_ms": cached_ms,
        "stream_frames_per_window": CHUNK, "plain_stream_fps": CHUNK / window_ms * 1e3,
        "cached_stream_fps": CHUNK / cached_ms * 1e3,
    }))
    fps = T_WIN / window_ms * 1e3
    print(json.dumps({"metric": "basicvsr_1080p_x4_fps_torch", "value": round(fps, 2), "unit": "frames/s",
                      "vs_baseline": round(fps / 30.0, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
