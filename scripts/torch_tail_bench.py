"""Time kernels B1 (csrc/conv5x5.cu) and B2 (csrc/fused_tail.cu) at their
main-path shapes, and the full-width window forward that runs them, for the
checkout given by ``--root``, so that two commits can be held against each
other on one card in one run:

    python3 scripts/torch_tail_bench.py --root old_checkout
    python3 scripts/torch_tail_bench.py --root .

B1: SpyNet's five finest-level space-to-depth convs of one BasicVSR window,
(18, 128, 224) bf16, 32->128, 128->256, 256->128, 128->64 (ReLU) and 64->8,
the cases ``chip_smoke.py`` reports as B1's main path. B2: BasicVSR x4's
reconstruction tail, (10, 240, 426, 48) bf16, 2x2 conv with padding
((1, 2), (1, 2)), s = 4, cropped to 961x1705; and at the zoo's shapes
(``b2_more_ms``): 'multi''s decode at the serving window, (10, 240, 426,
18) 3x3 s 4 bf16, the VSR training step's tail (20, 64, 64, 48) in f32 and
bf16, and 'basic_origin''s upconv1 (10, 240, 426, 64) 3x3 s 2 to 256 conv
channels with the leaky ReLU, bf16 (null for a checkout whose B2 does not
take it), and the f32 routes of the VSR training step: 'basic_origin''s
upconv1 and upconv2, (20, 64, 64, 64) and (20, 128, 128, 64) 3x3 s 2 to 256
conv channels with the leaky ReLU, f32. B1 f32 (``b1_f32_ms``): the
training step's 30 SpyNet convs, 36 samples at 32x32 down to 1x1, each
timed (3 repeats of 10 calls), summed per level and over the 30. The f32 VSR
step (``vsr_step_f32``): chip_smoke.py's ``vsr_step_stats`` on BasicVSR x4
(nf 24, 8 blocks, f32, seeded weights) at the launcher's shape, batch 2 x
10 frames of 64x64. Window: BasicVSR x4 (nf 24,
8 blocks, bf16, seeded random weights) on chip_smoke.py's 10 synthetic
426x240 frames, as chip_smoke.py times it. Prints one JSON line with, per
case, the mean ms of 20 calls (B2: 50, window: 5; CUDA events) in each of 5
repeats and the mean over all of them, the card's name and power limit, and
the kernels' registers and spills from the build logs (chip_smoke.py's
ptxas_summary). Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B1_CASES = [(32, 128, True), (128, 256, True), (256, 128, True), (128, 64, True), (64, 8, False)]


def repeats(call, n_repeats=5, iters=20):
    out = []
    for _ in range(n_repeats):
        for _ in range(3):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose mobilesuperresolution_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from mobilesuperresolution_tpu_torch.kernels import _build
    from mobilesuperresolution_tpu_torch.kernels import conv5x5 as b1
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    # this checkout's chip_smoke.py: frames and the ptxas summary (the port's
    # package is imported from --root above, so its submodules stay root's)
    sys.path.append(REPO)
    from chip_smoke import H_LR, OH, OW, T_WIN, VSR_PATCH, VSR_SCALE, W_LR, ptxas_summary, synthetic_stream
    from chip_smoke import vsr_step_stats

    if not torch.cuda.is_available():
        print("torch_tail_bench: CUDA is not available", file=sys.stderr)
        return 1
    _build.build(("conv5x5", "fused_tail"))
    # float32 as the port's CLIs run it (core/device.py::no_tf32): cuDNN's
    # convs in the f32 VSR step in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def rand(shape, scale=1.0, dtype=torch.bfloat16):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    report = {"root": args.root, "b1_ms": {}, "checksum": {}}
    for cin, cout, relu in B1_CASES:
        x = rand((18, 128, 224, cin))
        wt = rand((5, 5, cin, cout), (25 * cin) ** -0.5)
        b = rand((cout,), 0.1, torch.float32)
        # the main path passes the weights packed once (SpyNet's prepare);
        # a checkout without packing takes HWIO only
        kw = {"w_packed": b1.pack_weights(wt)} if hasattr(b1, "pack_weights") and cout % 64 == 0 else {}
        out = b1.conv5x5_same(x, wt, b, relu, **kw)
        torch.cuda.synchronize()
        key = f"{cin}->{cout}"
        report["b1_ms"][key] = repeats(lambda: b1.conv5x5_same(x, wt, b, relu, **kw))
        report["checksum"][f"b1 {key}"] = float(out.float().sum())
    report["b1_sum_ms"] = sum(sum(r) / len(r) for r in report["b1_ms"].values())

    # B1 f32: the VSR training step's 30 SpyNet convs, 36 samples, level by level
    report["b1_f32_ms"], report["b1_f32_level_ms"] = {}, {}
    for lvl in range(6):
        lh = (VSR_PATCH // 2) >> lvl
        level = 0.0
        for cin, cout, relu in B1_CASES:
            x = rand((36, lh, lh, cin), 1.0, torch.float32)
            wt = rand((5, 5, cin, cout), (25 * cin) ** -0.5, torch.float32)
            b = rand((cout,), 0.1, torch.float32)
            # packed once where the checkout packs f32 weights (SpyNet's prepare)
            kw = {"w_packed": b1.pack_weights_f32(wt)} if hasattr(b1, "pack_weights_f32") and cout % 64 == 0 else {}
            out = b1.conv5x5_same(x, wt, b, relu, **kw)
            torch.cuda.synchronize()
            key = f"{lh}x{lh} {cin}->{cout}"
            report["b1_f32_ms"][key] = repeats(lambda: b1.conv5x5_same(x, wt, b, relu, **kw), n_repeats=3, iters=10)
            report["checksum"][f"b1 f32 {key}"] = float(out.sum())
            level += sum(report["b1_f32_ms"][key]) / 3
        report["b1_f32_level_ms"][f"{lh}x{lh}"] = level
    report["b1_f32_sum_ms"] = sum(report["b1_f32_level_ms"].values())

    n, h, w, c, s = 10, 240, 426, 48, 4
    x = rand((n, h, w, c))
    kern = rand((2, 2, c, c), 1 / 14)
    b = rand((c,), 0.1)

    def tail():
        return fused_conv_pixel_shuffle(x, kern, b, s, ((1, 2), (1, 2)), (4 * h + 1, 4 * w + 1))

    out = tail()
    torch.cuda.synchronize()
    report["b2_ms"] = repeats(tail, iters=50)
    report["b2_ms_mean"] = sum(report["b2_ms"]) / len(report["b2_ms"])
    report["checksum"]["b2"] = float(out.float().sum())

    more = {"serve_multi_decode_bf16": (10, 240, 426, 18, 3, 4, 48, ((1, 1), (1, 1)), None, torch.bfloat16),
            "train_tail_f32": (20, 64, 64, 48, 2, 4, 48, ((1, 2), (1, 2)), (257, 257), torch.float32),
            "train_tail_bf16": (20, 64, 64, 48, 2, 4, 48, ((1, 2), (1, 2)), (257, 257), torch.bfloat16),
            "upconv1_bf16": (10, 240, 426, 64, 3, 2, 256, ((1, 1), (1, 1)), None, torch.bfloat16),
            "upconv1_f32": (20, 64, 64, 64, 3, 2, 256, ((1, 1), (1, 1)), None, torch.float32),
            "upconv2_f32": (20, 128, 128, 64, 3, 2, 256, ((1, 1), (1, 1)), None, torch.float32)}
    report["b2_more_ms"] = {}
    for name, (n2, h2, w2, cin, k, s2, cc, pad, crop, dt) in more.items():
        x2 = rand((n2, h2, w2, cin), 1.0, dt)
        kern2 = rand((k, k, cin, cc), (k * k * cin) ** -0.5, dt)
        b2 = rand((cc,), 0.1, dt)
        extra = (True,) if name.startswith("upconv") else ()  # the fused leaky ReLU
        try:
            fused_conv_pixel_shuffle(x2, kern2, b2, s2, pad, crop, *extra)
        except (TypeError, ValueError):  # a B2 that does not take this shape
            report["b2_more_ms"][name] = None
            continue
        report["b2_more_ms"][name] = repeats(lambda: fused_conv_pixel_shuffle(x2, kern2, b2, s2, pad, crop, *extra),
                                             iters=10 if name.startswith("upconv2") else 50)

    model = get_vsr_model("basic", scale=4, compute_dtype=torch.bfloat16, device=dev)
    load_params_npz(model, random_jax_params(model, seed=0))
    frames = torch.from_numpy(np.stack(synthetic_stream(T_WIN, H_LR, W_LR, seed=0))[None]).to(dev)
    with torch.inference_mode():
        report["window_ms"] = repeats(lambda: model(frames, OH, OW), iters=5)
    report["window_ms_mean"] = sum(report["window_ms"]) / len(report["window_ms"])
    del model
    # the f32 VSR training step (B1 30 and B2 once per forward)
    model = get_vsr_model("basic", scale=VSR_SCALE, compute_dtype=torch.float32, device=dev)
    load_params_npz(model, random_jax_params(model, seed=0))
    st = vsr_step_stats(model, dev)
    report["vsr_step_f32"] = {k: st[k] for k in ("ms", "profiled_device_ms", "busy_share", "kernel_launches",
                                                 "launches_per_step", "top_kernels")}
    report["ptxas"] = {name: ptxas_summary(os.path.join(_build.BUILD_DIR, f"{name}.log"))
                       for name in ("conv5x5", "fused_tail")}
    report["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
