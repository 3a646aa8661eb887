"""Where the time of one full-width WDSR-B x2 image goes, on the GPU.

    python3 scripts/torch_sisr_profile.py

Builds the port's WDSR-B x2 (16 blocks, 24 units) with seeded random weights,
as chip_smoke.py does, and times one 678x1020 → 1356x2040 image forward, in
float32 and in bf16: its stages with CUDA events (mean subtraction + head
conv, the 16 B3 blocks, the B4 tail), then one profiled forward
(torch.profiler, device time by kernel name) and the peak device memory.
The device's busy share is the profiled kernel time over the unprofiled
forward time. Then the same for one SISR training step at the pretraining
launcher's width (batch 16, 48x48 LR patches; make_sisr_step with Adam):
the forward, the forward and backward, and the whole step with CUDA events,
one profiled step, its busy share and its kernel launches. Prints a summary
and writes everything to chiprun_out/sisr_profile.json. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SR_BLOCKS, SR_HR, SR_SCALE, SR_UNITS, TRAIN_BATCH, TRAIN_PATCH, cuda_ms  # noqa: E402


def profile(model, x):
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle_skip

    with torch.inference_mode():
        xm = x.to(model.compute_dtype) - model.image_mean
        y = model.WNConv_0(xm)
        blocks = model.blocks()

        def body():
            z = y
            for blk in blocks:
                z = blk(z)
            return z

        feats = body()

        def tail():
            return fused_conv_pixel_shuffle_skip(feats, model.WNConv_1.kernel, model._tail_bias, model.scale,
                                                 xm.contiguous(), model.WNConv_2.kernel,
                                                 packed=model._tail_packed)

        torch.cuda.reset_peak_memory_stats()
        stages = {
            "forward": cuda_ms(lambda: model(x), iters=10, warmup=2),
            "head (mean + WNConv 3x3)": cuda_ms(lambda: model.WNConv_0(x.to(model.compute_dtype) - model.image_mean),
                                                iters=10, warmup=2),
            f"body ({len(blocks)} x B3)": cuda_ms(body, iters=10, warmup=2),
            "tail (B4)": cuda_ms(tail, iters=10, warmup=2),
        }
        peak = torch.cuda.max_memory_allocated() / 2**30
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model(x)
            torch.cuda.synchronize()

    rows, busy = kernel_rows(prof)
    return {"stages_ms": stages, "peak_mem_gib": peak, "profiled_device_ms": busy,
            "busy_share": busy / stages["forward"], "kernels": rows[:15]}


def kernel_rows(prof):
    """Device time by kernel name (device-side events only: an aten op's
    entry repeats its kernels' time), and their sum in ms."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(({"name": e.key[:90], "count": e.count, "device_ms": dev_us(e) / 1e3} for e in kernels),
                  key=lambda r: -r["device_ms"])
    return rows, sum(r["device_ms"] for r in rows)


def profile_train(model):
    """One training step at the launcher's width: stages by CUDA events, one
    profiled step, its busy share and launches."""
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters
    from mobilesuperresolution_tpu_torch.train.losses import l1_loss
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

    g = torch.Generator().manual_seed(6)
    lr = torch.rand((TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3), generator=g).cuda()
    hr = torch.rand((TRAIN_BATCH, SR_SCALE * TRAIN_PATCH, SR_SCALE * TRAIN_PATCH, 3), generator=g).cuda()
    model.train()
    step = make_sisr_step(model, multistep_adam(jax_named_parameters(model), 1e-3, 100, 1))

    def fwd_bwd():
        l1_loss(model(lr), hr).backward()

    stages = {
        "forward + loss": cuda_ms(lambda: l1_loss(model(lr), hr), iters=10, warmup=2),
        "forward + backward": cuda_ms(fwd_bwd, iters=10, warmup=2),
        "step (+ guard, Adam)": cuda_ms(lambda: step((lr, hr)), iters=10, warmup=3),
    }
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step((lr, hr))
        torch.cuda.synchronize()
    rows, busy = kernel_rows(prof)
    return {"stages_ms": stages, "profiled_device_ms": busy, "launches": sum(r["count"] for r in rows),
            "busy_share": busy / stages["step (+ guard, Adam)"], "kernels": rows[:15]}


def main():
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    from mobilesuperresolution_tpu_torch.data.imresize import imresize_np
    from mobilesuperresolution_tpu_torch.data.synthetic import synthetic_image
    from mobilesuperresolution_tpu_torch.models import get_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    lr = imresize_np(synthetic_image(10, SR_HR), scalar_scale=1.0 / SR_SCALE)
    x = torch.from_numpy(lr.astype(np.float32) / 255.0)[None].cuda()
    report = {"card": card, "lr_shape": list(x.shape)}
    print(f"card: {card}; LR {tuple(x.shape)}")
    for name, bf16 in (("f32", False), ("bf16", True)):
        params = argparse.Namespace(model_type="BASIC_MODEL", num_blocks=SR_BLOCKS, num_residual_units=SR_UNITS,
                                    scale=SR_SCALE, bf16=bf16)
        model = get_model(params)
        load_params_npz(model, random_jax_params(model, seed=0))
        r = report[name] = profile(model, x)
        print(f"{name}:")
        for k, v in r["stages_ms"].items():
            print(f"  {k:26s} {v:9.3f} ms")
        print(f"  device busy {r['profiled_device_ms']:.3f} ms of {r['stages_ms']['forward']:.3f} ms "
              f"({r['busy_share']:.1%}); peak {r['peak_mem_gib']:.3f} GiB")
        for k in r["kernels"][:8]:
            print(f"  {k['device_ms']:8.3f} ms  x{k['count']:<5d} {k['name']}")
        t = report[f"train_{name}"] = profile_train(model)
        print(f"{name} training step, batch {TRAIN_BATCH}, {TRAIN_PATCH}x{TRAIN_PATCH}:")
        for k, v in t["stages_ms"].items():
            print(f"  {k:26s} {v:9.3f} ms")
        print(f"  device busy {t['profiled_device_ms']:.3f} ms of {t['stages_ms']['step (+ guard, Adam)']:.3f} ms "
              f"({t['busy_share']:.1%}), {t['launches']} kernel launches")
        for k in t["kernels"][:8]:
            print(f"  {k['device_ms']:8.3f} ms  x{k['count']:<5d} {k['name']}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sisr_profile.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
