"""Where the time of one full-width NAS search step, and of one 678x1020
supernet eval forward, goes on the GPU.

    python3 scripts/torch_search_profile.py

Builds the port's supernet at the search launcher's width (x2, 16 blocks,
32 units, float32, TF32 off) with seeded random weights, as chip_smoke.py
does, and times with CUDA events: the forward with autograd on, the forward
+ backward, Adam's update alone, and the whole search step (batch 16, 48x48
patches); then one 678x1020 eval forward and its 48 B5 launches alone.
Then one profiled step and one profiled eval forward (torch.profiler,
device time and launch count by kernel name). The device's busy share is
the profiled kernel time over the unprofiled time. Prints a summary and
writes everything to chiprun_out/search_profile.json. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import NAS_BATCH, NAS_BLOCKS, NAS_PATCH, NAS_UNITS, SR_HR, cuda_ms  # noqa: E402


def kernel_table(fn):
    """Device time and launches by kernel name over one call of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side kernels only: an aten op's entry repeats its kernels' time,
    # and a user annotation (Adam's "Optimizer.step" range) is no kernel
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    rows = sorted(({"name": e.key[:90], "count": e.count, "device_ms": dev_us(e) / 1e3} for e in kernels),
                  key=lambda r: -r["device_ms"])
    return {"device_ms": sum(r["device_ms"] for r in rows), "launches": sum(r["count"] for r in rows),
            "kernels": rows[:15]}


def main():
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    from mobilesuperresolution_tpu_torch.kernels.fused_convsep import fused_convsep
    from mobilesuperresolution_tpu_torch.models import get_model
    from mobilesuperresolution_tpu_torch.nas.speed_estimator import get_ori_speed
    from mobilesuperresolution_tpu_torch.nas.speed_loss import SpeedLoss
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters
    from mobilesuperresolution_tpu_torch.train.losses import l1_loss
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_search_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    params = argparse.Namespace(model_type="NAS_MODEL", num_blocks=NAS_BLOCKS, num_residual_units=NAS_UNITS,
                                scale=2, seed=0, width_search=True)
    model = get_model(params)
    g = torch.Generator().manual_seed(5)
    lr = torch.rand((NAS_BATCH, NAS_PATCH, NAS_PATCH, 3), generator=g).cuda()
    hr = torch.rand((NAS_BATCH, 2 * NAS_PATCH, 2 * NAS_PATCH, 3), generator=g).cuda()
    ori = get_ori_speed(NAS_BLOCKS, NAS_UNITS)
    loss_fn = SpeedLoss(scale=ori - 500.0)
    opt = multistep_adam(jax_named_parameters(model), 1e-3, 100, 1)
    step = make_search_step(model, opt, loss_fn)

    def forward():
        sr, speed = model(lr)
        return l1_loss(sr, hr) + loss_fn(speed, 500.0, gamma=0.1)

    def forward_backward():
        model.zero_grad(set_to_none=True)
        forward().backward()

    torch.cuda.reset_peak_memory_stats()
    stages = {
        "forward (autograd on)": cuda_ms(forward, iters=10, warmup=3),
        "forward + backward": cuda_ms(forward_backward, iters=10, warmup=3),
        "Adam update": cuda_ms(opt.opt.step, iters=10, warmup=3),
        "search step": cuda_ms(lambda: step((lr, hr), 500.0), iters=10, warmup=3),
    }
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_prof = kernel_table(lambda: step((lr, hr), 500.0))

    x = torch.rand((1, SR_HR[0] // 2, SR_HR[1] // 2, 3), generator=g).cuda()
    with torch.inference_mode():
        branches = [getattr(b, f"branch_{k}") for b in model.blocks() for k in (3, 5, 7)]
        weights = [(br.WNConv_0.effective_kernel()[:, :, 0, :].contiguous(), br.WNConv_0.b,
                    br.WNConv_1.effective_kernel()[0, 0].contiguous(), br.WNConv_1.b) for br in branches]
        feat = torch.rand((1, *x.shape[1:3], NAS_UNITS), generator=g).cuda()

        def b5_only():
            for w in weights:
                fused_convsep(feat, *w)

        torch.cuda.reset_peak_memory_stats()
        eval_stages = {"eval forward": cuda_ms(lambda: model(x), iters=5, warmup=2),
                       "48 x B5 alone": cuda_ms(b5_only, iters=5, warmup=2)}
        eval_peak = torch.cuda.max_memory_allocated() / 2**30
        eval_prof = kernel_table(lambda: model(x))

    report = {"card": card, "batch": [NAS_BATCH, NAS_PATCH, NAS_PATCH], "step_stages_ms": stages,
              "step_peak_mem_gib": peak, "step_profile": step_prof,
              "step_busy_share": step_prof["device_ms"] / stages["search step"],
              "eval_shape": list(x.shape), "eval_stages_ms": eval_stages, "eval_peak_mem_gib": eval_peak,
              "eval_profile": eval_prof, "eval_busy_share": eval_prof["device_ms"] / eval_stages["eval forward"]}
    print(f"card: {card}")
    for name, st, prof, share in (("search step", stages, step_prof, report["step_busy_share"]),
                                  ("eval forward", eval_stages, eval_prof, report["eval_busy_share"])):
        print(f"{name}:")
        for k, v in st.items():
            print(f"  {k:24s} {v:9.3f} ms")
        print(f"  device busy {prof['device_ms']:.3f} ms ({share:.1%}), {prof['launches']} kernel launches")
        for k in prof["kernels"][:10]:
            print(f"  {k['device_ms']:8.3f} ms  x{k['count']:<5d} {k['name']}")
    print(f"peak memory: step {peak:.3f} GiB, eval {eval_peak:.3f} GiB")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "search_profile.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
