"""Where the time of one full-width BasicVSR window goes, on the GPU.

    python3 scripts/torch_window_profile.py [--quantize int8] [--root CHECKOUT]

Builds the port's BasicVSR x4 (nf 24, 8 blocks, bf16) with seeded random
weights, as chip_smoke.py does, and times one 10-frame 426x240 → 1920x1080
window forward: its stages with CUDA events (SpyNet flows, bidirectional
propagation, reconstruction), then one profiled forward (torch.profiler,
device time by kernel name, and the number of kernels it launched). The
device's busy share is the profiled kernel time over the unprofiled window
time. With ``--quantize int8`` the model is the int8 one (every conv of
SpyNet and the dual trunks through ``ops.quant.QConvWeight``); the script
then also records each quantized conv's input during one forward and times,
over all of them back to back (CUDA events), the whole quantized convs and
the activation quantization they contain outside the conv kernel: the
per-sample scale and the rounding in torch ops (``quantize_symmetric``) where
the checkout has no scale kernel, kernel Q1s where it has one (Q1 then
rounds as it stages its input). ``--root`` names the checkout whose
``mobilesuperresolution_tpu_torch`` is profiled (default: this one), so that
two commits can be held against each other on one card. Prints a summary
and writes everything to chiprun_out/window_profile[_int8].json. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quantize", choices=("none", "int8"), default="none")
    ap.add_argument("--root", default=REPO, help="checkout whose mobilesuperresolution_tpu_torch is profiled")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from mobilesuperresolution_tpu_torch.kernels import qconv_int8 as q1
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.models.basicvsr import compute_flows, lrelu
    from mobilesuperresolution_tpu_torch.ops import quant
    from mobilesuperresolution_tpu_torch.ops.resize import resize_bilinear
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    # this checkout's chip_smoke.py for the frames and the timer (the port's
    # package is imported from --root above, so its submodules stay root's)
    sys.path.append(REPO)
    from chip_smoke import H_LR, OH, OW, T_WIN, W_LR, cuda_ms, synthetic_stream

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    quantized = args.quantize == "int8"
    model = get_vsr_model("basic", scale=4, compute_dtype=torch.bfloat16, quantized=quantized)
    load_params_npz(model, random_jax_params(model, seed=0))
    x = torch.from_numpy(np.stack(synthetic_stream(T_WIN, H_LR, W_LR, seed=0))[None]).cuda()
    b, t, h, w, c = x.shape
    nf = model.num_feat

    with torch.inference_mode():
        xb = x.to(torch.bfloat16)
        ff, fb = compute_flows(model.spynet, xb)
        out_b, out_f = model._propagate(xb, ff, fb)
        feats = torch.cat([out_b, out_f], dim=-1).reshape(b * t, h, w, 2 * nf)

        def recon():
            y = model.conv_last(lrelu(model.fusion(feats)), out_hw=(OH, OW))
            return y + resize_bilinear(xb.reshape(b * t, h, w, c), (OH, OW))

        stages = {
            "window_forward": cuda_ms(lambda: model(x, OH, OW), iters=5, warmup=2),
            "spynet_flows": cuda_ms(lambda: compute_flows(model.spynet, xb), iters=5, warmup=1),
            "propagation": cuda_ms(lambda: model._propagate(xb, ff, fb), iters=5, warmup=1),
            "reconstruction": cuda_ms(recon, iters=5, warmup=1),
        }
        int8 = None
        if quantized:
            scale_kernel = getattr(q1, "act_scale", None)
            counts = {"Q1": q1.qconv_int8}
            if scale_kernel is not None:
                counts["Q1s"] = scale_kernel
            calls, call = [], quant.QConvWeight.__call__

            def record(self, inp):
                calls.append((self, inp))
                return call(self, inp)

            before = {k: f.launches for k, f in counts.items()}
            quant.QConvWeight.__call__ = record
            try:
                model(x, OH, OW)
            finally:
                quant.QConvWeight.__call__ = call
            torch.cuda.synchronize()
            if scale_kernel is None:  # the checkout's activation quantization: torch ops
                def quantize_all():
                    return [quant.quantize_symmetric(inp, dims=(1, 2, 3)) for _, inp in calls]
            else:
                def quantize_all():
                    return [scale_kernel(inp) for _, inp in calls]
            int8 = {
                "per_window": {k: f.launches - before[k] for k, f in counts.items()},
                "quantized_convs_ms": cuda_ms(lambda: [wt(inp) for wt, inp in calls], iters=3, warmup=1),
                "activation_quantization_ms": cuda_ms(quantize_all, iters=3, warmup=1),
                "activation_quantization": "quantize_symmetric (torch ops)" if scale_kernel is None
                else "Q1s (the rounding fused into Q1)",
            }
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model(x, OH, OW)
            torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: an aten op's entry repeats its kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(
        ({"name": e.key[:90], "count": e.count, "device_ms": dev_us(e) / 1e3} for e in kernels),
        key=lambda r: -r["device_ms"],
    )
    busy = sum(r["device_ms"] for r in rows)
    report = {
        "card": card, "root": args.root, "quantize": args.quantize, "stages_ms": stages,
        "fps": T_WIN / stages["window_forward"] * 1e3, "profiled_device_ms": busy,
        "busy_share": busy / stages["window_forward"], "kernel_launches": sum(r["count"] for r in rows),
        "int8": int8, "kernels": rows[:25],
    }
    print(f"card: {card}; root {args.root}; quantize {args.quantize}")
    for k, v in stages.items():
        print(f"  {k:15s} {v:9.3f} ms")
    print(f"  device busy {busy:.3f} ms of {stages['window_forward']:.3f} ms ({report['busy_share']:.1%}), "
          f"{report['kernel_launches']} kernel launches")
    if int8:
        print(f"  int8: {int8['per_window']} per window; quantized convs {int8['quantized_convs_ms']:.3f} ms, "
              f"activation quantization ({int8['activation_quantization']}) "
              f"{int8['activation_quantization_ms']:.3f} ms")
    for r in rows[:15]:
        print(f"  {r['device_ms']:8.3f} ms  x{r['count']:<5d} {r['name']}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    name = "window_profile_int8.json" if quantized else "window_profile.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in ("root", "quantize", "stages_ms", "busy_share", "kernel_launches",
                                             "int8")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
