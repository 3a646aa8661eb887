"""Time kernels B3 (csrc/fused_wdsr_block.cu), B4 (csrc/fused_tail.cu, the
WDSR tail) and B5 (csrc/fused_convsep.cu) at their path shapes, and the
models that run them, for the checkout given
by ``--root``, so that two commits can be held against each other on one
card in one run (parent, change, change, parent):

    python3 scripts/torch_block_bench.py --root old_checkout
    python3 scripts/torch_block_bench.py --root .

B3: one WDSR-B block at 24 units on the full-width x2 LR map (1, 678, 1020,
24), f32 and bf16, weights packed once where the checkout packs them (as
BasicBlock.prepare does). B4: the WDSR-B x2 tail on the same map, body 24
-> 12 (3x3) + skip 3 -> 12 (5x5), f32 and bf16, weights packed once where
the checkout packs them (as BasicModel.prepare does). B5: one ConvSep branch, C = C_out = 32, at the
search's shape (16, 48, 48, 32) and the supernet eval shape (1, 678, 1020,
32), k = 3, 5, 7, f32 (and k 7 bf16 at the eval shape); at the search shape
also the wrapper's host microseconds per call (host clock over 200 calls
that the card keeps up with) and the device time per launch from
torch.profiler. Models: WDSR-B x2 (16 blocks, 24 units) per 678x1020 image,
f32 and bf16, and the supernet (x2, 16 blocks, 32 units) eval forward per
678x1020 image, f32, seeded random weights, as chip_smoke.py builds them.
Prints one JSON line: per case the mean ms of 20 calls (models: 5) in each
of 5 repeats (CUDA events) and their mean, the card's name and power limit,
and the kernels' registers and spills (chip_smoke.py's ptxas_summary).
Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def mean(xs):
    return sum(xs) / len(xs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose mobilesuperresolution_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from mobilesuperresolution_tpu_torch.kernels import _build
    from mobilesuperresolution_tpu_torch.kernels import fused_convsep as b5
    from mobilesuperresolution_tpu_torch.kernels import fused_tail as b4
    from mobilesuperresolution_tpu_torch.kernels import fused_wdsr_block as b3
    from mobilesuperresolution_tpu_torch.models import get_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    sys.path.append(REPO)
    from chip_smoke import (NAS_BATCH, NAS_BLOCKS, NAS_PATCH, NAS_UNITS, SR_BLOCKS, SR_HR, SR_SCALE, SR_UNITS,
                            device_ms_per_launch, host_us, ptxas_summary)

    if not torch.cuda.is_available():
        print("torch_block_bench: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("fused_wdsr_block", "fused_convsep", "fused_tail"))
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    hl, wl = SR_HR[0] // SR_SCALE, SR_HR[1] // SR_SCALE

    def rand(shape, scale=1.0, dtype=torch.float32):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev, dtype)

    report = {"root": args.root, "b3_ms": {}, "b4_ms": {}, "b5_ms": {}, "b5_host_us": {}, "b5_device_us": {}, "checksum": {}}
    c, e, m = SR_UNITS, int(SR_UNITS * 6), int(SR_UNITS * 0.84)
    for dtype in (torch.float32, torch.bfloat16):
        x = rand((1, hl, wl, c), dtype=dtype)
        ws = [rand((c, e), c ** -0.5), rand((e,), 0.2), rand((e, m), e ** -0.5), rand((m,), 0.2),
              rand((3, 3, m, c), (9 * m) ** -0.5), rand((c,), 0.2)]
        ws = [w.to(dtype).float() for w in ws]
        kw = {"packed": b3.pack_weights(*ws, dtype)} if hasattr(b3, "pack_weights") else {}
        out = b3.fused_wdsr_block(x, *ws, **kw)
        torch.cuda.synchronize()
        key = str(dtype)[6:]
        report["b3_ms"][key] = repeats(lambda: b3.fused_wdsr_block(x, *ws, **kw))
        report["checksum"][f"b3 {key}"] = float(out.float().sum())

    cc = 3 * SR_SCALE ** 2
    for dtype in (torch.float32, torch.bfloat16):
        x, xs = rand((1, hl, wl, SR_UNITS), dtype=dtype), rand((1, hl, wl, 3), 0.5, dtype=dtype)
        kern = rand((3, 3, SR_UNITS, cc), (9 * SR_UNITS) ** -0.5).to(dtype)
        ks, b = rand((5, 5, 3, cc), 75 ** -0.5).to(dtype), rand((cc,), 0.5)
        kw = {"packed": b4.pack_weights(kern, ks, b, dtype)} if hasattr(b4, "pack_weights") else {}

        def call():
            return b4.fused_conv_pixel_shuffle_skip(x, kern, b, SR_SCALE, xs, ks, **kw)

        out = call()
        torch.cuda.synchronize()
        key = str(dtype)[6:]
        report["b4_ms"][key] = repeats(call)
        report["checksum"][f"b4 {key}"] = float(out.float().sum())

    cases = [(NAS_BATCH, NAS_PATCH, NAS_PATCH, k, torch.float32) for k in (3, 5, 7)]
    cases += [(1, hl, wl, k, torch.float32) for k in (3, 5, 7)] + [(1, hl, wl, 7, torch.bfloat16)]
    c = NAS_UNITS
    for nb, hh, ww, k, dtype in cases:
        x = rand((nb, hh, ww, c), dtype=dtype)
        ws = [rand((k, k, c), 1.0 / k), rand((c,), 0.2), rand((c, c), c ** -0.5), rand((c,), 0.2)]
        ws = [w.to(dtype).float() for w in ws]

        def call():
            return b5.fused_convsep(x, *ws)

        out = call()
        torch.cuda.synchronize()
        key = f"{nb}x{hh}x{ww} k{k} {str(dtype)[6:]}"
        report["b5_ms"][key] = repeats(call)
        report["checksum"][f"b5 {key}"] = float(out.float().sum())
        if nb == NAS_BATCH:
            report["b5_host_us"][key] = host_us(call)
            report["b5_device_us"][key] = device_ms_per_launch(call, "convsep")[0] * 1e3

    for name, bf16 in (("f32", False), ("bf16", True)):
        params = argparse.Namespace(model_type="BASIC_MODEL", num_blocks=SR_BLOCKS, num_residual_units=SR_UNITS,
                                  scale=SR_SCALE, bf16=bf16)
        model = get_model(params, device=dev)
        load_params_npz(model, random_jax_params(model, seed=0))
        x = torch.rand((1, hl, wl, 3), generator=g).to(dev)
        with torch.inference_mode():
            report[f"sisr_{name}_ms"] = repeats(lambda: model(x), iters=5)
        del model
    params = argparse.Namespace(model_type="NAS_MODEL", num_blocks=NAS_BLOCKS, num_residual_units=NAS_UNITS,
                              scale=2, seed=0, width_search=True)
    model = get_model(params, device=dev)
    x = torch.rand((1, hl, wl, 3), generator=g).to(dev)
    with torch.inference_mode():
        report["supernet_eval_ms"] = repeats(lambda: model(x), iters=5)
    for k in [k for k in report if k.endswith("_ms")]:
        v = report[k]
        report[k + "_mean"] = {kk: mean(vv) for kk, vv in v.items()} if isinstance(v, dict) else mean(v)
    report["ptxas"] = {name: ptxas_summary(os.path.join(_build.BUILD_DIR, f"{name}.log"))
                       for name in ("fused_wdsr_block", "fused_convsep", "fused_tail")}
    report["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
