"""Time kernel B2 (csrc/fused_tail.cu) at the VSR tail shape, for the
checkout given by ``--root``, so that two commits can be held against each
other on one card in one run:

    python3 scripts/torch_tail_bench.py --root old_checkout
    python3 scripts/torch_tail_bench.py --root .

The shape is BasicVSR x4's reconstruction tail, (10, 240, 426, 48) bf16, 2x2
conv with padding ((1, 2), (1, 2)), s = 4, cropped to 961x1705: the case
``chip_smoke.py`` reports as B2's main path. Prints one JSON line with the
mean ms of 50 calls (CUDA events) in each of 5 repeats, the card's name and
power limit, and the kernel's register count from the build log. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose mobilesuperresolution_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from mobilesuperresolution_tpu_torch.kernels import _build
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle

    if not torch.cuda.is_available():
        print("torch_tail_bench: CUDA is not available", file=sys.stderr)
        return 1
    _build.build(("fused_tail",))
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    n, h, w, c, s = 10, 240, 426, 48, 4
    x = (torch.rand((n, h, w, c), generator=g) * 2 - 1).to(dev, torch.bfloat16)
    kern = ((torch.rand((2, 2, c, c), generator=g) * 2 - 1) / 14).to(dev, torch.bfloat16)
    b = (torch.rand((c,), generator=g) * 0.2 - 0.1).to(dev, torch.bfloat16)

    def call():
        return fused_conv_pixel_shuffle(x, kern, b, s, ((1, 2), (1, 2)), (4 * h + 1, 4 * w + 1))

    out = call()
    torch.cuda.synchronize()
    repeats = []
    for _ in range(5):
        for _ in range(3):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            call()
        end.record()
        end.synchronize()
        repeats.append(start.elapsed_time(end) / 50)
    with open(os.path.join(_build.BUILD_DIR, "fused_tail.log")) as f:
        regs = [ln.strip() for ln in f if "registers" in ln]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "card": card, "b2_ms": repeats, "b2_ms_min": min(repeats),
                      "checksum": float(out.float().sum()), "ptxas": regs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
