"""Export CLI (counterpart of mobilesuperresolution_tpu/cli/export.py, the
reference's export_onnx.py surface).

    python -m mobilesuperresolution_tpu_torch.cli.export --scale 2 \\
        --block_index runs/search/block_index.txt --out model \\
        --params runs/retrain/weights/models.npz --format pt2

``--model_type result`` (the searched SISR net, the reference's only export)
or a VSR type (``basic``, ``basic_origin``, ``basic_mv``, ``single``,
``multi``: the whole recurrent forward of ``--frames`` frames), at
``--height`` x ``--width`` (360x540, the reference's input), with the
weights of ``--params`` (an npz in the JAX package's flat layout) or seeded
random ones (``--seed``). ``--format pt2`` (the default; ``stablehlo``, the
JAX package's default, is taken as its alias) writes ``<out>.pt2``: the
forward traced by ``torch.export`` on the CPU, ATen ops only
(export/export.py). ``onnx`` (``result`` only) needs the ``onnx`` package
and raises naming it. ``tflite`` writes ``<out>.tflite``, the forward
rebuilt in TF ops from the port's weights (the searched net, or a VSR
type's whole recurrent forward of ``--frames`` frames: SpyNet as direct
7x7 convs, the flow warp as a gather, the recurrence unrolled; export/
tflite_vsr.py) and converted by tensorflow's converter (dynamic-range int8
with ``--quantize``), and checks it in ``tf.lite.Interpreter`` on the CPU
against the port's CPU forward: within ``check_tolerance`` in float, within
1e-2 of the largest output with ``--quantize``; it needs tensorflow.
``basic_origin`` is x4 only (``--scale 4``).

After a ``pt2`` export the artifact is checked: loaded, moved to
``--device`` (default the card; ``cpu`` runs it there) and run on one
seeded input against the port's own forward of the same weights on that
device (on the card B4 for ``result``, B1 and B2 for ``basic``); the max
abs error and the tolerance are printed, and a larger error raises.
``--time_iters N`` also times both forwards there (ms per call, after one
warm-up call; CUDA events on the card).
"""

import argparse
import json
import time

import numpy as np
import torch

from mobilesuperresolution_tpu_torch.core.device import no_tf32, resolve_device
from mobilesuperresolution_tpu_torch.export import (
    FixedSizeForward,
    export_onnx,
    export_pt2,
    export_tflite,
    load_pt2,
    run_tflite,
)
from mobilesuperresolution_tpu_torch.models import ResultNet, get_vsr_model
from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params


def check_tolerance(ref):
    """Float32 throughout (TF32 off): the artifact's ATen convs and the
    port's kernels sum in other orders, and BasicVSR's warps carry a flow
    difference on through its recurrence."""
    return 1e-4 + 1e-4 * float(ref.abs().max())


def tflite_tolerance(ref, quantize):
    """Float: as ``check_tolerance`` (TF's convs sum in another order).
    Dynamic-range int8 rounds weights and activations to 8 bits: 1e-2 of the
    largest output, the bound the port's int8 models are held to."""
    return 1e-2 * float(ref.abs().max()) if quantize else check_tolerance(ref)


def check_tflite(path, module, x, quantize):
    """Run the ``.tflite`` at ``path`` in the interpreter and ``module`` on
    the CPU on ``x``; returns {"max_abs_err", "tol"}."""
    got = torch.from_numpy(run_tflite(path, x.numpy()))
    with no_tf32(), torch.inference_mode():
        want = module(x)
    return {"max_abs_err": float((got - want).abs().max()), "tol": tflite_tolerance(want, quantize)}


def build_parser():
    parser = argparse.ArgumentParser("Export a model for deployment (PyTorch)")
    parser.add_argument("--scale", type=int, default=2)
    parser.add_argument("--model_type", default="result",
                        choices=["result", "basic", "basic_origin", "basic_mv", "single", "multi"],
                        help="'result' = the searched SISR net (the reference's only export path); VSR types "
                        "export the full recurrent forward.")
    parser.add_argument("--block_index", type=str, default=None, help="search artifact (required for result/multi)")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--params", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0, help="Seeded random weights when --params is not given.")
    parser.add_argument("--format", nargs="+", default=["pt2"], choices=["pt2", "stablehlo", "tflite", "onnx"],
                        help="pt2 (torch.export; 'stablehlo', the JAX package's name, is its alias), onnx, tflite.")
    parser.add_argument("--quantize", action="store_true",
                        help="int8 dynamic-range quantization for tflite (TFLite's own, Optimize.DEFAULT).")
    parser.add_argument("--height", type=int, default=360)
    parser.add_argument("--width", type=int, default=540)
    parser.add_argument("--frames", type=int, default=10, help="clip length for VSR exports")
    parser.add_argument("--device", type=str, default=None,
                        help="Where the exported artifact is checked: 'cuda' (default) or 'cpu'.")
    parser.add_argument("--time_iters", type=int, default=0,
                        help="Time the artifact and the port's forward over this many calls (0 = no timing).")
    return parser


def build_export_model(args, parser):
    """(model on the CPU with its weights, example input, the callable to
    export)."""
    if args.model_type == "result":
        if not args.block_index:
            parser.error("--block_index is required for --model_type result")
        model = ResultNet.from_artifact(args.block_index, scale=args.scale)
        shape = (1, args.height, args.width, 3)
    else:
        if args.model_type == "multi" and not args.block_index:
            parser.error("--block_index is required for --model_type multi")
        model = get_vsr_model(args.model_type, scale=args.scale, device="cpu", block_index_path=args.block_index)
        shape = (1, args.frames, args.height, args.width, 5 if args.model_type == "basic_mv" else 3)
    load_params_npz(model, args.params or random_jax_params(model, args.seed))
    model.eval()
    if args.model_type == "result":
        module = model
    else:
        module = FixedSizeForward(model, args.height * args.scale, args.width * args.scale)
    x = torch.from_numpy(np.random.default_rng(args.seed).random(shape, dtype=np.float32))
    return model, x, module


def _ms_per_call(fn, device, iters):
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_artifact(path, model, module, x, device, time_iters=0):
    """Run the artifact and the port's forward on ``device``; returns
    {"device", "max_abs_err", "tol"} and, with ``time_iters``, both
    forwards' ms per call ("artifact_ms", "port_ms")."""
    model.to(device).prepare()
    x = x.to(device)
    program = load_pt2(path, device)
    with no_tf32(), torch.inference_mode():
        got = program(x)
        want = module(x)
        out = {"device": str(device), "max_abs_err": float((got.float() - want.float()).abs().max()),
               "tol": check_tolerance(want.float())}
        if time_iters:
            out["artifact_ms"] = _ms_per_call(lambda: program(x), device, time_iters)
            out["port_ms"] = _ms_per_call(lambda: module(x), device, time_iters)
    return out


def main(argv=None):
    """Export; returns {"paths": {format: path}, "export_s": s, "check":
    ``check_artifact``'s dict (pt2), "tflite_check": ``check_tflite``'s
    dict (tflite)}."""
    parser = build_parser()
    args = parser.parse_args(argv)
    formats = list(dict.fromkeys("pt2" if f == "stablehlo" else f for f in args.format))
    if "onnx" in formats and args.model_type != "result":
        parser.error("--format onnx exports the searched SISR net (--model_type result) — the reference's ONNX "
                     "artifact (export_onnx.py:117-141); use pt2 for the VSR types")
    device = resolve_device(args.device) if "pt2" in formats else None
    model, x, module = build_export_model(args, parser)
    out = {"paths": {}}
    for fmt in formats:
        t0 = time.perf_counter()
        if fmt == "pt2":
            p = export_pt2(module, x, args.out + ".pt2")
            out["export_s"] = time.perf_counter() - t0
        elif fmt == "onnx":
            p = export_onnx(model, tuple(x.shape), args.out + ".onnx")
        else:
            p = export_tflite(module, tuple(x.shape), args.out + ".tflite", quantize=args.quantize)
            out["export_tflite_s"] = time.perf_counter() - t0
            out["tflite_check"] = check = check_tflite(p, module, x, args.quantize)
            print(json.dumps({"tflite_check": check}))
            if not check["max_abs_err"] <= check["tol"]:
                raise AssertionError(f"the .tflite disagrees with the port's CPU forward: "
                                     f"{check['max_abs_err']} > {check['tol']}")
        out["paths"][fmt] = p
        print(f"exported {fmt} → {p}")
    if "pt2" in formats:
        out["check"] = check = check_artifact(out["paths"]["pt2"], model, module, x, device, args.time_iters)
        print(json.dumps({"artifact_check": check}))
        if not check["max_abs_err"] <= check["tol"]:
            raise AssertionError(f"exported program disagrees with the port's forward on {device}: "
                                 f"{check['max_abs_err']} > {check['tol']}")
    return out


if __name__ == "__main__":
    main()
