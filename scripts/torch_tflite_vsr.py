"""Measure the port's TFLite export of each VSR type on the CPU.

    python3 scripts/torch_tflite_vsr.py [--types basic ...] [--frames 2]
        [--height 64] [--width 64] [--threads 4] [--out_dir DIR]

For each type, the model at the width ``cli.export`` builds (``basic`` nf
24 / 8 blocks, ``basic_origin`` nf 64 / 30 blocks, ``basic_mv`` nf 20 / 8
blocks, ``single`` 32 channels / 8 blocks, ``multi`` the search artifact's
last line), x4, with the seeded weights of ``--seed``: the float and the
``--quantize`` (dynamic-range int8) ``.tflite`` written by
``export.export_tflite``, each one's conversion seconds, file size and
``tf.lite.Interpreter`` seconds for one call (after a warm-up call, with
``--threads`` threads), and its max abs error against the port's CPU forward
(float32, TF32 off) beside ``cli.export``'s tolerance, and the process's
peak resident memory so far. ``--no_check`` skips the port's forward and
the errors (the interpreter alone, for sizes where the CPU's memory is
short). One JSON line per type and format. Needs tensorflow; runs on the
CPU only (the number is no card's).
"""

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mobilesuperresolution_tpu_torch.cli import export as export_cli  # noqa: E402
from mobilesuperresolution_tpu_torch.core.device import no_tf32  # noqa: E402
from mobilesuperresolution_tpu_torch.export import export_tflite  # noqa: E402
from mobilesuperresolution_tpu_torch.export.tflite_vsr import import_tf  # noqa: E402

ARTIFACT = os.path.join(ROOT, "artifacts", "search_depth_tpu", "block_index.txt")
TYPES = ["basic", "basic_origin", "basic_mv", "single", "multi"]


def interpreter(path, threads):
    tf = import_tf()
    interp = tf.lite.Interpreter(model_path=path, num_threads=threads)
    interp.allocate_tensors()
    return interp


def run(interp, x):
    interp.set_tensor(interp.get_input_details()[0]["index"], np.ascontiguousarray(x, np.float32))
    interp.invoke()
    return interp.get_tensor(interp.get_output_details()[0]["index"])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--types", nargs="+", default=TYPES, choices=TYPES)
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--no_check", action="store_true")
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    import_tf()  # once, outside the timed conversions
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="tflite_vsr_")
    os.makedirs(out_dir, exist_ok=True)
    parser = export_cli.build_parser()
    for kind in args.types:
        argv = ["--model_type", kind, "--scale", "4", "--out", os.path.join(out_dir, kind), "--height",
                str(args.height), "--width", str(args.width), "--frames", str(args.frames), "--seed", str(args.seed)]
        if kind == "multi":
            argv += ["--block_index", ARTIFACT]
        model, x, module = export_cli.build_export_model(parser.parse_args(argv), parser)
        want, port_s = None, None
        if not args.no_check:
            t0 = time.perf_counter()
            with no_tf32(), torch.inference_mode():
                want = module(x)
            port_s = round(time.perf_counter() - t0, 3)
        for quantize in (False, True):
            path = os.path.join(out_dir, f"{kind}{'_int8' if quantize else ''}.tflite")
            t0 = time.perf_counter()
            export_tflite(module, tuple(x.shape), path, quantize=quantize)
            convert_s = time.perf_counter() - t0
            interp = interpreter(path, args.threads)
            run(interp, x.numpy())
            t0 = time.perf_counter()
            got = run(interp, x.numpy())
            invoke_s = time.perf_counter() - t0
            row = {"type": kind, "quantize": quantize, "input": list(x.shape), "convert_s": round(convert_s, 3),
                   "bytes": os.path.getsize(path), "interpreter_s": round(invoke_s, 3), "port_cpu_s": port_s,
                   "threads": args.threads, "finite": bool(np.isfinite(got).all())}
            if want is not None:
                err = float(np.abs(got - want.numpy()).max())
                tol = export_cli.tflite_tolerance(want, quantize)
                row.update(max_abs_err=err, tol=tol, within_tol=err <= tol, rel_err=err / float(want.abs().max()))
            row["peak_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
            print(json.dumps(row), flush=True)
            del interp, got


if __name__ == "__main__":
    main()
