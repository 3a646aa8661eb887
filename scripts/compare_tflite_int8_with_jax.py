"""Hold the port's dynamic-range int8 ``.tflite`` of a VSR type beside the
JAX package's own (jax2tf) int8 ``.tflite`` of the same weights, to show
whether an int8 error comes from the port's TF graph or from TFLite's
quantization.

    python3 scripts/compare_tflite_int8_with_jax.py [--types single basic_mv]
        [--frames 2] [--height 64] [--width 64]

Each type at ``cli.export``'s width, x4, with the bridge's seeded weights
(``random_jax_params``, ``--seed``) loaded into both packages' models: the
port's ``export_tflite`` and the JAX package's ``export/export.py::
export_tflite`` (jax2tf, the same converter settings), float and
``quantize``, each run in ``tf.lite.Interpreter`` and held to the JAX
package's jitted float forward on the same input. One JSON line per type:
each file's max abs error, that error over the largest output, and the
1e-2 bound ``cli.export`` holds int8 to. Only the types the JAX converter
takes (not the SpyNet types, whose conversion fails in the JAX package).
Runs on the CPU; imports both packages, like the parity tests.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mobilesuperresolution_tpu.export.export import export_tflite as j_export_tflite  # noqa: E402
from mobilesuperresolution_tpu.models import get_vsr_model as j_get_vsr_model  # noqa: E402
from mobilesuperresolution_tpu_torch.cli import export as export_cli  # noqa: E402
from mobilesuperresolution_tpu_torch.export import export_tflite, run_tflite  # noqa: E402
from mobilesuperresolution_tpu_torch.train.checkpoint import random_jax_params  # noqa: E402

TYPES = ["single", "basic_mv"]


def tree(flat):
    out = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        d = out
        for s in scope:
            d = d.setdefault(s, {})
        d[leaf] = jnp.asarray(v)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--types", nargs="+", default=TYPES, choices=TYPES)
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    out_dir = tempfile.mkdtemp(prefix="tflite_int8_")
    parser = export_cli.build_parser()
    for kind in args.types:
        argv = ["--model_type", kind, "--scale", "4", "--out", os.path.join(out_dir, kind), "--height",
                str(args.height), "--width", str(args.width), "--frames", str(args.frames), "--seed", str(args.seed)]
        model, x, module = export_cli.build_export_model(parser.parse_args(argv), parser)
        params = tree(random_jax_params(model, args.seed))
        oh, ow = 4 * args.height, 4 * args.width
        jm = j_get_vsr_model(kind, scale=4)

        def apply_fn(v, a):
            return jm.apply(v, a, oh, ow)

        want = np.asarray(jax.jit(lambda p_, a: apply_fn({"params": p_}, a))(params, jnp.asarray(x.numpy())))
        top = float(np.abs(want).max())
        row = {"type": kind, "input": list(x.shape), "largest_output": top, "int8_bound": 1e-2 * top}
        for quantize in (False, True):
            tag = "int8" if quantize else "float"
            paths = {
                "port": export_tflite(module, tuple(x.shape), os.path.join(out_dir, f"{kind}_port_{tag}.tflite"),
                                      quantize=quantize),
                "jax": j_export_tflite(apply_fn, params, tuple(x.shape),
                                       os.path.join(out_dir, f"{kind}_jax_{tag}.tflite"), quantize=quantize),
            }
            for who, path in paths.items():
                err = float(np.abs(run_tflite(path, x.numpy()) - want).max())
                row[f"{who}_{tag}_max_abs_err"] = err
                row[f"{who}_{tag}_rel_err"] = err / top
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
