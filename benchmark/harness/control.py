"""Readings that set the limits of ``correct``: the program's own numbers
over many seeds, and the control's and the faults' on the same seeds, in one
process (the kernels build and load once).

    python benchmark/harness/control.py --workload <cell> --seeds 1,2,3 --seconds 3 --variants none,bf16

A variant is what runs in the program's place: ``none`` (the program as
the cell runs it); serving: a path of the program's own, named by the
traffic keys it changes (``TRAFFIC_VARIANTS``: ``bf16`` serves in bfloat16,
the control below the cells' float32; ``int8`` serves ``--quantize int8``),
joined by ``+``; training: ``tf32`` (the control: the reference computed in
TF32, below float32 with TF32 off) and ``half_batch`` (a fault: the
reference's loss over half of each batch). Each reading prints one JSON
line: the cell, the seed, the variant and every compared number. The
benchmark's own runs never run this.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cell as cells  # noqa: E402


TRAFFIC_VARIANTS = {"bf16": {"dtype": "bfloat16"}, "int8": {"quantize": "int8"}}
REFERENCE_VARIANTS = ("tf32", "half_batch")


def run(name, seed, seconds, variant, device, traffic_override=None):
    """One run of the cell ``name``'s driver with ``variant`` in the
    program's place: the driver's result."""
    override = dict(traffic_override or {})
    if variant != "none":
        for part in variant.split("+"):
            override.update(TRAFFIC_VARIANTS[part])
    return cells.run_driver(name, seed, seconds, device, traffic_override=override)


def readings(name, seed, seconds, variant, device, traffic_override=None):
    """The compared numbers of one run of ``variant`` on ``seed``: {name:
    value}."""
    if variant in REFERENCE_VARIANTS:
        entry, config, traffic, workload = cells.find(name)
        traffic = dict(traffic, **(traffic_override or {}))
        cell = cells.Cell(name=name, config=config, traffic=traffic, limits=workload["limits"], seed=seed,
                          seconds=seconds, trace=False, device=device, t_process=time.perf_counter(),
                          variant=variant)
        return importlib.import_module(f"benchmark.drivers.{traffic['driver']}").control_readings(cell)
    res = run(name, seed, seconds, variant, device, traffic_override)
    return dict(res["notes"].get("errors") or {c["name"]: c["value"] for c in res["checks"]},
                correct=cells.is_correct(res))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variants", default="none")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            values = readings(args.workload, seed, args.seconds, variant, dev)
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant, **values,
                              "s": round(time.perf_counter() - t, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
