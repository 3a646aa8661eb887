"""Run one cell of the benchmark of mobilesuperresolution_tpu_torch once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell's configuration, traffic mix and limits by the names in
BENCHMARK.json (``harness/cell.py``), runs the traffic's driver
(``drivers/<driver>.py``) on the card, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``metrics/<name>.py``), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: every number compared for
``correct`` beside its limit, which also close standard error.

Exits 2 without a result where there is no CUDA card (or fewer than the cell
asks for), and 3 where JAX or the JAX package is loaded once the window has
closed. Writes nothing but the port's kernel build (``mobilesuperresolution_
tpu_torch/_build/``, inside the checkout).
"""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here, before torch loads

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cell as cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mobilesuperresolution_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def read_metric(name, ctx):
    """The per-layer metric ``name`` from ``metrics/<name>.py``'s ``read``,
    or None where it finds nothing to read."""
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def main(argv=None):
    args = parse(argv)
    entry, config, traffic, workload = cells.find(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA card(s); torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell = cells.Cell(name=args.workload, config=config, traffic=traffic, limits=workload["limits"],
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_process=T_PROCESS)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    res = driver.run(cell)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 3

    if args.trace:
        ctx = res["trace"]
        metrics = {}
        for m in cells.metrics_of(args.workload, "per_layer"):
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cells.metrics_of(args.workload, "end_to_end")}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"], "power_limit_w": power_limit_w()}
    if args.trace:
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
    checks = res["checks"]
    correct = cells.is_correct(res)
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
            "device": device}
    if args.trace:
        line["breakdown"] = res["trace"]["breakdown"]
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for key, value in res.get("notes", {}).items():
        print(f"{key}: {value}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r}) {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
