"""A cell as the harness runs it: its manifest entry, configuration, traffic
mix and limits, each found by name in a file of its own, and the helpers
every driver shares (the result's shape, the checks, statistics)."""

import dataclasses
import json
import os
import statistics

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(name, root=ROOT):
    """(manifest entry, config, traffic, workload file) of the cell
    ``name``: ``benchmark/configs/<config>.json``, ``benchmark/traffic/
    <traffic>.json`` and ``benchmark/workloads/<name>.json``, found by the
    names the manifest gives. Raises KeyError for an unknown cell and
    ValueError where the files disagree with the manifest."""
    bench = os.path.join(root, "benchmark")
    entries = {w["name"]: w for w in manifest(root)["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    config = load_json(os.path.join(bench, "configs", entry["config"] + ".json"))
    traffic = load_json(os.path.join(bench, "traffic", entry["traffic"] + ".json"))
    workload = load_json(os.path.join(bench, "workloads", name + ".json"))
    if (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"benchmark/workloads/{name}.json names {workload['config']} / {workload['traffic']}, "
                         f"BENCHMARK.json {entry['config']} / {entry['traffic']}")
    return entry, config, traffic, workload


def metrics_of(name, kind, root=ROOT):
    """The manifest's metrics of ``kind`` ("end_to_end" or "per_layer") that
    the cell ``name`` reports: those that list it, or list no cells."""
    return [m for m in manifest(root)[kind] if name in m.get("workloads", [name])]


@dataclasses.dataclass
class Cell:
    """One run of one cell. ``variant`` is None for the benchmark's runs;
    the training cell's control and fault readings, which put the reference
    in the program's place (``harness/control.py``), set it."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float
    variant: str = None


def is_correct(result):
    """A driver's result is correct when every compared number is within its
    limit and no attempt failed."""
    return all(c["ok"] for c in result["checks"]) and result["failed"] == 0


def run_driver(name, seed, seconds, device, trace=False, traffic_override=None):
    """Run the cell ``name``'s driver once on ``device`` (the CPU tests pass
    a tiny ``traffic_override``); returns the driver's result."""
    import importlib
    import time

    entry, config, traffic, workload = find(name)
    traffic = dict(traffic, **(traffic_override or {}))
    c = Cell(name=name, config=config, traffic=traffic, limits=workload["limits"], seed=seed, seconds=seconds,
             trace=trace, device=device, t_process=time.perf_counter())
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}").run(c)


def check(name, value, limit):
    """A compared number beside its limit; it passes when value <= limit."""
    return {"name": name, "value": value, "limit": limit, "ok": bool(value <= limit)}


def quantile(values, q):
    """The q-quantile (0 < q < 1) by linear interpolation between order
    statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    at = q * (len(xs) - 1)
    lo = int(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def median(values):
    return statistics.median(values)
