"""Training metrics as an append-only ``<job_dir>/metrics.jsonl`` (own copy
of the JSON-lines half of mobilesuperresolution_tpu/core/metrics_writer.py;
one process, no TensorBoard files)."""

import json
import os
import time


class MetricsWriter:
    """One JSON line per scalar: {"tag", "value", "step", "ts"}."""

    def __init__(self, job_dir):
        os.makedirs(job_dir, exist_ok=True)
        self.path = os.path.join(job_dir, "metrics.jsonl")

    def scalar(self, tag, value, step):
        rec = {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def scalars(self, values, step, prefix=""):
        for k, v in values.items():
            self.scalar(f"{prefix}{k}", v, step)
