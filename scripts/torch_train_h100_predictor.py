"""Train the H100's latency predictor on its committed latency table.

    python3 scripts/torch_train_h100_predictor.py [--out PATH]

Trains ``nas/speed_model.py::train_speed_predictor`` on the 72 rows of
``mobilesuperresolution_tpu_torch/nas/speed_tables/nvidia_h100_80gb_hbm3.npy``
(split blocks timed on an NVIDIA H100 80GB HBM3 by chip_smoke.py's latency
table phase) on the CPU, from seed 0 (the 80/20 split and the
initialization), with Adam at lr 1e-2 for 400 epochs, and saves it with
``save_predictor`` beside the table as ``nvidia_h100_80gb_hbm3_predictor.msgpack``,
the name ``--speed_predictor auto`` resolves to on that card. Prints one
JSON line: the mean relative error |pred - ms| / ms on the training rows, on
the held-out rows and on all 72.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mobilesuperresolution_tpu_torch.nas.speed_model import save_predictor, train_speed_predictor  # noqa: E402

TABLES = os.path.join(ROOT, "mobilesuperresolution_tpu_torch", "nas", "speed_tables")
KIND = "nvidia_h100_80gb_hbm3"
SEED, EPOCHS, LR, OPTIMIZER = 0, 400, 1e-2, "adam"


def mean_relative_error(model, rows):
    with torch.no_grad():
        pred = model(torch.from_numpy(np.ascontiguousarray(rows[:, :3], np.float32)))[:, 0].numpy()
    return float(np.mean(np.abs(pred - rows[:, 3]) / rows[:, 3]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(TABLES, f"{KIND}_predictor.msgpack"))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    rows = np.load(os.path.join(TABLES, f"{KIND}.npy")).astype(np.float32)
    model, report = train_speed_predictor(rows, seed=SEED, epochs=EPOCHS, lr=LR, optimizer=OPTIMIZER)
    save_predictor(model, args.out)
    print(json.dumps({"table": f"{KIND}.npy", "rows": len(rows), "seed": SEED, "optimizer": OPTIMIZER, "lr": LR,
                      "epochs": EPOCHS, "train_rel_err": report["train_rel_err"],
                      "val_rel_err": report["val_rel_err"], "all_rows_rel_err": mean_relative_error(model, rows),
                      "out": os.path.relpath(args.out, ROOT)}))


if __name__ == "__main__":
    main()
