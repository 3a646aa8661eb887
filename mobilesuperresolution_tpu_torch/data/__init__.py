"""Datasets and frame IO (counterpart of mobilesuperresolution_tpu/data).

Each dataset module exposes ``update_argparser(parser)`` and
``get_dataset(mode, params)``; modules hosting several named datasets
(eval sets, synthetic) expose ``bind(name)``. Only the SISR evaluation sets
(DIV2K validation, Set5, Set14, BSDS100, Urban100, synthetic_isr) are
registered so far; training data and the VSR sets are queued in ROADMAP.md.
"""

import importlib

_DATASET_MODULES = {
    "div2k": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "set5": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "set14": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "bsds100": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "urban100": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "synthetic_isr": "mobilesuperresolution_tpu_torch.data.synthetic_module",
}


def update_argparser(parser):
    """Base flags shared by every dataset."""
    parser.add_argument("--data_dir", type=str, default="data")


def get_dataset_module(name):
    if name not in _DATASET_MODULES:
        raise KeyError(f"unknown dataset {name!r}; the port has {sorted(_DATASET_MODULES)}")
    mod = importlib.import_module(_DATASET_MODULES[name])
    if hasattr(mod, "bind"):
        return mod.bind(name)
    return mod
