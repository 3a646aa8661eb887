"""Datasets and frame IO (counterpart of mobilesuperresolution_tpu/data).

Each dataset module exposes ``update_argparser(parser)`` and
``get_dataset(mode, params)``; modules hosting several named datasets
(eval sets, synthetic) expose ``bind(name)``. Registered: the SISR
evaluation sets (DIV2K validation, Set5, Set14, BSDS100, Urban100,
synthetic_isr), DIV2K's training half, and the video sets REDS, Vimeo-90k,
NEMO (raw frames from the YUV420 converter, data/yuv.py), REDS with codec
motion vectors (reds_with_mv, for 'basic_mv') and synthetic_vsr.
"""

import importlib

_DATASET_MODULES = {
    "div2k": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "set5": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "set14": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "bsds100": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "urban100": "mobilesuperresolution_tpu_torch.data.eval_sets",
    "reds": "mobilesuperresolution_tpu_torch.data.reds",
    "reds_with_mv": "mobilesuperresolution_tpu_torch.data.reds_with_mv",
    "vimeo": "mobilesuperresolution_tpu_torch.data.vimeo",
    "nemo": "mobilesuperresolution_tpu_torch.data.nemo",
    "synthetic_isr": "mobilesuperresolution_tpu_torch.data.synthetic_module",
    "synthetic_vsr": "mobilesuperresolution_tpu_torch.data.synthetic_module",
}


def update_argparser(parser):
    """Base flags shared by every dataset."""
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--cache_dir", type=str, default="data/cache",
                        help="Decoded-image cache of the file-backed sets ('' = none).")
    parser.add_argument("--cache_compress", type=int, default=1,
                        help="1 = zlib-compress new cache entries; 0 = raw .npy with mmap "
                        "reads. Reads accept both forms.")


def get_dataset_module(name):
    if name not in _DATASET_MODULES:
        raise KeyError(f"unknown dataset {name!r}; the port has {sorted(_DATASET_MODULES)}")
    mod = importlib.import_module(_DATASET_MODULES[name])
    if hasattr(mod, "bind"):
        return mod.bind(name)
    return mod
