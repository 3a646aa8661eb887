"""SISR sets: DIV2K (training and validation halves), Set5, Set14, BSDS100
and Urban100 (counterpart of mobilesuperresolution_tpu/data/eval_sets.py
and data/div2k.py): bicubic-degraded HR images read from
``<data_dir>/<dir>/`` PNG/BMP files, decoded once into an ``ArrayCache``
under ``--cache_dir`` (``div2k_<mode>`` for DIV2K, the set's name for the
others) unless it is empty.
"""

import os
from types import SimpleNamespace

from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data import isr as _isr

_DIRS = {
    "div2k": os.path.join("DIV2K", "DIV2K_valid_HR"),
    "set5": "Set5",
    "set14": "Set14",
    "bsds100": "BSDS100",
    "urban100": "Urban100",
}


def list_image_files(d):
    files = sorted(os.listdir(d))
    return [(f, os.path.join(d, f)) for f in files if f.endswith((".png", ".bmp"))]


def _div2k_argparser(parser):
    _isr.update_argparser(parser)
    parser.set_defaults(num_patches=100, train_batch_size=16, eval_batch_size=1)


def bind(name):
    dirname = _DIRS[name]

    def get_dataset(mode, params):
        d = dirname
        if mode == modes.TRAIN:
            if name != "div2k":
                raise NotImplementedError(f"{name} is eval-only")
            d = os.path.join("DIV2K", "DIV2K_train_HR")
        cache = getattr(params, "cache_dir", None)
        if cache:
            cache = os.path.join(cache, f"div2k_{mode}" if name == "div2k" else name)
        return _isr.ImageSRBicubicDataset(mode, params, list_image_files(os.path.join(params.data_dir, d)),
                                          cache_dir=cache)

    argparser = _div2k_argparser if name == "div2k" else _isr.update_argparser
    return SimpleNamespace(name=name, update_argparser=argparser, get_dataset=get_dataset)
