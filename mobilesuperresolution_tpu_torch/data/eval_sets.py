"""SISR eval sets: DIV2K validation, Set5, Set14, BSDS100 and Urban100
(counterpart of mobilesuperresolution_tpu/data/eval_sets.py and of the
EVAL half of data/div2k.py): bicubic-degraded HR images read from
``<data_dir>/<dir>/`` PNG/BMP files.
"""

import os
from types import SimpleNamespace

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


def bind(name):
    dirname = _DIRS[name]

    def get_dataset(mode, params):
        root = os.path.join(params.data_dir, dirname)
        return _isr.ImageSRBicubicDataset(mode, params, list_image_files(root))

    return SimpleNamespace(name=name, update_argparser=_isr.update_argparser, get_dataset=get_dataset)
