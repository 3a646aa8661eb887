"""Image super-resolution evaluation datasets (counterpart of the EVAL
branch of mobilesuperresolution_tpu/data/isr.py; one process, so no
per-host sharding): paired LR/HR files with HR cropped to a multiple of the
scale, or HR files cropped so and degraded by the MATLAB-exact bicubic.

Arrays are HWC uint8 until the final conversion to float32 [0, 1] (the
reference's to_tensor). Output layout is NHWC. The TRAIN branch (random
patches, flips) comes with SISR training (ROADMAP.md, queue A10).
"""

import os

import numpy as np

from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data.imresize import imresize_np
from mobilesuperresolution_tpu_torch.data.io_cache import load_image


def update_argparser(parser):
    import mobilesuperresolution_tpu_torch.data as data_pkg

    data_pkg.update_argparser(parser)
    parser.add_argument("--scale", default=2, type=int)


def _to_float(img):
    return np.ascontiguousarray(img).astype(np.float32) / 255.0


class ImageSRDataset:
    """Paired LR/HR files, [(name, path), ...] each."""

    def __init__(self, mode, params, lr_files, hr_files):
        if mode != modes.EVAL:
            raise NotImplementedError("SISR training data is not ported yet (ROADMAP.md, queue A10)")
        self.scale = params.scale
        self.lr_files = lr_files
        self.hr_files = hr_files

    def _load(self, files, index):
        return load_image(files[index][1])

    def _lr_hr(self, index):
        lr = self._load(self.lr_files, index)
        hr = self._load(self.hr_files, index)
        return lr, hr[: lr.shape[0] * self.scale, : lr.shape[1] * self.scale]

    def __len__(self):
        return len(self.hr_files)

    def __getitem__(self, index):
        lr, hr = self._lr_hr(index)
        name = os.path.splitext(self.hr_files[index][0])[0]
        return name, _to_float(lr), _to_float(hr)


class ImageSRBicubicDataset(ImageSRDataset):
    """HR-only files; LR synthesized with the MATLAB-exact bicubic."""

    def __init__(self, mode, params, hr_files):
        super().__init__(mode, params, hr_files, hr_files)

    def _lr_hr(self, index):
        hr = self._load(self.hr_files, index)
        s = self.scale
        hr = hr[: hr.shape[0] - hr.shape[0] % s, : hr.shape[1] - hr.shape[1] % s]
        return imresize_np(hr, scalar_scale=1.0 / s), hr


def batch_iterator(dataset):
    """Yield each item as (name, lr (1, h, w, C), hr (1, H, W, C)), in
    order: the reference's eval batches (eval_batch_size 1)."""
    for i in range(len(dataset)):
        name, lr, hr = dataset[i]
        yield name, lr[None], hr[None]
