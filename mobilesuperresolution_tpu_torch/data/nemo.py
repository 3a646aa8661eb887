"""NEMO raw-frame video dataset, 240p LR → 1080p HR (own copy of
mobilesuperresolution_tpu/data/nemo.py). Layout under --data_dir:

    nemo/<split>/{lr,hr}/*.raw      (split: train, eval)

Frames are interleaved uint8 files from the YUV420 converter (data/yuv.py,
RGB; ``--raw_order bgr`` for the reference converter's BGR files): LR
240x426x3, HR 1080x1920x3, the shape told by the file's size. Files whose
name holds '_' are skipped. Windows of ``image_batch`` frames
(``val_image_batch`` for eval) start every 25 frames in TRAIN and every
window length in EVAL; each split's LR and HR window lists are written to
``<job_dir>/{lr,hr}_{train,eval}.csv``. Frames are read with numpy, one file
at a time (the JAX package's optional native reader is not ported).
"""

import csv
import os

import numpy as np

from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data import vsr as _vsr

LR_SHAPE = (240, 426, 3)
HR_SHAPE = (1080, 1920, 3)


def update_argparser(parser):
    _vsr.update_argparser(parser)
    parser.add_argument("--val_image_batch", default=100, type=int)
    parser.add_argument("--raw_order", default="rgb", choices=["rgb", "bgr"],
                        help="Channel order of .raw frames: 'rgb' for data/yuv.py output, 'bgr' for the "
                        "reference converter's rawfiles.")
    parser.set_defaults(num_patches=1000, train_batch_size=16)


def list_raw_windows(d, mode, image_batch):
    """Windows of ``image_batch`` files of ``d`` (name order, names without
    '_'), every 25 files in TRAIN, back to back in EVAL."""
    files = [(f, os.path.join(d, f)) for f in sorted(os.listdir(d)) if "_" not in f]
    stride = 25 if mode == modes.TRAIN else image_batch
    return [files[i : i + image_batch] for i in range(0, len(files) + 1 - image_batch, stride)]


class NemoDataset(_vsr.VideoSRDataset):
    """raw_order: 'rgb' for frames from data/yuv.py, 'bgr' for the
    reference converter's rawfiles (channels reversed on read)."""

    def __init__(self, mode, params, lr_windows, hr_windows, raw_order="rgb"):
        super().__init__(mode, params, lr_windows, hr_windows, cache_dir=None)
        if raw_order not in ("rgb", "bgr"):
            raise ValueError(f"raw_order must be 'rgb' or 'bgr', got {raw_order!r}")
        self.raw_order = raw_order

    @staticmethod
    def _raw_shape(path):
        """The frame shape by file size; for a path that does not exist, by
        the directory's 'lr' tag."""
        try:
            size = os.path.getsize(path)
        except OSError:
            size = -1
        if size == int(np.prod(LR_SHAPE)):
            return LR_SHAPE
        if size == int(np.prod(HR_SHAPE)):
            return HR_SHAPE
        return LR_SHAPE if "lr" in os.path.dirname(path).lower() else HR_SHAPE

    def _load_frame(self, key, path):
        if path.endswith(".raw"):
            arr = np.fromfile(path, dtype=np.uint8).reshape(self._raw_shape(path))
            return arr[..., ::-1] if self.raw_order == "bgr" else arr
        return super()._load_frame(key, path)


def get_dataset(mode, params):
    root = os.path.join(getattr(params, "data_dir", "data"), "nemo")
    split = "train" if mode == modes.TRAIN else "eval"
    batch = params.image_batch if mode == modes.TRAIN else params.val_image_batch
    lr_windows = list_raw_windows(os.path.join(root, split, "lr"), mode, batch)
    hr_windows = list_raw_windows(os.path.join(root, split, "hr"), mode, batch)
    job_dir = getattr(params, "job_dir", None)
    if job_dir:
        tag = "_train.csv" if mode == modes.TRAIN else "_eval.csv"
        for prefix, windows in (("lr", lr_windows), ("hr", hr_windows)):
            with open(os.path.join(job_dir, prefix + tag), "w", newline="") as fh:
                w = csv.writer(fh)
                for win in windows:
                    w.writerow([p for _, p in win])
    return NemoDataset(mode, params, lr_windows, hr_windows, raw_order=getattr(params, "raw_order", "rgb"))
