"""REDS with codec motion vectors (own copy of
mobilesuperresolution_tpu/data/reds_with_mv.py), the data of the 'basic_mv'
model. Layout: REDS's (data/reds.py), plus per clip of the LR tree the
encoder's dump ``<clip>/hex-me16-ref1/motion.npy``, (frames, h, w, 2) motion
vectors (dx, dy) in pixels.

An item is REDS's with the vectors of its frames concatenated after the RGB
channels, (T, h, w, 5): they take the patch crop and the flips, are not
divided by 255, and a flip negates the flipped component (channel 3 on a
width flip, 4 on a height flip). The random crop is not pinned to 0 on short
frames (``short_frame_guard = False``, as in the reference's variant). The
corrupt clip '153' is skipped.
"""

import os

import numpy as np

from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data import vsr as _vsr
from mobilesuperresolution_tpu_torch.data.reds import list_clip_windows


def update_argparser(parser):
    _vsr.update_argparser(parser)
    parser.add_argument("--val_image_batch", default=100, type=int)
    parser.set_defaults(num_channels=5, num_patches=1000, train_batch_size=16, eval_batch_size=1)


class RedsWithMVDataset(_vsr.VideoSRDataset):
    """VideoSRDataset whose ``_extra_frames`` are the motion vectors of each
    LR frame, read from the clip's ``motion.npy`` (memory-mapped, opened once
    per clip)."""

    short_frame_guard = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._motion_cache = {}

    def _motion(self, clip_dir):
        if clip_dir not in self._motion_cache:
            self._motion_cache[clip_dir] = np.load(os.path.join(clip_dir, "hex-me16-ref1", "motion.npy"),
                                                   mmap_mode="r")
        return self._motion_cache[clip_dir]

    def _extra_frames(self, index):
        out = []
        for _, path in self.lr_windows[index]:
            clip_dir, frame_name = os.path.split(path)
            out.append(np.asarray(self._motion(clip_dir)[int(frame_name.split(".")[0])], dtype=np.float32))
        return out

    def _flip_extra(self, lr, axis):
        ch = 3 if axis == "width" else 4
        lr[..., ch] = -lr[..., ch]
        return lr


def get_dataset(mode, params):
    root = os.path.join(getattr(params, "data_dir", "data"), "REDS")
    split = "train" if mode == modes.TRAIN else "val"
    lr_dir = os.path.join(root, split, f"{split}_sharp_bicubic", f"X{params.scale}")
    hr_dir = os.path.join(root, split, f"{split}_sharp")
    batch = params.image_batch if mode == modes.TRAIN else params.val_image_batch

    def keep(windows):
        return [w for w in windows if not w[0][0].startswith("153/")]

    return RedsWithMVDataset(mode, params, keep(list_clip_windows(lr_dir, batch)),
                             keep(list_clip_windows(hr_dir, batch)))
