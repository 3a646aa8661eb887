"""REDS video SR dataset (own copy of mobilesuperresolution_tpu/data/reds.py).
Layout under --data_dir:

    REDS/train/train_sharp_bicubic/X<scale>/<clip>/*.png   (LR)
    REDS/train/train_sharp/<clip>/*.png                     (HR)
    REDS/val/val_sharp_bicubic/X<scale>/..., REDS/val/val_sharp/...  (eval)

Items are every sliding window of ``image_batch`` frames of every clip
(``val_image_batch`` for eval), decoded through an ``ArrayCache`` under
``--cache_dir`` (``reds_<mode>``) when one is set.
"""

import os

from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data import vsr as _vsr


def update_argparser(parser):
    _vsr.update_argparser(parser)
    parser.add_argument("--val_image_batch", default=100, type=int)
    parser.set_defaults(num_patches=1000, train_batch_size=16)


def list_clip_windows(d, image_batch):
    """Every sliding window of ``image_batch`` frames of each clip directory."""
    windows = []
    for clip in sorted(os.listdir(d)):
        clip_dir = os.path.join(d, clip)
        if not os.path.isdir(clip_dir):
            continue
        frames = [(os.path.join(clip, f), os.path.join(clip_dir, f)) for f in sorted(os.listdir(clip_dir))
                  if f.endswith(".png")]
        windows.extend(_vsr.sliding_windows(frames, image_batch, stride=1))
    return windows


def get_dataset(mode, params):
    root = os.path.join(getattr(params, "data_dir", "data"), "REDS")
    split = "train" if mode == modes.TRAIN else "val"
    lr_dir = os.path.join(root, split, f"{split}_sharp_bicubic", f"X{params.scale}")
    hr_dir = os.path.join(root, split, f"{split}_sharp")
    batch = params.image_batch if mode == modes.TRAIN else params.val_image_batch
    lr_windows = list_clip_windows(lr_dir, batch)
    hr_windows = list_clip_windows(hr_dir, batch)
    # the two trees use the same clip and frame names: a partly downloaded
    # clip must not shift the pairing
    lr_keys = [k for w in lr_windows for k, _ in w]
    hr_keys = [k for w in hr_windows for k, _ in w]
    if lr_keys != hr_keys:
        diff = set(lr_keys) ^ set(hr_keys)
        raise ValueError(f"REDS LR/HR trees disagree ({lr_dir} vs {hr_dir}): "
                         f"{sorted(diff)[:5]}{'...' if len(diff) > 5 else ''}")
    cache = os.path.join(params.cache_dir, f"reds_{mode}") if getattr(params, "cache_dir", None) else None
    return _vsr.VideoSRDataset(mode, params, lr_windows, hr_windows, cache_dir=cache)
