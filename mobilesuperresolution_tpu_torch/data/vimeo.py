"""Vimeo-90k septuplet dataset (own copy of mobilesuperresolution_tpu/data/vimeo.py).
Layout under --data_dir:

    vimeo/<split>/{lr,hr}/<seq>/<subseq>/*.png      (split: train, eval)

One window per two-level subsequence directory; in TRAIN mode only the
frames whose file name holds 'lr' (LR tree) or 'hr' (HR tree) count, as the
reference filters them. Frames decode through an ``ArrayCache`` under
``--cache_dir`` (``vimeo_<mode>``) when one is set.
"""

import os

from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data import vsr as _vsr


def update_argparser(parser):
    _vsr.update_argparser(parser)
    parser.add_argument("--val_image_batch", default=7, type=int)
    parser.set_defaults(num_patches=100, train_batch_size=16, eval_batch_size=1)


def list_sequence_windows(d, tag=None):
    """One window per ``<seq>/<subseq>`` directory of ``d``: its frames in
    name order, those holding ``tag`` when one is given."""
    windows = []
    for seq in sorted(os.listdir(d)):
        seq_dir = os.path.join(d, seq)
        if not os.path.isdir(seq_dir):
            continue
        for sub in sorted(os.listdir(seq_dir)):
            sub_dir = os.path.join(seq_dir, sub)
            if not os.path.isdir(sub_dir):
                continue
            frames = sorted(os.listdir(sub_dir))
            if tag is not None:
                frames = [f for f in frames if tag in f]
            windows.append([(os.path.join(seq, sub, f), os.path.join(sub_dir, f)) for f in frames])
    return windows


def get_dataset(mode, params):
    root = os.path.join(getattr(params, "data_dir", "data"), "vimeo")
    split = "train" if mode == modes.TRAIN else "eval"
    train = mode == modes.TRAIN
    lr_windows = list_sequence_windows(os.path.join(root, split, "lr"), "lr" if train else None)
    hr_windows = list_sequence_windows(os.path.join(root, split, "hr"), "hr" if train else None)
    cache = os.path.join(params.cache_dir, f"vimeo_{mode}") if getattr(params, "cache_dir", None) else None
    return _vsr.VideoSRDataset(mode, params, lr_windows, hr_windows, cache_dir=cache)
