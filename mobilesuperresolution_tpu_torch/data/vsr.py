"""Video super-resolution dataset base (own copy of
mobilesuperresolution_tpu/data/vsr.py, the reference's datasets/_vsr.py):

- an item is a window of ``image_batch`` consecutive frames; lr_windows[index]
  lists the (key, path) of its frames;
- one random patch position shared by every frame of the clip, with the
  vertical offset pinned to 0 when the LR height is <= 68 (the NEMO 240p
  case);
- one pair of flip decisions (horizontal, vertical) shared by the clip; no
  transpose for video;
- TRAIN length = windows x num_patches, item index // num_patches;
- EVAL items are (save_path, lr (T, h, w, C), hr (T, H, W, C)), save_path
  from the last two components of the first frame's key;
- a subclass may add per-frame channels to the LR (``_extra_frames``, e.g.
  codec motion vectors): they take the LR's crop, are concatenated unscaled
  after the /255 LR, are flipped with it, and ``_flip_extra`` then adjusts
  them (e.g. negates the flipped displacement component).

Frames decode through an ``ArrayCache`` when the dataset has one
(``prepare_cache`` fills it). ``item(index, rng)`` draws from the stream it
is given; ``data/isr.py::batch_iterator`` derives it from (seed, index), so
a resumed epoch replays its clips exactly.
"""

import os

import numpy as np

from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data.io_cache import ArrayCache, load_image


def update_argparser(parser):
    import mobilesuperresolution_tpu_torch.data as data_pkg

    data_pkg.update_argparser(parser)
    parser.add_argument("--scale", default=4, type=int)
    parser.add_argument("--image_batch", default=10, type=int, help="Frames per training clip.")
    parser.add_argument("--train_sample_patch", type=lambda v: str(v).lower() != "false", default=True,
                        help="False = train on whole frames, no patch crop.")
    # the TRAIN flags are the training entry points' (data/isr.py::add_train_args)
    parser.set_defaults(train_batch_size=16, lr_patch_size=48, num_patches=100)


class VideoSRDataset:
    """lr_windows / hr_windows: lists of windows, each a list of (key,
    path-or-None) frame entries, paired by index. Subclasses override
    ``_load_item`` or ``_load_frame``.

    short_frame_guard: pin the vertical crop to 0 for frames <= 68 px tall
    (the reference's Vimeo-LR special case)."""

    short_frame_guard = True

    def __init__(self, mode, params, lr_windows, hr_windows, cache_dir=None):
        # a missing or extra file in either tree would shift every later pair
        if len(lr_windows) != len(hr_windows):
            raise ValueError(f"LR/HR window count mismatch: {len(lr_windows)} vs {len(hr_windows)}: the two "
                             "directory trees are out of sync")
        for lw, hw in zip(lr_windows, hr_windows):
            if len(lw) != len(hw):
                raise ValueError(f"LR/HR frame count mismatch within a window: {[k for k, _ in lw]} vs "
                                 f"{[k for k, _ in hw]}")
        self.mode = mode
        self.params = params
        self.lr_windows = lr_windows
        self.hr_windows = hr_windows
        self.cache = ArrayCache(cache_dir, compress=bool(getattr(params, "cache_compress", 1))) if cache_dir else None
        self.rng = np.random.default_rng(getattr(params, "seed", 0))

    def prepare_cache(self):
        if self.cache is None:
            return
        for window in list(self.lr_windows) + list(self.hr_windows):
            for key, path in window:
                if path is not None and key not in self.cache:
                    self.cache.add(key, load_image(path))
        self.cache.log_build_stats(f"{type(self).__name__} cache")

    def _load_frame(self, key, path):
        if self.cache is not None and key in self.cache:
            return np.asarray(self.cache.get(key))
        return load_image(path)

    def _load_item(self, index):
        lrs = [self._load_frame(k, p) for k, p in self.lr_windows[index]]
        hrs = [self._load_frame(k, p) for k, p in self.hr_windows[index]]
        return lrs, hrs

    def __len__(self):
        if self.mode == modes.TRAIN:
            return len(self.lr_windows) * self.params.num_patches
        return len(self.lr_windows)

    def _extra_frames(self, index):
        """None, or per LR frame of the window an (H, W, Ce) float32 array
        concatenated onto the normalised LR, not scaled by 1/255."""
        return None

    def _flip_extra(self, lr, axis):
        """Adjust the extra channels of ``lr`` after a flip along ``axis``
        ('width' or 'height'); returns lr."""
        return lr

    def __getitem__(self, index):
        return self.item(index, self.rng)

    def item(self, index, rng):
        """TRAIN: (lr (T, ps, ps, C), hr (T, s·ps, s·ps, C)) float32 drawn
        with ``rng``; EVAL: (save_path, lr, hr) whole frames."""
        if self.mode == modes.TRAIN:
            index = index // self.params.num_patches
        lr_list, hr_list = self._load_item(index)
        extra_list = self._extra_frames(index)
        p = self.params
        p1, p2 = rng.random(), rng.random()
        if self.mode == modes.TRAIN and getattr(p, "train_sample_patch", True):
            b = p.ignored_boundary_size
            h0, w0 = lr_list[0].shape[:2]
            x = 0 if self.short_frame_guard and h0 <= 68 else int(rng.integers(b, h0 - p.lr_patch_size + 1 - b))
            y = int(rng.integers(b, w0 - p.lr_patch_size + 1 - b))
            ps, s = p.lr_patch_size, p.scale
            lr_list = [f[x : x + ps, y : y + ps] for f in lr_list]
            hr_list = [f[x * s : (x + ps) * s, y * s : (y + ps) * s] for f in hr_list]
            if extra_list is not None:
                extra_list = [m[x : x + ps, y : y + ps] for m in extra_list]
        lr = np.stack([np.ascontiguousarray(f) for f in lr_list]).astype(np.float32) / 255.0
        hr = np.stack([np.ascontiguousarray(f) for f in hr_list]).astype(np.float32) / 255.0
        if extra_list is not None:
            lr = np.concatenate([lr, np.stack(extra_list).astype(np.float32)], axis=-1)
        if self.mode == modes.TRAIN:
            if p1 < 0.5:  # horizontal flip (width axis)
                lr, hr = self._flip_extra(lr[:, :, ::-1].copy(), "width"), hr[:, :, ::-1]
            if p2 < 0.5:  # vertical flip (height axis)
                lr, hr = self._flip_extra(lr[:, ::-1].copy(), "height"), hr[:, ::-1]
            return np.ascontiguousarray(lr), np.ascontiguousarray(hr)
        parts = os.path.splitext(self.lr_windows[index][0][0])[0].split("/")
        save_path = (parts[-2] + parts[-1]) if len(parts) >= 2 else parts[-1]
        return save_path, lr, hr


def sliding_windows(frames, window, stride=1):
    """[(key, path)] -> the windows of ``window`` consecutive frames."""
    return [frames[i : i + window] for i in range(0, len(frames) - window + 1, stride)]
