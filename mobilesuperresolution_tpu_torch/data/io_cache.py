"""Host-side decoded-image cache and image file IO (own copies of the JAX
package's jax-free ``data/io_cache.py::ArrayCache`` and ``load_image``, and
``train/evaluate.py::_save_png``).

``ArrayCache`` keeps decoded images as one file per key in a directory,
written atomically by rename, so concurrent readers are safe: ``<key>.npy``
raw (memory-mapped reads) or ``<key>.npz`` deflated (``compress=True``, the
default for new entries; uint8 images through a PNG-style 'sub' predictor
first). Reads accept both forms.
"""

import logging
import os

import numpy as np

logger = logging.getLogger("msr_torch.cache")


def _sub_filter(u8):
    """PNG-style 'sub' predictor along the width axis (uint8 wraparound,
    exactly reversible): deflate does better on the per-pixel deltas of
    locally smooth rows."""
    d = u8.copy()
    d[:, 1:] = (u8[:, 1:].astype(np.int16) - u8[:, :-1].astype(np.int16)).astype(np.uint8)
    return d


def _sub_unfilter(d):
    return np.add.accumulate(d, axis=1, dtype=np.uint8)


class ArrayCache:
    """A directory of arrays by key; ``raw_bytes`` / ``stored_bytes`` count
    the entries this instance added."""

    def __init__(self, cache_dir, compress=True):
        self.cache_dir = cache_dir
        self.compress = compress
        self.raw_bytes = 0
        self.stored_bytes = 0
        self.added = 0
        os.makedirs(cache_dir, exist_ok=True)

    def _base(self, key):
        return os.path.join(self.cache_dir, key.replace("/", "__"))

    def __contains__(self, key):
        base = self._base(key)
        return os.path.exists(base + ".npy") or os.path.exists(base + ".npz")

    def add(self, key, array):
        if key in self:
            return
        base = self._base(key)
        array = np.ascontiguousarray(array)
        # a per-process temporary name: two writers never share one
        if self.compress:
            path, tmp = base + ".npz", f"{base}.tmp.{os.getpid()}.npz"
            with open(tmp, "wb") as f:
                if array.dtype == np.uint8 and array.ndim >= 2:
                    np.savez_compressed(f, sub=_sub_filter(array))
                else:
                    np.savez_compressed(f, arr=array)
        else:
            path, tmp = base + ".npy", f"{base}.tmp.{os.getpid()}.npy"
            np.save(tmp[:-4], array)  # np.save appends .npy itself
        os.replace(tmp, path)
        self.added += 1
        self.raw_bytes += array.nbytes
        self.stored_bytes += os.path.getsize(path)

    def get(self, key, mmap=True):
        base = self._base(key)
        if os.path.exists(base + ".npy"):
            return np.load(base + ".npy", mmap_mode="r" if mmap else None)
        with np.load(base + ".npz") as z:
            if "sub" in z.files:
                return _sub_unfilter(z["sub"])
            return z["arr"]

    def ratio(self):
        """stored / raw bytes over the entries this instance added (1.0 if
        none)."""
        return self.stored_bytes / self.raw_bytes if self.raw_bytes else 1.0

    def log_build_stats(self, what="cache"):
        if self.added:
            logger.info("%s: %d entries built, %.1f MB raw -> %.1f MB stored (%.0f%% of raw)", what, self.added,
                        self.raw_bytes / 1e6, self.stored_bytes / 1e6, 100.0 * self.ratio())


def load_image(path):
    """Decode an image file → uint8 (H, W, 3) numpy array (grayscale → RGB)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im if im.mode == "RGB" else im.convert("RGB"))


def save_png(path, arr):
    """arr: (H, W, C) float in [0, 1], clipped and rounded to uint8."""
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = np.asarray(np.clip(np.asarray(arr), 0, 1) * 255.0 + 0.5, dtype=np.uint8)
    Image.fromarray(img).save(path)
