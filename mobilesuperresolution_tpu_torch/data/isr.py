"""Image super-resolution datasets (counterpart of
mobilesuperresolution_tpu/data/isr.py):

- TRAIN: index virtualization (``index // num_patches``, length = files x
  num_patches); paired files give a random LR-grid patch inside the ignored
  boundary; HR-only files give a random HR patch of lr_patch·scale +
  2·boundary·scale, degraded by the MATLAB-exact bicubic, then shaved by
  the boundary on both; vflip / hflip / transpose, each p = 0.5, shared by
  LR and HR.
- EVAL: paired LR/HR files with HR cropped to the LR size times the scale,
  or HR files cropped to a multiple of the scale and degraded.

A dataset given a ``cache_dir`` decodes each file once into an ``ArrayCache``
there and reads the decoded arrays after. Arrays are HWC uint8 until the
final conversion to float32 [0, 1] (the reference's to_tensor). Output layout is NHWC. ``batch_iterator`` draws
every TRAIN item from a random stream that depends only on (seed, index),
so the batches are a function of its arguments alone, and a resumed epoch
(``start_batch``) replays the rest of its batches exactly. With
``shard_by_process`` each process of a group (parallel/distributed.py) takes
its slice of the one shuffled order, as DistributedSampler does.
"""

import os

import numpy as np

from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data.io_cache import ArrayCache, load_image

# the degradation: the native core (bit-identical to data/imresize.py's
# numpy path, which runs where the library is missing)
from mobilesuperresolution_tpu_torch.data.native_imresize import imresize_u8 as imresize_np
from mobilesuperresolution_tpu_torch.parallel.distributed import process_count, process_index


def update_argparser(parser):
    import mobilesuperresolution_tpu_torch.data as data_pkg

    data_pkg.update_argparser(parser)
    parser.add_argument("--scale", default=2, type=int)
    parser.set_defaults(train_batch_size=16, eval_batch_size=1)


def add_train_args(parser):
    """The flags the TRAIN branch reads; added by the training entry points,
    before the dataset module sets its defaults."""
    parser.add_argument("--train_batch_size", type=int, default=32)
    parser.add_argument("--lr_patch_size", default=48, type=int)
    parser.add_argument("--ignored_boundary_size", default=2, type=int)
    parser.add_argument("--num_patches", default=100, type=int)


def _to_float(img):
    return np.ascontiguousarray(img).astype(np.float32) / 255.0


def _augment(rng, lr, hr):
    if rng.random() < 0.5:
        lr, hr = lr[::-1], hr[::-1]
    if rng.random() < 0.5:
        lr, hr = lr[:, ::-1], hr[:, ::-1]
    if rng.random() < 0.5:
        lr, hr = np.swapaxes(lr, 0, 1), np.swapaxes(hr, 0, 1)
    return lr, hr


class ImageSRDataset:
    """Paired LR/HR files, [(name, path), ...] each; decoded through an
    ``ArrayCache`` in ``cache_dir`` when one is given (``--cache_compress``
    picks its form)."""

    def __init__(self, mode, params, lr_files, hr_files, cache_dir=None):
        self.mode = mode
        self.params = params
        self.lr_files = lr_files
        self.hr_files = hr_files
        self.rng = np.random.default_rng(getattr(params, "seed", 0))
        self.cache = None
        if cache_dir:
            self.cache = ArrayCache(cache_dir, compress=bool(getattr(params, "cache_compress", 1)))
            for name, path in list(lr_files) + list(hr_files):
                if name not in self.cache:
                    self.cache.add(name, load_image(path))
            self.cache.log_build_stats(f"{type(self).__name__} cache")

    def _load(self, files, index):
        name, path = files[index]
        if self.cache is not None:
            return np.asarray(self.cache.get(name))
        return load_image(path)

    def _load_item(self, index):
        return self._load(self.lr_files, index), self._load(self.hr_files, index)

    def _sample_patch(self, lr, hr, rng):
        p = self.params
        if self.mode == modes.TRAIN:
            b = p.ignored_boundary_size
            x = rng.integers(b, lr.shape[0] - p.lr_patch_size + 1 - b)
            y = rng.integers(b, lr.shape[1] - p.lr_patch_size + 1 - b)
            lr = lr[x : x + p.lr_patch_size, y : y + p.lr_patch_size]
            hr = hr[x * p.scale : (x + p.lr_patch_size) * p.scale, y * p.scale : (y + p.lr_patch_size) * p.scale]
        else:
            hr = hr[: lr.shape[0] * p.scale, : lr.shape[1] * p.scale]
        return lr, hr

    def __len__(self):
        if self.mode == modes.TRAIN:
            return len(self.lr_files) * self.params.num_patches
        return len(self.lr_files)

    def __getitem__(self, index):
        return self.item(index, self.rng)

    def item(self, index, rng):
        """TRAIN: (lr, hr) float32 patches drawn with ``rng``; EVAL: (name,
        lr, hr)."""
        if self.mode == modes.TRAIN:
            index = index // self.params.num_patches
        lr, hr = self._sample_patch(*self._load_item(index), rng)
        if self.mode == modes.TRAIN:
            return tuple(_to_float(a) for a in _augment(rng, lr, hr))
        name = os.path.splitext(self.hr_files[index][0])[0]
        return name, _to_float(lr), _to_float(hr)


class ImageSRBicubicDataset(ImageSRDataset):
    """HR-only files; LR synthesized with the MATLAB-exact bicubic."""

    def __init__(self, mode, params, hr_files, cache_dir=None):
        super().__init__(mode, params, hr_files, hr_files, cache_dir)

    def _load_item(self, index):
        hr = self._load(self.hr_files, index)
        return hr, hr

    def _sample_patch(self, lr, hr, rng):
        p = self.params
        s = p.scale
        if self.mode == modes.TRAIN:
            hb = p.ignored_boundary_size * s
            hp = p.lr_patch_size * s + 2 * hb
            x = rng.integers(0, hr.shape[0] - hp + 1)
            y = rng.integers(0, hr.shape[1] - hp + 1)
            hr = hr[x : x + hp, y : y + hp]
            lr = imresize_np(hr, scalar_scale=1.0 / s)
            b = p.ignored_boundary_size
            if b:
                lr, hr = lr[b:-b, b:-b], hr[hb:-hb, hb:-hb]
            return lr, hr
        hr = hr[: hr.shape[0] - hr.shape[0] % s, : hr.shape[1] - hr.shape[1] % s]
        return imresize_np(hr, scalar_scale=1.0 / s), hr


def _batches(dataset, batch_size, shuffle, seed, drop_last, start_batch=0, shard_by_process=False):
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if shard_by_process:
        # every process shuffles alike (same seed), wrap-pads the order to a
        # multiple of the process count (DistributedSampler's padding: every
        # process must run the same number of steps, each a collective) and
        # takes its slice
        p = process_count()
        if len(order) % p:
            order = np.concatenate([order, order[: p - len(order) % p]])
        order = order[process_index() :: p]
    for bidx, start in enumerate(range(0, len(order), batch_size)):
        idx = order[start : start + batch_size]
        if len(idx) == 0 or (drop_last and len(idx) < batch_size):
            return
        if bidx < start_batch:
            continue  # a resumed epoch: the consumed batches sample nothing
        # each item's random stream depends only on (seed, index)
        items = [dataset.item(int(i), np.random.default_rng([seed, int(i)])) for i in idx]
        if len(items[0]) == 3:  # EVAL: (name, lr, hr), one by one
            for name, lr, hr in items:
                yield name, lr[None], hr[None]
        else:
            yield np.stack([it[0] for it in items]), np.stack([it[1] for it in items])


def batch_iterator(dataset, batch_size=1, shuffle=False, seed=0, drop_last=False, prefetch=0, start_batch=0,
                   shard_by_process=False):
    """TRAIN items stacked to (lr (B, h, w, C), hr (B, H, W, C)), or (B, T,
    ...) for video; EVAL items as (name, lr (1, ...), hr (1, ...)), the
    reference's eval batch of 1. ``prefetch`` > 0 makes the batches in a
    background thread, that many ahead, so patch sampling and the bicubic
    overlap the device step; a dataset error re-raises in the consumer.
    ``start_batch`` skips the first batches of the order (a resumed epoch):
    the rest are the same arrays as in the full stream. ``shard_by_process``
    yields this process's slice of every epoch (the trainers pass it)."""
    gen = _batches(dataset, batch_size, shuffle, seed, drop_last, start_batch, shard_by_process)
    if prefetch <= 0:
        yield from gen
        return

    import queue
    import threading

    q = queue.Queue(maxsize=prefetch)
    end = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(end)
        except Exception as e:  # noqa: BLE001 — transported to the consumer, re-raised there
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, Exception):
            raise item
        yield item
