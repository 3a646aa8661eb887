"""Frame-file helpers (own copy of mobilesuperresolution_tpu/data/frame_utils.py):

- ``renumber_frames``: zero-padded sequential renaming of dumped frames, so
  ffmpeg ``%04d`` patterns pick them up;
- ``check_raw_layout``: check a raw interleaved RGB frame file's size
  against its (H, W, C) shape and return its top-left 8x8 patch.
"""

import os

import numpy as np


def renumber_frames(directory, ext=".png", width=4, dry_run=False):
    """Rename the ``ext`` files of ``directory``, in sorted order, to 0000.png,
    0001.png, ...; returns the [(old, new)] mapping applied. Two passes
    through unique temporary names, so a target that collides with a source
    not renamed yet never overwrites it."""
    files = sorted(f for f in os.listdir(directory) if f.endswith(ext))
    mapping = [(f, f"{i:0{width}d}{ext}") for i, f in enumerate(files) if f != f"{i:0{width}d}{ext}"]
    if dry_run or not mapping:
        return mapping
    tmp = [f"__renum_{os.getpid()}_{i}{ext}.tmp" for i in range(len(mapping))]
    for (src, _), t in zip(mapping, tmp):
        os.rename(os.path.join(directory, src), os.path.join(directory, t))
    for (_, dst), t in zip(mapping, tmp):
        os.rename(os.path.join(directory, t), os.path.join(directory, dst))
    return mapping


def check_raw_layout(path, shape):
    """Validate an interleaved uint8 .raw frame against ``shape`` (H, W, C);
    returns its top-left 8x8 patch."""
    data = np.fromfile(path, dtype=np.uint8)
    expected = int(np.prod(shape))
    if data.size != expected:
        raise ValueError(f"{path}: {data.size} bytes, expected {expected} for {shape}")
    return data.reshape(shape)[:8, :8]
