"""ctypes binding of the native data-loading core (``native/loader.cc``; own
copy of mobilesuperresolution_tpu/data/native_loader.py).

- ``yuv420_to_rgb(y, u, v)``: multithreaded BT.601 full-range conversion,
  bit-identical to data/yuv.py's numpy path (the reference's
  datasets/yuv420_to_bgr.py);
- ``load_raw_window(paths, frame_shape, flip_bgr)``: a parallel read of a
  window of raw frames into one contiguous (T, H, W, C) uint8 array, in
  place of one ``np.fromfile`` per frame (data/nemo.py).

Where ``libloader.so`` is missing (core/native_path.py) the numpy paths run.
"""

import ctypes
import functools
import os

import numpy as np

from mobilesuperresolution_tpu_torch.core.native_path import load_native_lib


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load_native_lib("libloader.so")
    if lib is None:
        return None
    lib.yuv420_to_rgb_u8.restype = None
    lib.yuv420_to_rgb_u8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.load_raw_frames.restype = ctypes.c_int
    lib.load_raw_frames.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_void_p]
    return lib


def native_available():
    return _lib() is not None


def yuv420_to_rgb(y, u, v):
    """y: (H, W) uint8; u, v: (H/2, W/2) uint8 → (H, W, 3) uint8 RGB. The
    numpy path takes what the core does not: a missing library, another
    dtype, odd sizes."""
    lib = _lib()
    h, w = y.shape
    if (lib is None or any(a.dtype != np.uint8 for a in (y, u, v)) or h % 2 or w % 2
            or u.shape != (h // 2, w // 2) or v.shape != (h // 2, w // 2)):
        from mobilesuperresolution_tpu_torch.data.yuv import yuv420_to_rgb as numpy_path

        return numpy_path(y, u, v)
    y, u, v = (np.ascontiguousarray(a) for a in (y, u, v))
    out = np.empty((h, w, 3), np.uint8)
    lib.yuv420_to_rgb_u8(y.ctypes.data, u.ctypes.data, v.ctypes.data, h, w, out.ctypes.data)
    return out


def load_raw_window(paths, frame_shape, flip_bgr=False):
    """``len(paths)`` raw uint8 frames of ``frame_shape`` (H, W, C) read into
    one (T, H, W, C) array, channels reversed with ``flip_bgr``. None where
    the library is missing or a frame fails (a short or missing file): the
    caller then reads frame by frame with numpy, which raises the precise
    error."""
    if flip_bgr and (len(frame_shape) < 1 or frame_shape[-1] != 3):
        # the core swaps byte triplets: on another channel count that would
        # scramble the frame
        raise ValueError(f"flip_bgr requires 3-channel frames, got {frame_shape}")
    lib = _lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, *frame_shape), np.uint8)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    if lib.load_raw_frames(names, n, int(np.prod(frame_shape)), int(flip_bgr), out.ctypes.data) != 0:
        return None
    return out
