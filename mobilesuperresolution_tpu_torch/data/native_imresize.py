"""ctypes binding of the native bicubic core (``native/imresize.cc``; own copy
of mobilesuperresolution_tpu/data/native_imresize.py).

A fast path for the uint8 MATLAB-exact resize on the host: the taps and
indices come from data/imresize.py's own code, and the C++ core only runs
the gather and the weighted sum with the same rounding, so it is
bit-identical to ``imresize_np``. Where ``libimresize.so`` is missing
(core/native_path.py), or the input is not uint8, ``imresize_np`` runs.
"""

import ctypes
import functools

import numpy as np

from mobilesuperresolution_tpu_torch.core.native_path import load_native_lib
from mobilesuperresolution_tpu_torch.data.imresize import contributions, derive_size_from_scale, imresize_np


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load_native_lib("libimresize.so")
    if lib is None:
        return None
    for name in ("resize_rows_u8", "resize_cols_u8"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    return lib


def native_available():
    return _lib() is not None


@functools.lru_cache(maxsize=256)
def _contributions(in_len, out_len, scale):
    w, idx = contributions(in_len, out_len, scale)
    return np.ascontiguousarray(w), np.ascontiguousarray(idx.astype(np.int32))


def imresize_u8(I, scalar_scale=None, output_shape=None):
    """uint8 HWC (or HW) MATLAB-exact resize through the native core;
    ``imresize_np`` where the core does not apply."""
    lib = _lib()
    if lib is None or I.dtype != np.uint8:
        return imresize_np(I, scalar_scale=scalar_scale, output_shape=output_shape)
    I = np.ascontiguousarray(I)
    was_2d = I.ndim == 2
    if was_2d:
        I = I[:, :, None]
    if scalar_scale is not None:
        scale = [float(scalar_scale)] * 2
        out_size = derive_size_from_scale(I.shape, float(scalar_scale))
    elif output_shape is not None:
        scale = [output_shape[k] / I.shape[k] for k in range(2)]
        out_size = list(output_shape)
    else:
        raise ValueError("need scalar_scale or output_shape")
    B = I
    for dim in np.argsort(np.array(scale), kind="stable"):  # increasing scale, as imresize_np
        dim = int(dim)
        w, idx = _contributions(B.shape[dim], out_size[dim], scale[dim])
        h, wid, c = B.shape
        if dim == 0:
            out = np.empty((out_size[0], wid, c), np.uint8)
            lib.resize_rows_u8(B.ctypes.data, h, wid, c, w.ctypes.data, idx.ctypes.data, w.shape[1],
                               out.ctypes.data, out_size[0])
        else:
            out = np.empty((h, out_size[1], c), np.uint8)
            lib.resize_cols_u8(B.ctypes.data, h, wid, c, w.ctypes.data, idx.ctypes.data, w.shape[1],
                               out.ctypes.data, out_size[1])
        B = out
    return B[:, :, 0] if was_2d else B
