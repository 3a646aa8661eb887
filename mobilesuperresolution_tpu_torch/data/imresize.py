"""MATLAB-exact bicubic resize (antialiased), numpy/float64: the degradation
model of the SISR data (own copy of the numpy half of
mobilesuperresolution_tpu/data/imresize.py, whose module imports JAX). The
native C++ core, bit-identical to this path, runs the uint8 resize where its
library is built (data/native_imresize.py).

Algorithm (MATLAB ``imresize``): cubic kernel a = -0.5, widened by 1/scale
on downscale (antialiasing); sample positions u = (x+1)/scale +
0.5·(1 - 1/scale); ceil(kernel_width)+2 taps normalised to sum 1;
out-of-range taps mirrored (edge-inclusive); dimensions processed in order of
increasing scale; a uint8 input is rounded and clipped to uint8 after each
dimension pass.
"""

import math

import numpy as np


def cubic(x):
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    f = (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    ) * ((ax > 1) & (ax <= 2))
    return f


def contributions(in_length, out_length, scale):
    """Per-output-pixel tap weights and (mirrored) source indices.

    Returns (weights [out, P], indices [out, P]) float64/int32.
    """
    kernel_width = 4.0
    if scale < 1.0:
        h = lambda x: scale * cubic(scale * x)
        kernel_width = kernel_width / scale
    else:
        h = cubic
    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    P = int(math.ceil(kernel_width)) + 2
    ind = left[:, None] + np.arange(P, dtype=np.float64) - 1.0
    indices = ind.astype(np.int64)
    weights = h(u[:, None] - indices.astype(np.float64) - 1.0)
    weights = weights / weights.sum(axis=1, keepdims=True)
    # Mirror out-of-range indices (edge-inclusive symmetric reflection).
    aux = np.concatenate(
        [np.arange(in_length), np.arange(in_length - 1, -1, -1)]
    ).astype(np.int64)
    indices = aux[np.mod(indices, aux.size)]
    # Drop taps whose weight is zero for every output pixel.
    keep = np.nonzero(np.any(weights != 0, axis=0))[0]
    return weights[:, keep], indices[:, keep].astype(np.int32)


def resize_matrix(in_length, out_length, scale=None, dtype=np.float64):
    """Dense (out, in) resize matrix — scatter the tap weights into a matrix so
    the per-dimension resize becomes one matmul (the TPU-friendly form)."""
    if scale is None:
        scale = out_length / in_length
    w, idx = contributions(in_length, out_length, scale)
    m = np.zeros((out_length, in_length), dtype=np.float64)
    for p in range(w.shape[1]):
        np.add.at(m, (np.arange(out_length), idx[:, p]), w[:, p])
    return m.astype(dtype)


def derive_size_from_scale(shape, scale):
    return [int(math.ceil(scale * shape[k])) for k in range(2)]


def _resize_along_dim_np(img, dim, weights, indices):
    # img: (H, W, C) float64; gather taps along `dim` and reduce.
    if dim == 0:
        taps = img[indices]  # (out, P, W, C)
        out = np.einsum("op,opwc->owc", weights, taps.astype(np.float64))
    else:
        taps = img[:, indices]  # (H, out, P, C)
        out = np.einsum("op,hopc->hoc", weights, taps.astype(np.float64))
    return out


def imresize_np(I, scalar_scale=None, output_shape=None):
    """Host golden-path MATLAB-exact imresize.

    I: (H, W) or (H, W, C) uint8 or float. uint8 in → uint8 out with per-dim
    rounding; float in → float64 out (no clipping), exactly as MATLAB.
    """
    I = np.asarray(I)
    if scalar_scale is not None:
        scale = [float(scalar_scale)] * 2
        out_size = derive_size_from_scale(I.shape, float(scalar_scale))
    elif output_shape is not None:
        scale = [output_shape[k] / I.shape[k] for k in range(2)]
        out_size = list(output_shape)
    else:
        raise ValueError("need scalar_scale or output_shape")

    order = np.argsort(np.array(scale), kind="stable")
    wi = [contributions(I.shape[k], out_size[k], scale[k]) for k in range(2)]

    B = I
    was_2d = B.ndim == 2
    if was_2d:
        B = B[:, :, None]
    is_uint8 = I.dtype == np.uint8
    for k in range(2):
        dim = int(order[k])
        w, idx = wi[dim]
        B = _resize_along_dim_np(B.astype(np.float64), dim, w, idx)
        if is_uint8:
            B = np.around(np.clip(B, 0, 255)).astype(np.uint8)
    if was_2d:
        B = B[:, :, 0]
    return B


def convert_double_to_byte(I):
    return np.around(255.0 * np.clip(I, 0.0, 1.0)).astype(np.uint8)
