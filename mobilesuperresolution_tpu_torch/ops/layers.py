"""Conv layers and depth↔space reshapes on NHWC tensors.

Counterpart of mobilesuperresolution_tpu/ops/layers.py. Parameters keep the
JAX layouts (HWIO ``kernel``, ``bias``; ``v``, ``g``, ``b`` of a
weight-normed conv) so checkpoints load by key renaming;
``prepare(dtype)`` derives the compute-layout weights once after the
parameters change (train/checkpoint.py calls it).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle
from mobilesuperresolution_tpu_torch.ops.resize import resize_bilinear


def depth_to_space(x, r):
    """PixelShuffle with torch channel ordering: in channel (c*r*r + i*r + j)
    → out pixel offset (i, j) of channel c. x: (..., H, W, C*r*r)."""
    *lead, h, w, crr = x.shape
    n = len(lead)
    x = x.reshape(*lead, h, w, crr // (r * r), r, r)
    x = x.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    return x.reshape(*lead, h * r, w * r, crr // (r * r))


def space_to_depth(x, r):
    """Inverse of ``depth_to_space``: (..., H*r, W*r, C) → (..., H, W, C*r*r)."""
    *lead, hr, wr, c = x.shape
    n = len(lead)
    x = x.reshape(*lead, hr // r, r, wr // r, r, c)
    x = x.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
    return x.reshape(*lead, hr // r, wr // r, c * r * r)


def conv2d_nhwc(x, weight, bias=None, padding=0, groups=1):
    """``F.conv2d`` on an NHWC tensor through its channels_last NCHW view.
    weight: OIHW (torch layout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


class WNConv(nn.Module):
    """Weight-normalized SAME conv (odd kernel), the JAX ``WNConv``: the
    effective kernel is ``g * v / sqrt(sum(v², axes 0, 1, 2) + 1e-12)`` per
    output channel, with ``v`` HWIO. ``g_init`` is kept for the checkpoint
    bridge's random init (None: g = ||v||, the raw init)."""

    def __init__(self, in_features, features, kernel_size=3, g_init=1.0):
        super().__init__()
        k = kernel_size
        self.g_init = g_init
        self.v = nn.Parameter(torch.zeros(k, k, in_features, features))
        self.g = nn.Parameter(torch.zeros(features))
        self.b = nn.Parameter(torch.zeros(features))
        self.prepare()

    def effective_kernel(self):
        """The weight-normed HWIO kernel, float32."""
        v = self.v.detach()
        norm = torch.sqrt(torch.sum(v * v, dim=(0, 1, 2)) + 1e-12)
        return (self.g.detach() / norm) * v

    def prepare(self, dtype=None):
        """Derive the effective HWIO ``kernel`` and the OIHW weight in
        ``dtype`` (default: the last one used)."""
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        self.kernel = self.effective_kernel().to(dtype)
        self._w = self.kernel.permute(3, 2, 0, 1).contiguous()
        self._b = self.b.detach().to(dtype)

    def forward(self, x):
        return conv2d_nhwc(x, self._w, self._b, padding=self.v.shape[0] // 2)


class PlainConv(nn.Module):
    """Plain SAME conv (odd kernel) with an HWIO ``kernel`` and ``bias``."""

    def __init__(self, in_features, features, kernel_size=3):
        super().__init__()
        k = kernel_size
        self.kernel = nn.Parameter(torch.zeros(k, k, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.prepare()

    def prepare(self, dtype=None):
        """Derive the OIHW weight in ``dtype`` (default: the last one used)."""
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        self._w = self.kernel.detach().permute(3, 2, 0, 1).contiguous().to(dtype)
        self._b = self.bias.detach().to(dtype)

    def forward(self, x):
        return conv2d_nhwc(x, self._w, self._b, padding=self.kernel.shape[0] // 2)


def subpixel_transpose_kernel(w, stride):
    """Rearrange a flax ConvTranspose kernel (K, K, Cin, Cout) — un-mirrored,
    applied over the s-dilated input — into the equivalent sub-pixel conv
    kernel (M, M, Cin, Cout·s²), M = ceil(K/s). Output channels are ordered
    for ``depth_to_space`` (c·s² + py·s + px); phase taps past the kernel
    support are zero."""
    K = w.shape[0]
    cin, cout = w.shape[2], w.shape[3]
    s = stride
    M = -(-K // s)
    out = w.new_zeros(M, M, cin, cout, s, s)
    for ky in range(M):
        for kx in range(M):
            for py in range(s):
                for px in range(s):
                    a = py + s * (M - 1 - ky)
                    b = px + s * (M - 1 - kx)
                    if a < K and b < K:
                        out[ky, kx, :, :, py, px] = w[K - 1 - a, K - 1 - b]
    return out.reshape(M, M, cin, cout * s * s)


class SubpixelConvTranspose(nn.Module):
    """flax ``ConvTranspose(features, (K, K), strides=(s, s), 'VALID')`` with
    the same parameters, computed as an M×M conv at low resolution fused with
    depth_to_space and the crop to the transpose's (H·s + K-s, W·s + K-s)
    output (kernel B2, kernels/fused_tail.py). ``out_hw`` adds a bilinear
    resize; the bias is added inside the kernel, before the resize, which
    equals adding it after up to rounding because every row of a bilinear
    resize matrix sums to 1."""

    def __init__(self, in_features, features, kernel_size=5, stride=4):
        super().__init__()
        K = kernel_size
        self.stride = stride
        self.kernel = nn.Parameter(torch.zeros(K, K, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.prepare()

    def prepare(self, dtype=None):
        """Derive the phase kernel and the per-phase bias in ``dtype``
        (default: the last one used)."""
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        s = self.stride
        self._w = subpixel_transpose_kernel(self.kernel.detach(), s).to(dtype).contiguous()
        self._b = self.bias.detach().repeat_interleave(s * s).to(dtype)

    def forward(self, x, out_hw=None, align_corners=False):
        K, s = self.kernel.shape[0], self.stride
        M = -(-K // s)
        h, w = x.shape[-3], x.shape[-2]
        ex = max(K - s, 0)
        y = fused_conv_pixel_shuffle(
            x, self._w, self._b, s,
            padding=((M - 1, M), (M - 1, M)),
            crop=(h * s + ex, w * s + ex),
        )
        if out_hw is not None:
            y = resize_bilinear(y, out_hw, align_corners)
        return y
