"""Conv layers and depth↔space reshapes on NHWC tensors.

Counterpart of mobilesuperresolution_tpu/ops/layers.py. Parameters keep the
JAX layouts (HWIO ``kernel``, ``bias``; ``v``, ``g``, ``b`` of a
weight-normed conv) so checkpoints load by key renaming;
``prepare(dtype)`` derives the compute-layout weights once after the
parameters change (train/checkpoint.py calls it) and keeps them as copies
(a float32 ``.to(float32)`` is the parameter itself), so an in-place update
of the parameters does not reach them before the next ``prepare``. Each layer's ``forward_live``
derives them from the live parameters on every call instead,
differentiably (training). Built with ``quantized=True``, ``WNConv`` and
``PlainConv`` run the int8 dynamic-range conv (ops/quant.py, kernel Q1 on
the card) on a weight ``prepare()`` quantized once, in train mode too: the
int8 path is for inference, and rounding has a zero gradient almost
everywhere, as in the JAX package.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels.fused_tail import FusedConvPixelShuffleFn, fused_conv_pixel_shuffle
from mobilesuperresolution_tpu_torch.ops.quant import QConvWeight
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
    output channel, with ``v`` HWIO, (k, k, in_features // groups, features).
    ``groups`` is flax's ``feature_group_count`` (``groups == in_features``
    is a depthwise conv, ``v`` (k, k, 1, C)). ``g_init`` is kept for the
    checkpoint bridge's random init (None: g = ||v||, the raw init).

    ``forward`` uses the weights derived by ``prepare()`` (inference);
    ``forward_live`` derives them on every call, differentiably (training).
    ``quantized``: the JAX ``WNConv``'s int8 branch, the float32 effective
    kernel quantized, the conv without bias, then the bias added in the
    output's dtype."""

    def __init__(self, in_features, features, kernel_size=3, g_init=1.0, groups=1, quantized=False):
        super().__init__()
        k = kernel_size
        self.g_init = g_init
        self.groups = groups
        self.quantized = quantized
        self.v = nn.Parameter(torch.zeros(k, k, in_features // groups, features))
        self.g = nn.Parameter(torch.zeros(features))
        self.b = nn.Parameter(torch.zeros(features))
        self.prepare()

    def effective_kernel(self):
        """The weight-normed HWIO kernel, float32, differentiable in v and g."""
        norm = torch.sqrt(torch.sum(self.v * self.v, dim=(0, 1, 2)) + 1e-12)
        return (self.g / norm) * self.v

    def prepare(self, dtype=None):
        """Derive the effective HWIO ``kernel`` and the OIHW weight in
        ``dtype`` (default: the last one used)."""
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        with torch.no_grad():
            self.kernel = self.effective_kernel().to(dtype)
        self._w = self.kernel.permute(3, 2, 0, 1).contiguous()
        self._b = self.b.detach().to(dtype).clone()
        if self.quantized:
            self._q = QConvWeight(self.effective_kernel().permute(3, 2, 0, 1))

    def forward(self, x):
        if self.quantized:
            return self._q(x) + self._b
        return conv2d_nhwc(x, self._w, self._b, padding=self.v.shape[0] // 2, groups=self.groups)

    def forward_live(self, x):
        """The conv on the current parameters, in x.dtype, with gradients to
        v, g and b (quantized: ``forward``)."""
        if self.quantized:
            return self.forward(x)
        w = self.effective_kernel().to(x.dtype).permute(3, 2, 0, 1)
        return conv2d_nhwc(x, w, self.b.to(x.dtype), padding=self.v.shape[0] // 2, groups=self.groups)


class PlainConv(nn.Module):
    """Plain SAME conv (odd kernel) with an HWIO ``kernel`` and ``bias``.
    ``quantized``: the JAX ``PlainConv``'s int8 branch, the float32 kernel
    quantized and the float32 bias added inside the conv."""

    def __init__(self, in_features, features, kernel_size=3, quantized=False):
        super().__init__()
        k = kernel_size
        self.quantized = quantized
        self.kernel = nn.Parameter(torch.zeros(k, k, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.prepare()

    def _weights(self, dtype):
        return self.kernel.permute(3, 2, 0, 1).contiguous().to(dtype), self.bias.to(dtype)

    def prepare(self, dtype=None):
        """Derive the OIHW weight in ``dtype`` (default: the last one used)."""
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        with torch.no_grad():
            self._w, self._b = (t.detach().clone() for t in self._weights(dtype))
        if self.quantized:
            self._q = QConvWeight(self.kernel.permute(3, 2, 0, 1), self.bias)

    def forward(self, x):
        if self.quantized:
            return self._q(x)
        return conv2d_nhwc(x, self._w, self._b, padding=self.kernel.shape[0] // 2)

    def forward_live(self, x):
        """The conv on the current parameters, in x.dtype, with gradients to
        kernel and bias (quantized: ``forward``)."""
        if self.quantized:
            return self.forward(x)
        return conv2d_nhwc(x, *self._weights(x.dtype), padding=self.kernel.shape[0] // 2)


class UpConv(PlainConv):
    """BasicVSR's upsampling step: a 3x3 SAME ``PlainConv``, then
    depth_to_space(·, 2), then a leaky ReLU (slope 0.1), as one launch of
    kernel B2 (conv, bias, shuffle and activation fused). The parameters are
    PlainConv's (HWIO ``kernel``, ``bias``; checkpoint key
    ``<name>/Conv_0/...``); ``forward_live`` runs B2 through its autograd
    Function on the live parameters."""

    _PAD = ((1, 1), (1, 1))

    def __init__(self, in_features, features):
        super().__init__(in_features, features, 3)

    def prepare(self, dtype=None):
        """Derive the HWIO kernel and the bias in ``dtype`` (default: the last
        one used), as copies."""
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        with torch.no_grad():
            self._k, self._b = (t.detach().to(dtype).clone() for t in (self.kernel, self.bias))

    def forward(self, x):
        return fused_conv_pixel_shuffle(x.contiguous(), self._k, self._b, 2, self._PAD, None, True)

    def forward_live(self, x):
        return FusedConvPixelShuffleFn.apply(x.contiguous(), self.kernel.to(x.dtype), self.bias.to(x.dtype), 2,
                                             self._PAD, None, True)


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
    resize matrix sums to 1. ``forward_live`` derives the phase kernel from
    the live parameters on every call and runs B2 through its autograd
    Function (``FusedConvPixelShuffleFn``)."""

    def __init__(self, in_features, features, kernel_size=5, stride=4):
        super().__init__()
        K = kernel_size
        self.stride = stride
        self.kernel = nn.Parameter(torch.zeros(K, K, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.prepare()

    def _weights(self, dtype):
        s = self.stride
        w = subpixel_transpose_kernel(self.kernel, s).to(dtype).contiguous()
        return w, self.bias.repeat_interleave(s * s).to(dtype)

    def prepare(self, dtype=None):
        """Derive the phase kernel and the per-phase bias in ``dtype``
        (default: the last one used)."""
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        with torch.no_grad():
            self._w, self._b = (t.detach().clone() for t in self._weights(dtype))

    def forward(self, x, out_hw=None, align_corners=False):
        return self._tail(fused_conv_pixel_shuffle, x, self._w, self._b, out_hw, align_corners)

    def forward_live(self, x, out_hw=None, align_corners=False):
        """The layer on the current parameters, in x.dtype, with gradients to
        kernel and bias."""
        return self._tail(FusedConvPixelShuffleFn.apply, x, *self._weights(x.dtype), out_hw, align_corners)

    def _tail(self, tail, x, w, b, out_hw, align_corners):
        K, s = self.kernel.shape[0], self.stride
        M = -(-K // s)
        h, wd = x.shape[-3], x.shape[-2]
        ex = max(K - s, 0)
        y = tail(x, w, b, s, ((M - 1, M), (M - 1, M)), (h * s + ex, wd * s + ex))
        if out_hw is not None:
            y = resize_bilinear(y, out_hw, align_corners)
        return y
