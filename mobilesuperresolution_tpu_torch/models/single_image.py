"""Per-frame "single" video model, the baseline without temporal fusion
(counterpart of mobilesuperresolution_tpu/models/single_image.py).

Per frame, all B·T frames batched: weight-normed encoder 3→ch, a residual
body of ``blocks`` [conv k → ReLU → conv k] + identity blocks, a final conv,
all over the whole body residual, then the sub-pixel ConvTranspose(ch→3, 5,
stride=scale) on kernel B2 (``ops.layers.SubpixelConvTranspose``) and a
bilinear resize to (height, width).

In eval mode every layer runs on the weights ``prepare()`` derived; in train
mode each derives them from the live parameters on every call, and the tail
runs B2 through its autograd Function. ``quantized`` (inference only) runs
the encoder, the blocks and body_tail as int8 dynamic-range convs (kernel Q1
on the card); the tail stays float (B2), as in the JAX package.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.ops.layers import SubpixelConvTranspose, WNConv


class _DoubleConv(nn.Module):
    """conv k → ReLU → conv k, both weight-normed with g = ||v|| at init
    (flax's ``WNConv_0``, ``WNConv_1``)."""

    def __init__(self, features, kernel_size, quantized=False):
        super().__init__()
        self.WNConv_0 = WNConv(features, features, kernel_size, g_init=None, quantized=quantized)
        self.WNConv_1 = WNConv(features, features, kernel_size, g_init=None, quantized=quantized)

    def forward(self, x):
        if self.training:
            return self.WNConv_1.forward_live(F.relu(self.WNConv_0.forward_live(x)))
        return self.WNConv_1(F.relu(self.WNConv_0(x)))


class SingleImageModel(nn.Module):
    """Parameter names follow the flax module's: ``encoder``,
    ``block_{i}/WNConv_{0,1}``, ``body_tail`` (WNConv ``v``/``g``/``b``) and
    ``shuf`` (the raw ConvTranspose ``kernel``/``bias``)."""

    def __init__(self, scale=4, channel=32, blocks=8, kernel=3, compute_dtype=torch.float32, quantized=False):
        super().__init__()
        self.scale = scale
        self.num_blocks = blocks
        self.compute_dtype = compute_dtype
        self.quantized = quantized
        self.encoder = WNConv(3, channel, 3, g_init=None, quantized=quantized)
        for i in range(blocks):
            setattr(self, f"block_{i}", _DoubleConv(channel, kernel, quantized))
        self.body_tail = WNConv(channel, channel, 3, g_init=None, quantized=quantized)
        self.shuf = SubpixelConvTranspose(channel, 3, kernel_size=5, stride=scale)
        self.prepare()

    def _convs(self):
        blocks = [getattr(self, f"block_{i}") for i in range(self.num_blocks)]
        return [self.encoder, *(c for b in blocks for c in (b.WNConv_0, b.WNConv_1)), self.body_tail, self.shuf]

    def prepare(self):
        for conv in self._convs():
            conv.prepare(self.compute_dtype)

    def forward(self, x, height=1080, width=1920):
        """x: (B, T, H, W, C) → (B, T, height, width, C) in x.dtype."""
        in_dtype = x.dtype
        b, t, h, w, c = x.shape
        xf = x.to(self.compute_dtype).reshape(b * t, h, w, c)
        live = self.training
        y = self.encoder.forward_live(xf) if live else self.encoder(xf)
        z = y
        for i in range(self.num_blocks):
            z = getattr(self, f"block_{i}")(z) + z
        z = self.body_tail.forward_live(z) if live else self.body_tail(z)
        shuf = self.shuf.forward_live if live else self.shuf
        y = shuf(z + y, out_hw=(height, width), align_corners=False)
        return y.reshape(b, t, height, width, c).to(in_dtype)
