"""Fixed WDSR-B baseline, the SISR model (counterpart of
mobilesuperresolution_tpu/models/wdsr_basic.py).

Architecture: weight-normed 3x3 head → N residual blocks (1x1 expand x6,
g=2.0 → ReLU → 1x1 linear x0.84, g=2.0 → kxk, g=1/sqrt(N)) → 3x3 tail to
scale²·C channels plus a 5x5 skip conv from the mean-subtracted input, then
depth-to-space(scale) and + image_mean.

Each block is one launch of kernel B3 (kernels/fused_wdsr_block.py), and the
tail, skip, shuffle and mean are one launch of kernel B4
(kernels/fused_tail.py::fused_conv_pixel_shuffle_skip), with image_mean
folded into its bias: depth-to-space only moves values, so adding the mean
to every conv channel is exact. The head stays ``F.conv2d``. NHWC
throughout; compute in ``compute_dtype`` with float32 parameters.
"""

import math

import torch
import torch.nn as nn

from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle_skip
from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import fused_wdsr_block
from mobilesuperresolution_tpu_torch.ops.layers import WNConv


class BasicBlock(nn.Module):
    """x + conv_k(linear(relu(expand(x)))), one B3 launch."""

    def __init__(self, num_residual_units, kernel_size=3, res_scale=1.0, expand=6.0, linear=0.84):
        super().__init__()
        r = num_residual_units
        e, m = int(r * expand), int(r * linear)
        self.WNConv_0 = WNConv(r, e, 1, g_init=2.0)
        self.WNConv_1 = WNConv(e, m, 1, g_init=2.0)
        self.WNConv_2 = WNConv(m, r, kernel_size, g_init=res_scale)
        self.prepare()

    def prepare(self, dtype=None):
        """Derive B3's weights: the weight-normed kernels rounded to
        ``dtype`` and held as float32, (C, E), (E, M), (k, k, M, C)."""
        convs = (self.WNConv_0, self.WNConv_1, self.WNConv_2)
        for c in convs:
            c.prepare(dtype)
        w1, w2, w3 = (c.kernel.float() for c in convs)
        b1, b2, b3 = (c._b.float() for c in convs)
        self._weights = (w1[0, 0].contiguous(), b1, w2[0, 0].contiguous(), b2, w3.contiguous(), b3)

    def forward(self, x):
        return fused_wdsr_block(x.contiguous(), *self._weights)


class BasicModel(nn.Module):
    """WDSR-B ``BASIC_MODEL``. Parameter names follow the flax module's
    (``WNConv_0`` head, ``BasicBlock_{i}``, ``WNConv_1`` tail, ``WNConv_2``
    skip), so a JAX checkpoint loads by key (train/checkpoint.py)."""

    def __init__(self, num_blocks=16, num_residual_units=24, scale=2, num_channels=3,
                 image_mean=0.5, compute_dtype=torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        self.num_residual_units = num_residual_units
        self.scale = scale
        self.num_channels = num_channels
        self.image_mean = image_mean
        self.compute_dtype = compute_dtype
        num_outputs = scale * scale * num_channels
        r = num_residual_units
        self.WNConv_0 = WNConv(num_channels, r, 3, g_init=1.0)
        res_scale = 1.0 / math.sqrt(num_blocks)
        for i in range(num_blocks):
            setattr(self, f"BasicBlock_{i}", BasicBlock(r, 3, res_scale))
        self.WNConv_1 = WNConv(r, num_outputs, 3, g_init=1.0)
        self.has_skip_conv = num_channels != num_outputs
        if self.has_skip_conv:
            self.WNConv_2 = WNConv(num_channels, num_outputs, 5, g_init=1.0)
        self.prepare()

    def blocks(self):
        return [getattr(self, f"BasicBlock_{i}") for i in range(self.num_blocks)]

    def prepare(self):
        dt = self.compute_dtype
        self.WNConv_0.prepare(dt)
        for blk in self.blocks():
            blk.prepare(dt)
        self.WNConv_1.prepare(dt)
        if self.has_skip_conv:
            self.WNConv_2.prepare(dt)
            # image_mean folded into B4's bias (exact: depth-to-space only moves values)
            self._tail_bias = self.WNConv_1._b.float() + self.WNConv_2._b.float() + self.image_mean

    def forward(self, x):
        """x: (B, H, W, C) in [0, 1] → (B, scale·H, scale·W, C) in x.dtype."""
        in_dtype = x.dtype
        x = x.to(self.compute_dtype) - self.image_mean
        y = self.WNConv_0(x)
        for blk in self.blocks():
            y = blk(y)
        if self.has_skip_conv:
            y = fused_conv_pixel_shuffle_skip(
                y.contiguous(), self.WNConv_1.kernel, self._tail_bias, self.scale,
                x.contiguous(), self.WNConv_2.kernel,
            )
        else:  # scale 1: the input itself is the skip
            y = self.WNConv_1(y) + x + self.image_mean
        return y.to(in_dtype)
