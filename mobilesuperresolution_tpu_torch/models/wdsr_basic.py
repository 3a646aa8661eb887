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

In eval mode every layer runs on the weights ``prepare()`` derived (packed
once for the kernels); call it again after the parameters change. In train
mode every layer derives its weights from the live parameters on each call,
rounded to the compute dtype as ``prepare()`` rounds them, and B3 and B4 run
through their autograd Functions (kernel forward, plain-version backward).

``quantized`` (inference only) runs every conv as an int8 dynamic-range conv
(ops/quant.py, kernel Q1 on the card), as the JAX package does: each block
as its three convs, the tail and skip as two, then the add, depth-to-space
and + image_mean in torch; B3 and B4 are not launched.
"""

import math

import torch
import torch.nn as nn

from mobilesuperresolution_tpu_torch.kernels import fused_tail
from mobilesuperresolution_tpu_torch.kernels.fused_tail import FusedTailSkipFn, fused_conv_pixel_shuffle_skip
from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import (
    WIDTHS,
    FusedWdsrBlockFn,
    fused_wdsr_block,
    pack_weights,
)
from mobilesuperresolution_tpu_torch.ops.layers import WNConv, depth_to_space


class BasicBlock(nn.Module):
    """x + conv_k(linear(relu(expand(x)))), one B3 launch."""

    def __init__(self, num_residual_units, kernel_size=3, res_scale=1.0, expand=6.0, linear=0.84, quantized=False):
        super().__init__()
        r = num_residual_units
        e, m = int(r * expand), int(r * linear)
        self.quantized = quantized
        self.WNConv_0 = WNConv(r, e, 1, g_init=2.0, quantized=quantized)
        self.WNConv_1 = WNConv(e, m, 1, g_init=2.0, quantized=quantized)
        self.WNConv_2 = WNConv(m, r, kernel_size, g_init=res_scale, quantized=quantized)
        self.prepare()

    def prepare(self, dtype=None):
        """Derive B3's weights: the weight-normed kernels rounded to
        ``dtype`` and held as float32, (C, E), (E, M), (k, k, M, C); on the
        card also packed once for the kernel (``pack_weights``)."""
        for c in (self.WNConv_0, self.WNConv_1, self.WNConv_2):
            c.prepare(dtype)
        if self.quantized:
            return
        with torch.no_grad():  # copies: a float32 bias's .to(float32) is the parameter
            self._weights = tuple(t.contiguous().clone() for t in self.live_weights())
        w1 = self._weights[0]
        on_card = w1.is_cuda and w1.shape[0] <= WIDTHS[-1]
        self._packed = pack_weights(*self._weights, self.WNConv_0._dtype) if on_card else None

    def live_weights(self):
        """B3's weights from the live parameters, differentiably: the
        weight-normed kernels and the biases rounded to the compute dtype and
        held as float32."""
        convs = (self.WNConv_0, self.WNConv_1, self.WNConv_2)
        dt = self.WNConv_0._dtype
        w1, w2, w3 = (c.effective_kernel().to(dt).float() for c in convs)
        b1, b2, b3 = (c.b.to(dt).float() for c in convs)
        return w1[0, 0], b1, w2[0, 0], b2, w3, b3

    def forward(self, x):
        if self.quantized:
            return x + self.WNConv_2(self.WNConv_1(torch.relu(self.WNConv_0(x))))
        if self.training:
            return FusedWdsrBlockFn.apply(x.contiguous(), *self.live_weights())
        return fused_wdsr_block(x.contiguous(), *self._weights, packed=self._packed)


class BasicModel(nn.Module):
    """WDSR-B ``BASIC_MODEL``. Parameter names follow the flax module's
    (``WNConv_0`` head, ``BasicBlock_{i}``, ``WNConv_1`` tail, ``WNConv_2``
    skip), so a JAX checkpoint loads by key (train/checkpoint.py)."""

    def __init__(self, num_blocks=16, num_residual_units=24, scale=2, num_channels=3,
                 image_mean=0.5, compute_dtype=torch.float32, quantized=False):
        super().__init__()
        self.quantized = quantized
        self.num_blocks = num_blocks
        self.num_residual_units = num_residual_units
        self.scale = scale
        self.num_channels = num_channels
        self.image_mean = image_mean
        self.compute_dtype = compute_dtype
        num_outputs = scale * scale * num_channels
        r = num_residual_units
        q = quantized
        self.WNConv_0 = WNConv(num_channels, r, 3, g_init=1.0, quantized=q)
        res_scale = 1.0 / math.sqrt(num_blocks)
        for i in range(num_blocks):
            setattr(self, f"BasicBlock_{i}", BasicBlock(r, 3, res_scale, quantized=q))
        self.WNConv_1 = WNConv(r, num_outputs, 3, g_init=1.0, quantized=q)
        self.has_skip_conv = num_channels != num_outputs
        if self.has_skip_conv:
            self.WNConv_2 = WNConv(num_channels, num_outputs, 5, g_init=1.0, quantized=q)
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
        if self.has_skip_conv and not self.quantized:
            self._tail_bias = self._live_tail_bias().detach()
            self._tail_packed = fused_tail.pack_for_card(self.WNConv_1.kernel, self.WNConv_2.kernel,
                                                         self._tail_bias, self.scale, dt)

    def _live_tail_bias(self):
        """B4's bias, float32, from the live parameters: both convs' biases
        rounded to the compute dtype, plus image_mean (folded in: exact, as
        depth-to-space only moves values)."""
        dt = self.compute_dtype
        return self.WNConv_1.b.to(dt).float() + self.WNConv_2.b.to(dt).float() + self.image_mean

    def forward(self, x):
        """x: (B, H, W, C) in [0, 1] → (B, scale·H, scale·W, C) in x.dtype."""
        in_dtype = x.dtype
        x = x.to(self.compute_dtype) - self.image_mean
        y = self.WNConv_0.forward_live(x) if self.training else self.WNConv_0(x)
        for blk in self.blocks():
            y = blk(y)
        if self.quantized:
            y = self.WNConv_1(y) + (self.WNConv_2(x) if self.has_skip_conv else x)
            if self.scale > 1:
                y = depth_to_space(y, self.scale)
            return (y + self.image_mean).to(in_dtype)
        if not self.has_skip_conv:  # scale 1: the input itself is the skip
            y = (self.WNConv_1.forward_live(y) if self.training else self.WNConv_1(y)) + x + self.image_mean
        elif self.training:
            dt = self.compute_dtype
            y = FusedTailSkipFn.apply(
                y.contiguous(), self.WNConv_1.effective_kernel().to(dt), self._live_tail_bias(),
                x.contiguous(), self.WNConv_2.effective_kernel().to(dt), self.scale,
            )
        else:
            y = fused_conv_pixel_shuffle_skip(
                y.contiguous(), self.WNConv_1.kernel, self._tail_bias, self.scale,
                x.contiguous(), self.WNConv_2.kernel, packed=self._tail_packed,
            )
        return y.to(in_dtype)
