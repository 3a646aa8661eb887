"""Discrete searched SISR model rebuilt from the ``block_index.txt`` artifact
(counterpart of mobilesuperresolution_tpu/models/result_net.py).

Per searched block [IN, split, kernel]: the first IN − split channels pass
through; the last ``split`` go through a residual weight-normed conv k +
ReLU (a dense conv on a channel slice, ``F.conv2d``). The tail 3x3 and the
5x5 skip conv from the mean-subtracted input are one launch of kernel B4
(kernels/fused_tail.py::fused_conv_pixel_shuffle_skip).

Quirk kept from the reference: the forward subtracts image_mean and never
adds it back (mobilesuperresolution_tpu/models/result_net.py:78); the
trained tail convs learned the shift.

In train mode the layers derive their weights from the live parameters on
each call, and the tail runs through B4's autograd Function, as in
models/wdsr_basic.py; in eval mode they use what ``prepare()`` derived.
``quantized`` (inference only) runs every conv as an int8 dynamic-range conv
(ops/quant.py, kernel Q1 on the card): the tail and skip as two, added and
rearranged in torch, so B4 is not launched.
"""

import torch
import torch.nn as nn

from mobilesuperresolution_tpu_torch.kernels import fused_tail
from mobilesuperresolution_tpu_torch.kernels.fused_tail import FusedTailSkipFn, fused_conv_pixel_shuffle_skip
from mobilesuperresolution_tpu_torch.nas.artifact import read_block_index
from mobilesuperresolution_tpu_torch.ops.layers import WNConv, depth_to_space


class _SplitConvBlock(nn.Module):
    def __init__(self, channels_in, split, kernel_size, quantized=False):
        super().__init__()
        self.passthrough = channels_in - split
        self.WNConv_0 = WNConv(split, split, kernel_size, g_init=None, quantized=quantized)

    def prepare(self, dtype):
        self.WNConv_0.prepare(dtype)

    def forward(self, x):
        p = self.passthrough
        x1, x2 = (x[..., :p], x[..., p:]) if p > 0 else (None, x)
        y2 = self.WNConv_0.forward_live(x2) if self.training else self.WNConv_0(x2)
        x2 = torch.relu(y2) + x2
        return x2 if x1 is None else torch.cat([x1, x2], dim=-1)


class ResultNet(nn.Module):
    """idx: sequence of (IN, split, kernel) triples, the final line of
    block_index.txt (see nas/artifact.py)."""

    def __init__(self, scale, idx, image_mean=0.5, compute_dtype=torch.float32, quantized=False):
        super().__init__()
        self.quantized = q = quantized
        self.scale = scale
        self.idx = tuple(tuple(b) for b in idx)
        self.image_mean = image_mean
        self.compute_dtype = compute_dtype
        num_outputs = scale * scale * 3
        ch = self.idx[0][0]
        self.head = WNConv(3, ch, 3, g_init=None, quantized=q)
        for i, (cin, split, kernel) in enumerate(self.idx):
            setattr(self, f"block_{i}", _SplitConvBlock(cin, split, kernel, q))
        self.tail = WNConv(self.idx[-1][0], num_outputs, 3, g_init=None, quantized=q)
        self.skip = WNConv(3, num_outputs, 5, g_init=None, quantized=q)
        self.prepare()

    @classmethod
    def from_artifact(cls, path, scale, **kw):
        _, width = read_block_index(path)
        return cls(scale=scale, idx=width, **kw)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(len(self.idx))]

    def prepare(self):
        dt = self.compute_dtype
        for m in [self.head, *self.blocks(), self.tail, self.skip]:
            m.prepare(dt)
        if self.quantized:
            return
        self._tail_bias = self._live_tail_bias().detach()
        self._tail_packed = fused_tail.pack_for_card(self.tail.kernel, self.skip.kernel, self._tail_bias,
                                                     self.scale, dt)

    def _live_tail_bias(self):
        """B4's bias, float32, from the live parameters: both convs' biases
        rounded to the compute dtype."""
        dt = self.compute_dtype
        return self.tail.b.to(dt).float() + self.skip.b.to(dt).float()

    def forward(self, x):
        """x: (B, H, W, 3) in [0, 1] → (B, scale·H, scale·W, 3) in x.dtype."""
        in_dtype = x.dtype
        x = x.to(self.compute_dtype) - self.image_mean
        y = self.head.forward_live(x) if self.training else self.head(x)
        for blk in self.blocks():
            y = blk(y)
        if self.quantized:
            y = self.tail(y) + self.skip(x)
            return (depth_to_space(y, self.scale) if self.scale > 1 else y).to(in_dtype)
        if self.training:
            dt = self.compute_dtype
            y = FusedTailSkipFn.apply(
                y.contiguous(), self.tail.effective_kernel().to(dt), self._live_tail_bias(),
                x.contiguous(), self.skip.effective_kernel().to(dt), self.scale,
            )
        else:
            y = fused_conv_pixel_shuffle_skip(
                y.contiguous(), self.tail.kernel, self._tail_bias, self.scale,
                x.contiguous(), self.skip.kernel, packed=self._tail_packed,
            )
        # the reference never re-adds image_mean here
        return y.to(in_dtype)
