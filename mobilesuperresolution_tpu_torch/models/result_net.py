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
"""

import torch
import torch.nn as nn

from mobilesuperresolution_tpu_torch.kernels.fused_tail import fused_conv_pixel_shuffle_skip
from mobilesuperresolution_tpu_torch.nas.artifact import read_block_index
from mobilesuperresolution_tpu_torch.ops.layers import WNConv


class _SplitConvBlock(nn.Module):
    def __init__(self, channels_in, split, kernel_size):
        super().__init__()
        self.passthrough = channels_in - split
        self.WNConv_0 = WNConv(split, split, kernel_size, g_init=None)

    def prepare(self, dtype):
        self.WNConv_0.prepare(dtype)

    def forward(self, x):
        p = self.passthrough
        x1, x2 = (x[..., :p], x[..., p:]) if p > 0 else (None, x)
        x2 = torch.relu(self.WNConv_0(x2)) + x2
        return x2 if x1 is None else torch.cat([x1, x2], dim=-1)


class ResultNet(nn.Module):
    """idx: sequence of (IN, split, kernel) triples, the final line of
    block_index.txt (see nas/artifact.py)."""

    def __init__(self, scale, idx, image_mean=0.5, compute_dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.idx = tuple(tuple(b) for b in idx)
        self.image_mean = image_mean
        self.compute_dtype = compute_dtype
        num_outputs = scale * scale * 3
        ch = self.idx[0][0]
        self.head = WNConv(3, ch, 3, g_init=None)
        for i, (cin, split, kernel) in enumerate(self.idx):
            setattr(self, f"block_{i}", _SplitConvBlock(cin, split, kernel))
        self.tail = WNConv(self.idx[-1][0], num_outputs, 3, g_init=None)
        self.skip = WNConv(3, num_outputs, 5, g_init=None)
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
        self._tail_bias = self.tail._b.float() + self.skip._b.float()

    def forward(self, x):
        """x: (B, H, W, 3) in [0, 1] → (B, scale·H, scale·W, 3) in x.dtype."""
        in_dtype = x.dtype
        x = x.to(self.compute_dtype) - self.image_mean
        y = self.head(x)
        for blk in self.blocks():
            y = blk(y)
        y = fused_conv_pixel_shuffle_skip(
            y.contiguous(), self.tail.kernel, self._tail_bias, self.scale,
            x.contiguous(), self.skip.kernel,
        )
        # the reference never re-adds image_mean here
        return y.to(in_dtype)
