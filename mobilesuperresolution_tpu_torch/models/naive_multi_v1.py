"""NAS-searched multi-frame VSR, v1: every block consumes temporal context
(counterpart of mobilesuperresolution_tpu/models/naive_multi_v1.py), the
"multi_v1" type.

Per frame t and block i, the block input is concat(x_warp, y): x_warp is
frame t-1's output of block i warped to frame t by the forward flow (zero
padding), and frame 0 uses y itself. A block is [conv k 2IN→IN, conv k
IN→IN, ReLU] plus a 1x1 skip 2IN→IN. Each frame's output is
depth_to_space(decode3x3(y) + skip5x5(x - 0.5), s) with weight-normed convs
(g_init None) and no bilinear base.

This is a true recurrence over frames (the carry is one feature map per
block), so the body runs as a Python loop over time, batched over B. What
does not depend on the recurrence runs batched over B·T: SpyNet
(``flownet``, kernel B1) once over every (t-1, t) pair, the encoder, and the
tail, which is kernel B4's function (kernels/fused_tail.py::
fused_conv_pixel_shuffle_skip): one launch over all B·T frames, with its
weights packed once per ``prepare()`` on the card.

In eval mode every layer runs on the weights ``prepare()`` derived. In train
mode the convs derive theirs from the live parameters on every call (B4
through ``FusedTailSkipFn``), and SpyNet, which the trainer freezes,
computes the flows on its prepared weights without a gradient.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import fused_tail
from mobilesuperresolution_tpu_torch.kernels.fused_tail import FusedTailSkipFn, fused_conv_pixel_shuffle_skip
from mobilesuperresolution_tpu_torch.models.spynet import SpyNet
from mobilesuperresolution_tpu_torch.nas.artifact import read_block_index
from mobilesuperresolution_tpu_torch.ops.layers import PlainConv, WNConv
from mobilesuperresolution_tpu_torch.ops.warp import flow_warp

IMAGE_MEAN = 0.5


class _BlockV1(nn.Module):
    """conv k → conv k → ReLU, plus a 1x1 ``skip`` of the block input (flax's
    ``PlainConv_0``, ``PlainConv_1``, ``skip``)."""

    def __init__(self, features, kernel_size):
        super().__init__()
        self.PlainConv_0 = PlainConv(2 * features, features, kernel_size)
        self.PlainConv_1 = PlainConv(features, features, kernel_size)
        self.skip = PlainConv(2 * features, features, 1)

    def convs(self):
        return (self.PlainConv_0, self.PlainConv_1, self.skip)

    def forward(self, x_cat):
        c0, c1, skip = (c.forward_live for c in self.convs()) if self.training else self.convs()
        return F.relu(c1(c0(x_cat))) + skip(x_cat)


class _FrameStepV1(nn.Module):
    """The per-frame layers (flax's ``frame_step`` scope): ``encode``,
    ``block_{i}``, ``decode`` and ``skip``."""

    def __init__(self, idx, channel, scale):
        super().__init__()
        self.encode = WNConv(3, channel, 3, g_init=None)
        for i, (_, _, kernel) in enumerate(idx):
            setattr(self, f"block_{i}", _BlockV1(channel, kernel))
        n_out = scale * scale * 3
        self.decode = WNConv(channel, n_out, 3, g_init=None)
        self.skip = WNConv(3, n_out, 5, g_init=None)


class NaiveMultiModelV1(nn.Module):
    """``idx``: the searched blocks' (channels, split, kernel); the first
    block's channels set the width of every block. Parameter names follow the
    flax module's: ``flownet/...`` and ``frame_step/{encode, block_{i}/...,
    decode, skip}``."""

    def __init__(self, scale, idx, compute_dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.idx = tuple(tuple(b) for b in idx)
        self.compute_dtype = compute_dtype
        self.channels = self.idx[0][0]
        self.flownet = SpyNet()
        self.frame_step = _FrameStepV1(self.idx, self.channels, scale)
        self.prepare()

    @classmethod
    def from_artifact(cls, path, scale, **kw):
        """The model of a search's ``block_index.txt`` (its last line)."""
        _, width = read_block_index(path)
        return cls(scale=scale, idx=width, **kw)

    def blocks(self):
        return [getattr(self.frame_step, f"block_{i}") for i in range(len(self.idx))]

    def prepare(self):
        dt, fs = self.compute_dtype, self.frame_step
        self.flownet.prepare(dt)
        for conv in [fs.encode, *(c for b in self.blocks() for c in b.convs()), fs.decode, fs.skip]:
            conv.prepare(dt)
        self._tail_bias = self._live_tail_bias().detach()
        self._tail_packed = fused_tail.pack_for_card(fs.decode.kernel, fs.skip.kernel, self._tail_bias, self.scale, dt)

    def _live_tail_bias(self):
        """B4's bias, float32: both convs' biases rounded to the compute dtype."""
        dt, fs = self.compute_dtype, self.frame_step
        return fs.decode.b.to(dt).float() + fs.skip.b.to(dt).float()

    def _flows(self, x):
        """(T-1, B, H, W, 2): SpyNet's forward flow of each (t-1, t) pair, all
        pairs in one batch."""
        b, t, h, w, c = x.shape
        x1 = x[:, :-1].reshape(b * (t - 1), h, w, c)
        x2 = x[:, 1:].reshape(b * (t - 1), h, w, c)
        # in training SpyNet is frozen: no gradient reaches it
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.training):
            return self.flownet(x2, x1).reshape(b, t - 1, h, w, 2).movedim(1, 0)

    def forward(self, x, height=None, width=None):
        """x: (B, T, H, W, C) → (B, T, scale·H, scale·W, C) in x.dtype;
        height and width are not used (the output is always x scale)."""
        in_dtype = x.dtype
        x = x.to(self.compute_dtype)
        b, t, h, w, c = x.shape
        ch, s, fs, live = self.channels, self.scale, self.frame_step, self.training
        flows = self._flows(x) if t > 1 else None
        x_in = (x - IMAGE_MEAN).reshape(b * t, h, w, c)
        enc = (fs.encode.forward_live(x_in) if live else fs.encode(x_in)).reshape(b, t, h, w, ch)
        carry, outs = [None] * len(self.idx), []
        for ti in range(t):
            y = enc[:, ti]
            for i, blk in enumerate(self.blocks()):
                x_warp = y if ti == 0 else flow_warp(carry[i], flows[ti - 1], padding_mode="zeros")
                y = carry[i] = blk(torch.cat([x_warp, y], dim=-1))
            outs.append(y)
        y = torch.stack(outs, dim=1).reshape(b * t, h, w, ch)
        if live:
            dt = self.compute_dtype
            out = FusedTailSkipFn.apply(y, fs.decode.effective_kernel().to(dt), self._live_tail_bias(),
                                        x_in.contiguous(), fs.skip.effective_kernel().to(dt), s)
        else:
            out = fused_conv_pixel_shuffle_skip(y, fs.decode.kernel, self._tail_bias, s, x_in.contiguous(),
                                                fs.skip.kernel, packed=self._tail_packed)
        return out.reshape(b, t, h * s, w * s, c).to(in_dtype)
