"""NAS-searched multi-frame VSR, the "multi" type (counterpart of
mobilesuperresolution_tpu/models/naive_multi.py).

Per frame: a weight-normed encoder 3→ch; block 0 takes the temporal context
concat(flow, warped previous-frame encoding, current encoding), 2·ch + 2
channels in that order; every block is [conv k → ReLU → conv k] added to the
running feature; the output is depth_to_space(decode(y)) plus a bilinear
base at ``scale`` (align_corners=False).

The context is only the previous frame's encoding, known for every frame
after one batched encoder pass, so the model is frame-parallel: the forward
flows of all (t-1, t) pairs go through SpyNet (``flownet``, kernel B1) in
one batch, frame 0 gets a zero flow and warps its own encoding, and the
body runs batched over B·T. The decode conv and its depth-to-space are one
launch of kernel B2 (3x3 SAME, s²·3 conv channels).

In eval mode every layer runs on the weights ``prepare()`` derived. In train
mode the encoder, blocks and decode derive theirs from the live parameters
on every call (B2 through its autograd Function), and SpyNet, which the
trainer freezes, computes the flows on its prepared weights without a
gradient (the JAX package's ``stop_flow_grad``, exact for a frozen SpyNet).

``quantized`` (inference only) runs SpyNet, the encoder, the blocks and the
decode as int8 dynamic-range convs (ops/quant.py, kernel Q1 on the card), as
the JAX package does; the decode's depth-to-space then runs in torch and B2
is not launched.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels.fused_tail import FusedConvPixelShuffleFn, fused_conv_pixel_shuffle
from mobilesuperresolution_tpu_torch.models.spynet import SpyNet, downscale_frames, flow_downscale_hw, upsample_flow
from mobilesuperresolution_tpu_torch.nas.artifact import read_block_index
from mobilesuperresolution_tpu_torch.ops.layers import PlainConv, WNConv, depth_to_space
from mobilesuperresolution_tpu_torch.ops.resize import resize_bilinear
from mobilesuperresolution_tpu_torch.ops.warp import flow_warp

_SAME3 = ((1, 1), (1, 1))


class _PlainBlock(nn.Module):
    """conv k → ReLU → conv k (flax's ``PlainConv_0``, ``PlainConv_1``)."""

    def __init__(self, in_features, features, kernel_size, quantized=False):
        super().__init__()
        self.PlainConv_0 = PlainConv(in_features, features, kernel_size, quantized)
        self.PlainConv_1 = PlainConv(features, features, kernel_size, quantized)

    def forward(self, x):
        if self.training:
            return self.PlainConv_1.forward_live(F.relu(self.PlainConv_0.forward_live(x)))
        return self.PlainConv_1(F.relu(self.PlainConv_0(x)))


class NaiveMultiModel(nn.Module):
    """``idx``: the searched blocks' (channels, split, kernel); the first
    block's channels set the model's width. Parameter names follow the flax
    module's: ``flownet/level_{i}/...``, ``encode``,
    ``block_{i}/PlainConv_{0,1}/Conv_0/{kernel,bias}``, ``decode``."""

    def __init__(self, scale, idx, compute_dtype=torch.float32, flow_downscale=1, quantized=False):
        super().__init__()
        self.quantized = quantized
        self.scale = scale
        self.idx = tuple(tuple(b) for b in idx)
        self.compute_dtype = compute_dtype
        self.flow_downscale = flow_downscale
        ch = self.idx[0][0]
        self.channels = ch
        self.flownet = SpyNet(quantized=quantized)
        self.encode = WNConv(3, ch, 3, g_init=None, quantized=quantized)
        for i, (_, _, kernel) in enumerate(self.idx):
            setattr(self, f"block_{i}", _PlainBlock(2 * ch + 2 if i == 0 else ch, ch, kernel, quantized))
        self.decode = WNConv(ch, scale * scale * 3, 3, g_init=None, quantized=quantized)
        self.prepare()

    @classmethod
    def from_artifact(cls, path, scale, **kw):
        """The model of a search's ``block_index.txt`` (its last line)."""
        _, width = read_block_index(path)
        return cls(scale=scale, idx=width, **kw)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(len(self.idx))]

    def prepare(self):
        dt = self.compute_dtype
        self.flownet.prepare(dt)
        for conv in [self.encode, *(c for b in self.blocks() for c in (b.PlainConv_0, b.PlainConv_1)), self.decode]:
            conv.prepare(dt)

    def _flows(self, x):
        """(B, T, H, W, 2): zero for frame 0, then SpyNet's forward flow of
        each (t-1, t) pair, all pairs in one batch."""
        b, t, h, w, c = x.shape
        zero = x.new_zeros((b, 1, h, w, 2))
        if t == 1:
            return zero
        fh, fw = flow_downscale_hw(h, w, self.flow_downscale)
        xf = downscale_frames(x, fh, fw)
        x1 = xf[:, :-1].reshape(b * (t - 1), fh, fw, c)
        x2 = xf[:, 1:].reshape(b * (t - 1), fh, fw, c)
        # in training SpyNet is frozen: no gradient reaches it
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.training):
            ff = upsample_flow(self.flownet(x2, x1), h, w)
        return torch.cat([zero, ff.reshape(b, t - 1, h, w, 2)], dim=1)

    def forward(self, x, height=None, width=None):
        """x: (B, T, H, W, C) → (B, T, scale·H, scale·W, C) in x.dtype;
        height and width are not used (the output is always x scale)."""
        in_dtype = x.dtype
        x = x.to(self.compute_dtype)
        b, t, h, w, c = x.shape
        ch, s, live = self.channels, self.scale, self.training
        flows = self._flows(x).reshape(b * t, h, w, 2)
        xf = x.reshape(b * t, h, w, c)
        enc = (self.encode.forward_live(xf) if live else self.encode(xf)).reshape(b, t, h, w, ch)
        # previous-frame encodings; frame 0 warps its own with the zero flow
        prev = torch.cat([enc[:, :1], enc[:, :-1]], dim=1).reshape(b * t, h, w, ch)
        x_warp = flow_warp(prev, flows, padding_mode="zeros")
        y = enc.reshape(b * t, h, w, ch)
        for i, blk in enumerate(self.blocks()):
            y = blk(torch.cat([flows, x_warp, y], dim=-1) if i == 0 else y) + y
        if self.quantized:
            out = depth_to_space(self.decode(y), s)
        elif live:
            dt = self.compute_dtype
            out = FusedConvPixelShuffleFn.apply(y.contiguous(), self.decode.effective_kernel().to(dt),
                                                self.decode.b.to(dt), s, _SAME3, None)
        else:
            out = fused_conv_pixel_shuffle(y.contiguous(), self.decode.kernel, self.decode._b, s, _SAME3)
        out = out + resize_bilinear(xf, (h * s, w * s), align_corners=False)
        return out.reshape(b, t, h * s, w * s, c).to(in_dtype)
