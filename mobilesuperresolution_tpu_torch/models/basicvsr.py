"""BasicVSR: bidirectional recurrent video SR, mobile (``BasicVSR``) and
faithful (``BasicVSROrigin``) (counterpart of
mobilesuperresolution_tpu/models/basicvsr.py).

- Both flow directions of a clip go through ONE batched SpyNet call.
- The two recurrences run as one Python loop over time: the backward leg
  walks reversed time next to the forward leg on the batch axis, and both
  directions' trunks run as block-diagonal dense convs on the channel-stacked
  ``[backward | forward]`` input, as in the JAX package. (As ``groups=2``
  convs, cuDNN added two channel-slicing launches per conv: 13.5 ms of a
  10-frame window's device time against 4.9 ms dense, on an H100.)
- The first step warps the all-zeros carry with a dummy zero flow (a no-op).
- The per-frame reconstruction (fusion → sub-pixel transpose conv on kernel
  B2 → bilinear resize → + bilinear base) runs batched over B·T.

``conv_last`` maps 2·nf → 3 channels, as in the JAX package.
``BasicVSROrigin`` (nf 64, 30 blocks, x4) reconstructs as the paper's
BasicVSR: fusion 1x1 → lrelu → two [3x3 conv, depth_to_space(2), lrelu]
upconvs, each one launch of kernel B2 with its leaky ReLU fused (upconv2 has
256 conv channels) → conv_hr 3x3 → lrelu → conv_last 3x3 → + the 4x
bilinear base → bilinear resize to (height, width).

In eval mode every layer computes on the weights ``prepare()`` derived. In
train mode (the VSR trainer) the trunks, ``fusion`` and ``conv_last`` derive
theirs from the live parameters on every call (B2 through its autograd
Function), and SpyNet, which the trainer freezes, computes the flows on its
prepared weights without a gradient (the JAX package's ``stop_flow_grad``,
exact for a frozen SpyNet); built with ``stop_flow_grad=False`` the model
trains SpyNet with the rest, on its live weights. ``remat recomputes each propagation step in
the backward (``torch.utils.checkpoint``) instead of keeping its
activations: the same gradients in O(1) activation memory in clip length.

``quantized`` (inference only) runs SpyNet's convs and the dual trunks' as
int8 dynamic-range convs (ops/quant.py, kernel Q1 on the card): each trunk
conv quantizes the block-diagonal weight built in the compute dtype, with
one per-sample activation scale over both directions' channels, as the JAX
package does. The reconstruction stays float (B2).
"""

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from mobilesuperresolution_tpu_torch.models.spynet import (
    SpyNet,
    downscale_frames,
    flow_downscale_hw,
    upsample_flow,
)
from mobilesuperresolution_tpu_torch.ops.layers import PlainConv, SubpixelConvTranspose, UpConv
from mobilesuperresolution_tpu_torch.ops.quant import QConvWeight, conv2d_maybe_quantized
from mobilesuperresolution_tpu_torch.ops.resize import resize_bilinear
from mobilesuperresolution_tpu_torch.ops.warp import flow_warp


def lrelu(x):
    return F.leaky_relu(x, negative_slope=0.1)


class _DualTrunk(nn.Module):
    """Both directions' trunks (conv → lrelu → num_block residual blocks) on
    the channel-stacked input [backward | forward]. Parameters
    ``{backward,forward}_{conv0,block<i>_conv1,block<i>_conv2}_{kernel,bias}``
    (HWIO 3x3), as in the JAX checkpoint. In train mode each conv's
    block-diagonal weight is built from the live kernels on every call; its
    off-diagonal blocks are constant zeros, so no gradient reaches them."""

    def __init__(self, in_ch, num_feat, num_block, quantized=False):
        super().__init__()
        self.num_block = num_block
        self.quantized = quantized
        self._names = ["conv0"] + [f"block{i}_conv{j}" for i in range(num_block) for j in (1, 2)]
        for name in self._names:
            ci = in_ch if name == "conv0" else num_feat
            for d in ("backward", "forward"):
                self.register_parameter(f"{d}_{name}_kernel", nn.Parameter(torch.zeros(3, 3, ci, num_feat)))
                self.register_parameter(f"{d}_{name}_bias", nn.Parameter(torch.zeros(num_feat)))
        self.prepare()

    def _dual(self, name, dtype):
        """The block-diagonal OIHW weight [[backward, 0], [0, forward]] and the
        stacked bias of one dual conv, in ``dtype``."""
        kb, kf = (getattr(self, f"{d}_{name}_kernel").permute(3, 2, 0, 1) for d in ("backward", "forward"))
        z = kb.new_zeros(kb.shape)
        w = torch.cat([torch.cat([kb, z], 1), torch.cat([z, kf], 1)], 0)
        b = torch.cat([getattr(self, f"{d}_{name}_bias") for d in ("backward", "forward")])
        return w.to(dtype).contiguous(), b.to(dtype)

    def prepare(self, dtype=None):
        """Derive every dual conv's weights in ``dtype`` (default: the last
        one used), as copies of the parameters."""
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        with torch.no_grad():
            self._w = {name: tuple(t.detach().clone() for t in self._dual(name, dtype)) for name in self._names}
        if self.quantized:
            self._q = {name: QConvWeight(*self._w[name]) for name in self._names}

    def _conv(self, y, name, row_mask):
        if self.quantized:
            out = self._q[name](y)
        else:
            w, b = self._dual(name, y.dtype) if self.training else self._w[name]
            out = conv2d_maybe_quantized(y, w, b)
        return out if row_mask is None else out * row_mask.to(out.dtype)

    def forward(self, y, row_mask=None):
        y = lrelu(self._conv(y, "conv0", row_mask))
        for i in range(self.num_block):
            z = F.relu(self._conv(y, f"block{i}_conv1", row_mask))
            y = y + self._conv(z, f"block{i}_conv2", row_mask)
        return y


class _MergedPropagation(nn.Module):
    """One recurrence step for both directions: warp each direction's carry
    by its own flow (direction-stacked on batch), then run both trunks."""

    def __init__(self, in_ch, num_feat, num_block, quantized=False):
        super().__init__()
        self.num_feat = num_feat
        self.trunks = _DualTrunk(in_ch + num_feat, num_feat, num_block, quantized)

    def forward(self, feat_prop, x_i, flow):
        """feat_prop: (2B, H, W, nf); x_i: (2B, H, W, C); flow: (2B, H, W, 2)."""
        feat_prop = flow_warp(feat_prop, flow, padding_mode="zeros")
        b = feat_prop.shape[0] // 2
        inp = torch.cat([x_i, feat_prop], dim=-1)
        y = self.trunks(torch.cat([inp[:b], inp[b:]], dim=-1))
        nf = self.num_feat
        return torch.cat([y[..., :nf], y[..., nf:]], dim=0)


def compute_flows(spynet_apply, x, flow_downscale=1):
    """x: (B, T, H, W, C) → (flows_forward, flows_backward), each
    (T-1, B, H, W, 2) time-major, both directions in one ``spynet_apply(ref,
    supp)`` batch."""
    b, t, h, w, c = x.shape
    if t == 1:
        empty = x.new_zeros((0, b, h, w, 2))
        return empty, empty
    fh, fw = flow_downscale_hw(h, w, flow_downscale)
    xf = downscale_frames(x, fh, fw)
    x1 = xf[:, :-1].reshape(b * (t - 1), fh, fw, c)
    x2 = xf[:, 1:].reshape(b * (t - 1), fh, fw, c)
    ref = torch.cat([x1, x2], dim=0)
    supp = torch.cat([x2, x1], dim=0)
    flows = upsample_flow(spynet_apply(ref, supp), h, w)
    fb = flows[: b * (t - 1)].reshape(b, t - 1, h, w, 2)
    ff = flows[b * (t - 1):].reshape(b, t - 1, h, w, 2)
    return ff.movedim(1, 0), fb.movedim(1, 0)


def stack_directions(x, flows_forward, flows_backward):
    """x: (B, T, H, W, C) → frames (T, 2B, H, W, C) = [reversed | forward]
    and flows (T, 2B, H, W, 2) with a dummy zero flow prepended for the
    first step (it warps the all-zeros carry, a no-op)."""
    b = x.shape[0]
    xt = x.movedim(1, 0)
    dummy = x.new_zeros((1, b) + tuple(xt.shape[2:4]) + (2,))
    frames = torch.cat([xt.flip(0), xt], dim=1)
    flows = torch.cat(
        [
            torch.cat([dummy, flows_backward.flip(0)], dim=0),
            torch.cat([dummy, flows_forward], dim=0),
        ],
        dim=1,
    )
    return frames, flows


class BasicVSRBase(nn.Module):
    """Shared propagation machinery. Parameters are float32 in the JAX
    layouts; ``prepare()`` derives the compute-dtype weights every layer
    uses, and must run again after the parameters or their device change
    (``train.checkpoint.load_params_npz`` calls it). A subclass whose flows
    come from elsewhere sets ``has_spynet = False`` and has no ``spynet``
    module at all (no parameters, nothing prepared), as in the JAX package."""

    has_spynet = True

    def __init__(self, num_feat, num_block, scale=4, compute_dtype=torch.float32, flow_downscale=1, remat=False,
                 quantized=False, stop_flow_grad=True):
        super().__init__()
        self.quantized = quantized
        self.stop_flow_grad = stop_flow_grad
        self.num_feat = num_feat
        self.num_block = num_block
        self.scale = scale
        self.compute_dtype = compute_dtype
        self.remat = remat
        # SpyNet runs on 1/flow_downscale-res frames and its flow is
        # upsampled (1 = the reference's flows)
        self.flow_downscale = flow_downscale
        if self.has_spynet:
            self.spynet = SpyNet(quantized=quantized)
        self.propagation = _MergedPropagation(3, num_feat, num_block, quantized)

    def prepare(self):
        if self.has_spynet:
            self.spynet.prepare(self.compute_dtype)
        self.propagation.trunks.prepare(self.compute_dtype)

    def _flows(self, x, flows=None):
        """(flows_forward, flows_backward), each (T-1, B, H, W, 2): the
        given time-major pair (the flow-cached serving path,
        serve/flow_cache.py) cast to x.dtype, else SpyNet's."""
        if flows is not None:
            ff, fb = flows
            return ff.to(x.dtype), fb.to(x.dtype)
        if self.training and not self.stop_flow_grad:
            return compute_flows(self.spynet.forward_live, x, self.flow_downscale)
        # in training SpyNet is frozen: no gradient reaches it
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.training):
            return compute_flows(self.spynet, x, self.flow_downscale)

    def forward(self, x, height=1080, width=1920, flows=None):
        """x: (B, T, H, W, C) → (B, T, height, width, C) in x.dtype.
        flows: optional precomputed (flows_forward, flows_backward), each
        (T-1, B, H, W, 2) time-major; SpyNet is then skipped."""
        in_dtype = x.dtype
        x = x.to(self.compute_dtype)
        ff, fb = self._flows(x, flows)
        return self._reconstruct(x, *self._propagate(x, ff, fb), height, width).to(in_dtype)

    def _reconstruct(self, x, out_b, out_f, height, width):
        """The per-frame reconstruction of the (B, T, H, W, nf) features of
        both legs, batched over B·T: (B, T, height, width, C) in the compute
        dtype (the subclass's head)."""
        raise NotImplementedError

    def _propagate(self, x, flows_forward, flows_backward):
        """Step j >= 1 of the backward leg processes frame T-1-j with
        flows_backward[T-1-j]. Returns (out_b, out_f), each (B, T, H, W, nf)
        in forward time order."""
        b, t, h, w, _ = x.shape
        frames, flows = stack_directions(x, flows_forward, flows_backward)
        feat = x.new_zeros((2 * b, h, w, self.num_feat))
        outs = []
        step = self.propagation
        if self.remat and self.training and torch.is_grad_enabled():
            step = functools.partial(torch.utils.checkpoint.checkpoint, self.propagation, use_reentrant=False)
        for i in range(t):
            feat = step(feat, frames[i], flows[i])
            outs.append(feat)
        out = torch.stack(outs)
        return out[:, :b].flip(0).movedim(0, 1), out[:, b:].movedim(0, 1)


class BasicVSR(BasicVSRBase):
    """Mobile-modified BasicVSR: fusion 1x1 (2nf→2nf) → lrelu →
    ConvTranspose(5, stride=scale) → bilinear resize to (H, W) → + bilinear
    base."""

    def __init__(self, num_feat=24, num_block=8, scale=4, compute_dtype=torch.float32, flow_downscale=1,
                 remat=False, quantized=False, stop_flow_grad=True):
        super().__init__(num_feat, num_block, scale, compute_dtype, flow_downscale, remat, quantized, stop_flow_grad)
        self.fusion = PlainConv(2 * num_feat, 2 * num_feat, 1)
        self.conv_last = SubpixelConvTranspose(2 * num_feat, 3, kernel_size=5, stride=scale)
        self.prepare()

    def prepare(self):
        super().prepare()
        self.fusion.prepare(self.compute_dtype)
        self.conv_last.prepare(self.compute_dtype)

    def _reconstruct(self, x, out_b, out_f, height, width):
        b, t, h, w, c = x.shape
        feats = torch.cat([out_b, out_f], dim=-1).reshape(b * t, h, w, 2 * self.num_feat)
        fusion, conv_last = (self.fusion.forward_live, self.conv_last.forward_live) if self.training else (
            self.fusion, self.conv_last)
        out = conv_last(lrelu(fusion(feats)), out_hw=(height, width), align_corners=False)
        out = out + resize_bilinear(x.reshape(b * t, h, w, c), (height, width))
        return out.reshape(b, t, height, width, c)


class BasicVSROrigin(BasicVSRBase):
    """Faithful BasicVSR (x4 only), reconstructing as: fusion 1x1 (2nf→nf) → lrelu → upconv1
    (3x3 nf→4nf, depth_to_space(2), lrelu) → upconv2 (3x3 nf→256,
    depth_to_space(2), lrelu) → conv_hr (3x3 64→64) → lrelu → conv_last
    (3x3 64→3) → + the 4x bilinear base → bilinear resize to (height,
    width). Each upconv is one launch of kernel B2."""

    def __init__(self, num_feat=64, num_block=30, scale=4, compute_dtype=torch.float32, flow_downscale=1,
                 remat=False, quantized=False, stop_flow_grad=True):
        super().__init__(num_feat, num_block, scale, compute_dtype, flow_downscale, remat, quantized, stop_flow_grad)
        self.fusion = PlainConv(2 * num_feat, num_feat, 1)
        self.upconv1 = UpConv(num_feat, 4 * num_feat)
        # 64 * 4 conv channels whatever nf is, as in the reference
        self.upconv2 = UpConv(num_feat, 64 * 4)
        self.conv_hr = PlainConv(64, 64, 3)
        self.conv_last = PlainConv(64, 3, 3)
        self.prepare()

    def _convs(self):
        return (self.fusion, self.upconv1, self.upconv2, self.conv_hr, self.conv_last)

    def prepare(self):
        super().prepare()
        for conv in self._convs():
            conv.prepare(self.compute_dtype)

    def _reconstruct(self, x, out_b, out_f, height, width):
        b, t, h, w, c = x.shape
        feats = torch.cat([out_b, out_f], dim=-1).reshape(b * t, h, w, 2 * self.num_feat)
        fusion, up1, up2, conv_hr, conv_last = (
            (m.forward_live for m in self._convs()) if self.training else self._convs())
        out = up2(up1(lrelu(fusion(feats))))
        out = conv_last(lrelu(conv_hr(out)))
        out = out + resize_bilinear(x.reshape(b * t, h, w, c), (4 * h, 4 * w))
        out = resize_bilinear(out, (height, width))
        return out.reshape(b, t, height, width, c)
