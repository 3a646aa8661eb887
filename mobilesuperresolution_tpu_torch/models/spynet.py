"""SpyNet coarse-to-fine optical flow (counterpart of
mobilesuperresolution_tpu/models/spynet.py).

6-level pyramid: inputs are ImageNet-normalised, avg-pooled 5 times; at each
level a 5-conv 7x7 stack (8→32→64→32→16→2) refines a 2x-upsampled flow
(align_corners=True, flow doubled). Inputs that are not multiples of 32 are
resized up front (align_corners=False) and the flow rescaled back.

On even-sized levels the 7x7 stack runs in space-to-depth form: one s2d,
five exactly transformed 5x5 convs at 4x channels and quarter resolution on
kernel B1 (kernels/conv5x5.py), one d2s. Odd levels fall back to direct 7x7
convs (``F.conv2d``). ``quantized`` runs every conv as an int8
dynamic-range conv (ops/quant.py, kernel Q1 on the card) instead, as the JAX
package does: each kernel cast to the compute dtype, s2d-transformed (scales
per output channel of the transformed kernel, 4x the channels), then
quantized; B1 is not launched.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same, pack_weights, pack_weights_f32
from mobilesuperresolution_tpu_torch.ops.layers import depth_to_space, space_to_depth
from mobilesuperresolution_tpu_torch.ops.quant import QConvWeight, conv2d_maybe_quantized
from mobilesuperresolution_tpu_torch.ops.resize import avg_pool_2x2, replicate_pad_hw, resize_bilinear
from mobilesuperresolution_tpu_torch.ops.s2d_conv import s2d_transform_weights
from mobilesuperresolution_tpu_torch.ops.warp import flow_warp

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_SPYNET_CHANNELS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))


class SpyNetBasicModule(nn.Module):
    """conv7x7 stack 8→32→64→32→16→2 with ReLUs; parameters
    ``conv{i}_kernel`` (7, 7, Cin, Cout) and ``conv{i}_bias``."""

    def __init__(self, quantized=False):
        super().__init__()
        self.quantized = quantized
        for i, (cin, cout) in enumerate(_SPYNET_CHANNELS):
            self.register_parameter(f"conv{i}_kernel", nn.Parameter(torch.zeros(7, 7, cin, cout)))
            self.register_parameter(f"conv{i}_bias", nn.Parameter(torch.zeros(cout)))
        self.prepare()

    def prepare(self, dtype=None):
        """Derive the s2d 5x5 weights (HWIO, and on the card packed for
        kernel B1), and the direct OIHW ones, in ``dtype`` (default: the last
        one used); quantized, the int8 weights of both forms instead."""
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        self._s2d, self._direct = [], []
        if self.quantized:
            for i in range(len(_SPYNET_CHANNELS)):
                k = getattr(self, f"conv{i}_kernel").detach().to(dtype)
                b = getattr(self, f"conv{i}_bias").detach().to(dtype)
                self._s2d.append(QConvWeight(s2d_transform_weights(k).permute(3, 2, 0, 1), b.repeat_interleave(4)))
                self._direct.append(QConvWeight(k.permute(3, 2, 0, 1), b))
            return
        for i in range(len(_SPYNET_CHANNELS)):
            k = getattr(self, f"conv{i}_kernel").detach()
            b = getattr(self, f"conv{i}_bias").detach()
            w2 = s2d_transform_weights(k).to(dtype).contiguous()
            # packed for kernel B1 on the card (bf16: swizzled atoms; f32: the
            # tf32 hi / lo split, K-major); the CPU's plain version does not read it
            wp = None
            if w2.is_cuda and w2.shape[3] % 64 == 0:
                wp = pack_weights_f32(w2) if w2.dtype == torch.float32 else pack_weights(w2)
            # the bias rounded to dtype, kept in f32 as kernel B1 adds it (no cast per call)
            self._s2d.append((w2, b.repeat_interleave(4).to(dtype).float(), wp))
            self._direct.append((k.permute(3, 2, 0, 1).to(dtype).contiguous(), b.to(dtype).clone()))

    def forward(self, x):
        if self.quantized:
            return self._forward_quantized(x)
        last = len(_SPYNET_CHANNELS) - 1
        if x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            y = space_to_depth(x, 2)
            for i, (w2, b2, wp) in enumerate(self._s2d):
                y = conv5x5_same(y, w2, b2, relu=i < last, w_packed=wp)
            return depth_to_space(y, 2)
        y = x
        for i, (w, b) in enumerate(self._direct):
            y = conv2d_maybe_quantized(y, w, b)
            if i < last:
                y = F.relu(y)
        return y

    def _forward_quantized(self, x):
        even = x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
        y = space_to_depth(x, 2) if even else x
        for i, conv in enumerate(self._s2d if even else self._direct):
            y = conv(y)
            if i < len(_SPYNET_CHANNELS) - 1:
                y = F.relu(y)
        return depth_to_space(y, 2) if even else y

    def forward_live(self, x):
        """The stack on the current parameters, differentiably, as direct 7x7
        convs in x.dtype (the s2d form is the same function); quantized,
        ``forward``."""
        if self.quantized:
            return self.forward(x)
        y = x
        for i in range(len(_SPYNET_CHANNELS)):
            k = getattr(self, f"conv{i}_kernel").to(x.dtype).permute(3, 2, 0, 1)
            y = conv2d_maybe_quantized(y, k, getattr(self, f"conv{i}_bias").to(x.dtype))
            if i < len(_SPYNET_CHANNELS) - 1:
                y = F.relu(y)
        return y


class SpyNet(nn.Module):
    """Returns flow (N, H, W, 2) with channel 0 = dx, 1 = dy, in input pixels.
    ``quantized``: int8 dynamic-range convs in every level."""

    def __init__(self, levels=6, quantized=False):
        super().__init__()
        self.levels = levels
        self.quantized = quantized
        for i in range(levels):
            self.add_module(f"level_{i}", SpyNetBasicModule(quantized))
        self.prepare()

    def prepare(self, dtype=None):
        dtype = self._dtype = dtype or getattr(self, "_dtype", torch.float32)
        for i in range(self.levels):
            getattr(self, f"level_{i}").prepare(dtype)
        # made once on the parameters' device: a host tensor built per call
        # would be a synchronising host-to-device copy
        dev = self.level_0.conv0_kernel.device
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=dev)
        self._std = torch.tensor(IMAGENET_STD, dtype=dtype, device=dev)

    def _preprocess(self, x):
        return (x - self._mean.to(x.dtype)) / self._std.to(x.dtype)

    def forward(self, ref, supp):
        return self._pyramid(ref, supp, lambda level, inp: level(inp))

    def forward_live(self, ref, supp):
        """The flow on the current parameters, with gradients to them (a
        SpyNet trained outside the VSR trainers, which keep it frozen)."""
        return self._pyramid(ref, supp, lambda level, inp: level.forward_live(inp))

    def _pyramid(self, ref, supp, run_level):
        if ref.shape != supp.shape:
            raise ValueError(f"ref {tuple(ref.shape)} and supp {tuple(supp.shape)} differ")
        n, h, w, _ = ref.shape
        h32 = int(math.ceil(h / 32.0) * 32)
        w32 = int(math.ceil(w / 32.0) * 32)
        refs = [self._preprocess(resize_bilinear(ref, (h32, w32)))]
        supps = [self._preprocess(resize_bilinear(supp, (h32, w32)))]
        for _ in range(self.levels - 1):
            refs.insert(0, avg_pool_2x2(refs[0]))
            supps.insert(0, avg_pool_2x2(supps[0]))

        h0, w0 = refs[0].shape[1:3]
        flow = ref.new_zeros((n, max(h0 // 2, 1), max(w0 // 2, 1), 2))
        for level in range(self.levels):
            th, tw = refs[level].shape[1:3]
            up = resize_bilinear(flow, (flow.shape[1] * 2, flow.shape[2] * 2), align_corners=True) * 2.0
            # odd level sizes leave the upsampled flow one short: replicate-pad
            # it; the crop covers the 1x1 coarsest level of tiny inputs
            if up.shape[1] < th or up.shape[2] < tw:
                up = replicate_pad_hw(up, max(th - up.shape[1], 0), max(tw - up.shape[2], 0))
            up = up[:, :th, :tw]
            warped = flow_warp(supps[level], up, padding_mode="border")
            inp = torch.cat([refs[level], warped, up], dim=-1)
            flow = run_level(getattr(self, f"level_{level}"), inp) + up

        return scale_flow(resize_bilinear(flow, (h, w)), w / w32, h / h32)


def scale_flow(flow, sx, sy):
    """flow * [sx, sy] over the last axis, the factors rounded to flow.dtype
    first as the JAX package's constant array is."""
    sx, sy = (torch.tensor(v, dtype=flow.dtype).item() for v in (sx, sy))
    return torch.cat([flow[..., :1] * sx, flow[..., 1:] * sy], dim=-1)


def flow_downscale_hw(h, w, d):
    """Flow-computation resolution for a 1/d SpyNet input downscale."""
    return (max(h // d, 1), max(w // d, 1)) if d > 1 else (h, w)


def downscale_frames(x, fh, fw):
    """(B, T, H, W, C) clip resized per frame to (fh, fw) for flow input."""
    b, t, h, w, c = x.shape
    if (fh, fw) == (h, w):
        return x
    return resize_bilinear(x.reshape(b * t, h, w, c), (fh, fw)).reshape(b, t, fh, fw, c)


def upsample_flow(flow, h, w):
    """(..., fh, fw, 2) flow → (..., h, w, 2), values rescaled: channel 0 = dx
    scales with width, 1 = dy with height."""
    fh, fw = flow.shape[-3], flow.shape[-2]
    if (fh, fw) == (h, w):
        return flow
    return scale_flow(resize_bilinear(flow, (h, w)), w / fw, h / fh)
