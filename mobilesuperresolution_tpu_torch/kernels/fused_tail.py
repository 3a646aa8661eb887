"""Kernel B2: conv + bias + depth-to-space + crop, each output pixel written
once; and kernel B4, B2's conv run over a second source as well (the WDSR
tail's 5x5 skip conv), summed before the bias: a sibling kernel in the same
CUDA source, sharing B2's staged loop and epilogue.

Replaces mobilesuperresolution_tpu/kernels/fused_tail.py::
fused_conv_pixel_shuffle (Pallas, 3x3 SAME only) with the hand-written CUDA
kernel csrc/fused_tail.cu, generalised to any kernel size, per-side padding,
scale and crop: the 3x3/pad-1 form of the Pallas kernel and the 2x2/
pad-((1,2),(1,2))/s=4 reconstruction tail of BasicVSR
(ops/layers.py::SubpixelConvTranspose). Bound by bytes at the main-path
shape (see the source note). B4, ``fused_conv_pixel_shuffle_skip``, is the
tail of models/wdsr_basic.py::BasicModel and models/result_net.py::ResultNet:
depth_to_space(conv_tail(body) + conv_skip(x_skip) + bias, s), both convs
SAME. On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches the kernel or raises.
"""

import ctypes

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_conv_pixel_shuffle_launch": [_P] * 4 + [_I] * 15 + [_P],
    "fused_conv_pixel_shuffle_skip_launch": [_P] * 4 + [_I] * 14 + [_P] * 2 + [_I] * 8 + [_P],
}
MAX_CONV_CHANNELS = 64


def _geometry(x, kernel, scale, padding, crop):
    (pt, pb), (pl, pr) = padding
    hc = x.shape[1] + pt + pb - kernel.shape[0] + 1
    wc = x.shape[2] + pl + pr - kernel.shape[1] + 1
    oh, ow = (scale * hc, scale * wc) if crop is None else crop
    if not (0 < oh <= scale * hc and 0 < ow <= scale * wc):
        raise ValueError(f"crop {crop} outside the {scale * hc}x{scale * wc} shuffled output")
    return hc, wc, oh, ow


def _check_channels(name, cc, scale):
    if cc % (scale * scale) or cc > MAX_CONV_CHANNELS:
        raise ValueError(f"{name}: {cc} conv channels, need a multiple of s²={scale * scale} and <= 64")


def _check_cuda(name, x, *others):
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous bf16 or f32")
    if any(t.device != x.device for t in others) or x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors must lie on the current CUDA device")


def _output(x, kernel, scale, padding, crop):
    _, _, oh, ow = _geometry(x, kernel, scale, padding, crop)
    cc = kernel.shape[3]
    return torch.empty((x.shape[0], oh, ow, cc // (scale * scale)), dtype=x.dtype, device=x.device)


def _launch(x, kernel, bias, scale, padding, crop, y, x_skip=None, kernel_skip=None):
    """Launch csrc/fused_tail.cu on checked CUDA tensors: B2, or B4 when
    ``x_skip`` is given. Kernels and bias are rounded to x.dtype, then read
    as f32."""
    hc, wc, oh, ow = _geometry(x, kernel, scale, padding, crop)
    (pt, _), (pl, _) = padding
    w32 = kernel.to(x.dtype).float().contiguous()
    b32 = bias.to(x.dtype).float().contiguous()
    n, h, wd, cin = x.shape
    fn, skip = "fused_conv_pixel_shuffle_launch", ()
    if x_skip is not None:
        ws32 = kernel_skip.to(x.dtype).float().contiguous()
        k2 = kernel_skip.shape[0]
        fn = "fused_conv_pixel_shuffle_skip_launch"
        skip = (x_skip.data_ptr(), ws32.data_ptr(), x_skip.shape[1], x_skip.shape[2],
                x_skip.shape[3], k2, kernel_skip.shape[1], k2 // 2, kernel_skip.shape[1] // 2)
    lib = _build.load("fused_tail", _SIGNATURES)
    _build.launch(
        lib, fn,
        x.data_ptr(), w32.data_ptr(), b32.data_ptr(), y.data_ptr(),
        n, h, wd, cin, kernel.shape[0], kernel.shape[1], pt, pl, kernel.shape[3], scale,
        min(hc, -(-oh // scale)), min(wc, -(-ow // scale)), oh, ow,
        *skip, int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
    )


def fused_conv_pixel_shuffle_plain(x, kernel, bias, scale, padding=((1, 1), (1, 1)), crop=None):
    """Plain PyTorch version: x (B, H, W, C); kernel (KH, KW, C, s²·C') HWIO;
    bias (s²·C',). Returns depth_to_space(conv(pad(x)) + bias, s) cropped to
    ``crop`` = (out_h, out_w), as (B, out_h, out_w, C') in x.dtype."""
    _, _, oh, ow = _geometry(x, kernel, scale, padding, crop)
    (pt, pb), (pl, pr) = padding
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xp, kernel.permute(3, 2, 0, 1).to(x.dtype), bias.to(x.dtype))
    y = F.pixel_shuffle(y, scale)[:, :, :oh, :ow]
    return y.permute(0, 2, 3, 1)


def fused_conv_pixel_shuffle(x, kernel, bias, scale, padding=((1, 1), (1, 1)), crop=None):
    """x: (B, H, W, C) bf16 or f32; kernel: (KH, KW, C, s²·C'), at most 64
    conv channels; bias: (s²·C',); padding: ((top, bottom), (left, right));
    crop: (out_h, out_w) or None for the whole shuffled map. Accumulates in
    f32 (kernel and bias are read as f32, rounded to x.dtype first) and
    writes (B, out_h, out_w, C') in x.dtype."""
    if x.device.type == "cpu":
        return fused_conv_pixel_shuffle_plain(x, kernel, bias, scale, padding, crop)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pixel_shuffle: unsupported device {x.device}")
    cc = kernel.shape[3]
    if x.dim() != 4 or kernel.shape[2] != x.shape[3] or bias.shape != (cc,):
        raise ValueError(
            f"fused_conv_pixel_shuffle: bad shapes x={tuple(x.shape)} "
            f"kernel={tuple(kernel.shape)} bias={tuple(bias.shape)}"
        )
    _check_channels("fused_conv_pixel_shuffle", cc, scale)
    _check_cuda("fused_conv_pixel_shuffle", x, kernel, bias)
    y = _output(x, kernel, scale, padding, crop)
    _launch(x, kernel, bias, scale, padding, crop, y)
    fused_conv_pixel_shuffle.launches += 1
    return y


fused_conv_pixel_shuffle.launches = 0


def _same(k):
    return ((k // 2, k // 2), (k // 2, k // 2))


def fused_conv_pixel_shuffle_skip_plain(x, kernel, bias, scale, x_skip, kernel_skip):
    """Plain PyTorch version of B4: x (B, H, W, C); kernel (k, k, C, s²·C')
    HWIO; x_skip (B, H, W, C2); kernel_skip (k2, k2, C2, s²·C'); bias
    (s²·C',). Both convs SAME (odd kernels), on kernels rounded to x.dtype,
    summed with the bias in float32 and rounded once: returns
    depth_to_space(conv(x) + conv(x_skip) + bias, s) as (B, s·H, s·W, C') in
    x.dtype."""
    def conv(inp, w):
        k = w.shape[0]
        return F.conv2d(inp.float().permute(0, 3, 1, 2), w.to(x.dtype).float().permute(3, 2, 0, 1), padding=k // 2)

    y = conv(x, kernel) + conv(x_skip, kernel_skip) + bias.to(x.dtype).float()[:, None, None]
    return F.pixel_shuffle(y, scale).permute(0, 2, 3, 1).to(x.dtype)


def fused_conv_pixel_shuffle_skip(x, kernel, bias, scale, x_skip, kernel_skip):
    """x: (B, H, W, C) bf16 or f32; kernel: (k, k, C, s²·C'), k odd, at most
    64 conv channels; x_skip: (B, H, W, C2) in x.dtype; kernel_skip:
    (k2, k2, C2, s²·C'), k2 odd; bias: (s²·C',). Accumulates both SAME convs
    in f32 (kernels and bias rounded to x.dtype first) and writes
    depth_to_space(conv(x) + conv(x_skip) + bias, s) as (B, s·H, s·W, C') in
    x.dtype, each pixel once."""
    if x.device.type == "cpu":
        return fused_conv_pixel_shuffle_skip_plain(x, kernel, bias, scale, x_skip, kernel_skip)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pixel_shuffle_skip: unsupported device {x.device}")
    cc = kernel.shape[3]
    k, k2 = kernel.shape[0], kernel_skip.shape[0]
    if (
        x.dim() != 4 or x_skip.dim() != 4 or x_skip.shape[:3] != x.shape[:3]
        or kernel.shape[:3] != (k, k, x.shape[3]) or kernel_skip.shape != (k2, k2, x_skip.shape[3], cc)
        or bias.shape != (cc,) or k % 2 == 0 or k2 % 2 == 0
    ):
        raise ValueError(
            f"fused_conv_pixel_shuffle_skip: bad shapes x={tuple(x.shape)} kernel={tuple(kernel.shape)} "
            f"x_skip={tuple(x_skip.shape)} kernel_skip={tuple(kernel_skip.shape)} bias={tuple(bias.shape)}"
        )
    _check_channels("fused_conv_pixel_shuffle_skip", cc, scale)
    _check_cuda("fused_conv_pixel_shuffle_skip", x, kernel, bias, x_skip, kernel_skip)
    if x_skip.dtype != x.dtype or not x_skip.is_contiguous():
        raise ValueError("fused_conv_pixel_shuffle_skip: x_skip must be contiguous, in x.dtype")
    y = _output(x, kernel, scale, _same(k), None)
    _launch(x, kernel, bias, scale, _same(k), None, y, x_skip, kernel_skip)
    fused_conv_pixel_shuffle_skip.launches += 1
    return y


fused_conv_pixel_shuffle_skip.launches = 0
