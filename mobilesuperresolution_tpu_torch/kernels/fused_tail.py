"""Kernel B2: conv + bias + depth-to-space + crop, each output pixel written
once; and kernel B4, the WDSR / ResultNet tail: B2's function over a second
source (the 5x5 skip conv) summed before the bias.

Replaces mobilesuperresolution_tpu/kernels/fused_tail.py::
fused_conv_pixel_shuffle (Pallas, 3x3 SAME only) with the hand-written CUDA
kernels of csrc/fused_tail.cu. B2 is generalised to any kernel size,
per-side padding, scale and crop: the 3x3/pad-1 form of the Pallas kernel
and the 2x2/pad-((1,2),(1,2))/s=4 reconstruction tail of BasicVSR
(ops/layers.py::SubpixelConvTranspose). It takes any number of conv channels
that s² divides (both kernels tile them over the grid in groups of at most
64, as the Pallas kernel takes any s²·C'; BasicVSROrigin's upconvs have 256)
and an optional leaky-ReLU epilogue (slope 0.1) after the bias. B2 runs one
tensor-core kernel in both dtypes (mma.sync, cp.async double-buffered halo,
persistent grid, depth-to-space staged in shared memory and written out row
by row): bf16 m16n8k16 for bfloat16 (serving), 3xTF32 m16n8k8 for float32
(training; its live weights are split into tf32 hi and lo in the kernel, so
nothing is packed per call, and each output sums K in an order fixed by the
kernel size, Cin and the conv channels). In float32 it groups the conv
channels by 64 where a group's weights stay in shared memory beside two
halos, else by 32 (``basic_origin``'s upconvs). B4, ``fused_conv_pixel_shuffle_skip``,
is the tail of models/wdsr_basic.py::BasicModel and
models/result_net.py::ResultNet: depth_to_space(conv3x3(body) +
conv5x5(x_skip) + bias, s), both SAME, as one implicit GEMM on the tensor
cores in both dtypes (3xTF32 for float32, bf16 for bfloat16), reading its
weights packed once by ``pack_weights``. That routing by dtype between hand
kernels is a design choice, not a fallback. On CPU tensors each wrapper
runs its plain version; on CUDA tensors it launches a kernel or raises.
``FusedConvPixelShuffleFn`` and ``FusedTailSkipFn`` give B2 and B4 a
gradient for training: the kernel forward, the plain version recomputed
backward (the JAX package has no backward kernel for either).
"""

import ctypes
import functools
from collections import Counter

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import _build
from mobilesuperresolution_tpu_torch.kernels._autograd import plain_backward
from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import _fragments, _pad, _round_up

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_conv_pixel_shuffle_launch": [_P] * 4 + [_I] * 15 + [_P],
    "fused_conv_pixel_shuffle_bf16_launch": [_P] * 4 + [_I] * 15 + [_P],
    "fused_conv_pixel_shuffle_skip_launch": [_P] * 4 + [_I] * 9 + [_P],
}
# B2 computes its conv channels in groups of at most 64 that s² divides, so
# it takes s² <= 64
GROUP_CHANNELS = 64
LRELU_SLOPE = 0.1
# B4's shapes: a 3x3 body conv over 1..64 channels, a 5x5 skip conv over
# 1..3 channels, at most 64 conv channels
SKIP_KERNELS = (3, 5)
MAX_CONV_CHANNELS, MAX_BODY_CHANNELS, MAX_SKIP_CHANNELS = 64, 64, 3


def _geometry(x, kernel, scale, padding, crop):
    (pt, pb), (pl, pr) = padding
    hc = x.shape[1] + pt + pb - kernel.shape[0] + 1
    wc = x.shape[2] + pl + pr - kernel.shape[1] + 1
    oh, ow = (scale * hc, scale * wc) if crop is None else crop
    if not (0 < oh <= scale * hc and 0 < ow <= scale * wc):
        raise ValueError(f"crop {crop} outside the {scale * hc}x{scale * wc} shuffled output")
    return hc, wc, oh, ow


def _check_channels(name, cc, scale):
    if cc % (scale * scale) or scale * scale > GROUP_CHANNELS:
        raise ValueError(f"{name}: {cc} conv channels at s={scale}, need a multiple of s² and s² <= "
                         f"{GROUP_CHANNELS}")


def _check_cuda(name, x, *others):
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous bf16 or f32")
    if any(t.device != x.device for t in others) or x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors must lie on the current CUDA device")


def _output(x, kernel, scale, padding, crop):
    _, _, oh, ow = _geometry(x, kernel, scale, padding, crop)
    cc = kernel.shape[3]
    return torch.empty((x.shape[0], oh, ow, cc // (scale * scale)), dtype=x.dtype, device=x.device)


def _launch(x, kernel, bias, scale, padding, crop, lrelu, y):
    """Launch B2 (csrc/fused_tail.cu) on checked CUDA tensors: the
    tensor-core kernel, bf16 or 3xTF32 by x.dtype. Kernel and bias are
    rounded to x.dtype; the kernel reads the kernel in x.dtype and the bias
    as f32."""
    hc, wc, oh, ow = _geometry(x, kernel, scale, padding, crop)
    (pt, _), (pl, _) = padding
    geom = (*x.shape, kernel.shape[0], kernel.shape[1], pt, pl, kernel.shape[3], scale,
            min(hc, -(-oh // scale)), min(wc, -(-ow // scale)), oh, ow, int(bool(lrelu)))
    b32 = bias.to(x.dtype).float().contiguous()
    w = kernel.to(x.dtype).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load("fused_tail", _SIGNATURES)
    fn = "fused_conv_pixel_shuffle_bf16_launch" if x.dtype == torch.bfloat16 else "fused_conv_pixel_shuffle_launch"
    _build.launch(lib, fn, x.data_ptr(), w.data_ptr(), b32.data_ptr(), y.data_ptr(), *geom, stream)


def fused_conv_pixel_shuffle_plain(x, kernel, bias, scale, padding=((1, 1), (1, 1)), crop=None, lrelu=False):
    """Plain PyTorch version: x (B, H, W, C); kernel (KH, KW, C, s²·C') HWIO;
    bias (s²·C',). Returns depth_to_space(conv(pad(x)) + bias, s) cropped to
    ``crop`` = (out_h, out_w), then leaky_relu(·, 0.1) when ``lrelu``, as
    (B, out_h, out_w, C') in x.dtype."""
    _, _, oh, ow = _geometry(x, kernel, scale, padding, crop)
    (pt, pb), (pl, pr) = padding
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xp, kernel.permute(3, 2, 0, 1).to(x.dtype), bias.to(x.dtype))
    y = F.pixel_shuffle(y, scale)[:, :, :oh, :ow]
    if lrelu:
        y = F.leaky_relu(y, LRELU_SLOPE)
    return y.permute(0, 2, 3, 1)


def fused_conv_pixel_shuffle(x, kernel, bias, scale, padding=((1, 1), (1, 1)), crop=None, lrelu=False):
    """x: (B, H, W, C) bf16 or f32; kernel: (KH, KW, C, s²·C'), any number
    of conv channels that s² divides, s² <= 64; bias: (s²·C',); padding:
    ((top, bottom), (left, right)); crop: (out_h, out_w) or None for the
    whole shuffled map; lrelu: a leaky ReLU (slope 0.1) after the bias.
    Accumulates in f32 (kernel and bias rounded to x.dtype first) and writes
    (B, out_h, out_w, C') in x.dtype. On the card both dtypes run the
    tensor-core kernel of csrc/fused_tail.cu, float32 in 3xTF32."""
    if x.device.type == "cpu":
        return fused_conv_pixel_shuffle_plain(x, kernel, bias, scale, padding, crop, lrelu)
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
    _launch(x, kernel, bias, scale, padding, crop, lrelu, y)
    fused_conv_pixel_shuffle.launches += 1
    fused_conv_pixel_shuffle.f32_launches += x.dtype == torch.float32
    return y


# launches of every route, and of the float32 route alone
fused_conv_pixel_shuffle.launches = 0
fused_conv_pixel_shuffle.f32_launches = 0


class FusedConvPixelShuffleFn(torch.autograd.Function):
    """``fused_conv_pixel_shuffle`` with a gradient, for training on weights
    that change every step: ``apply(x, kernel, bias, scale, padding, crop[,
    lrelu])``; forward = one kernel launch (the plain version on the CPU);
    backward = the plain version, activation included, recomputed under
    autograd, differentiated for every input that needs a gradient (in
    x.dtype, as the plain version computes: its casts of kernel and bias
    carry their gradients back to their own dtype)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, scale, padding, crop, lrelu=False):
        ctx.save_for_backward(x, kernel, bias)
        ctx.geometry = (scale, padding, crop, lrelu)
        return fused_conv_pixel_shuffle(x, kernel, bias, scale, padding, crop, lrelu)

    @staticmethod
    def backward(ctx, grad_y):
        def plain(x, kernel, bias):
            return fused_conv_pixel_shuffle_plain(x, kernel, bias, *ctx.geometry)

        # one None for each geometry argument given to apply
        return plain_backward(plain, ctx, grad_y) + (None,) * (len(ctx.needs_input_grad) - 3)


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


def _k_step(dtype):
    """K per mma.sync step: 8 (3xTF32 m16n8k8) for float32, 16 for bf16."""
    return 8 if dtype == torch.float32 else 16


def _bank_conflicts(cp, dtype):
    """The most distinct words one shared-memory bank serves in one phase of
    the A-fragment loads from a halo of pixel stride cp: float32 loads 8
    bytes a lane (rows g 0..3 of a half warp, columns 2t, 2t + 1), bf16 4
    bytes a lane (rows g 0..7, the word of columns 2t, 2t + 1)."""
    if dtype == torch.float32:
        words = {g * cp + 2 * t + e for g in range(4) for t in range(4) for e in range(2)}
    else:
        words = {(g * cp + 2 * t) // 2 for g in range(8) for t in range(4)}
    return max(Counter(w % 32 for w in words).values())


@functools.lru_cache(maxsize=None)
def _pixel_stride(cin, dtype):
    """B4's body halo pixel stride (elements): Cin zero-padded to an even
    count (a whole number of 16-byte chunks when a pixel already is one),
    the one of Cin .. Cin + 16 with the least (k-steps of a kernel row) x
    (2 + bank conflicts of its A loads)."""
    es = 4 if dtype == torch.float32 else 2
    gran = 16 // es if cin * es % 16 == 0 else 2
    return min(range(_round_up(cin, gran), cin + 17, gran),
               key=lambda cp: (-(-3 * cp // _k_step(dtype)) * (2 + _bank_conflicts(cp, dtype)), cp))


def _skip_plan(cin, cc, dtype):
    """(body pixel stride cp, K run of a body kernel row, skip pixel stride,
    K run of a skip kernel row, padded conv channels): the layout
    csrc/fused_tail.cu::tail_skip_kernel reads. The skip's stride is 3 in
    float32 (its A read by 4-byte loads) and 4 in bf16 (read by channel
    pairs)."""
    kg, cp = _k_step(dtype), _pixel_stride(cin, dtype)
    k, k2 = SKIP_KERNELS
    cp2 = 3 if dtype == torch.float32 else 4
    return cp, _round_up(k * cp, kg), cp2, _round_up(k2 * cp2, kg), _round_up(cc, 16)


def packed_size(cin, cc, dtype):
    """float32 words of ``pack_weights`` for a body of Cin channels and cc
    conv channels."""
    _, run, _, run2, npad = _skip_plan(cin, cc, dtype)
    k, k2 = SKIP_KERNELS
    elems = (k * run + k2 * run2) * npad
    # a weight is two words (TF32 hi, lo) in f32, half a word in bf16
    return (2 * elems if dtype == torch.float32 else elems // 2) + npad


def _rows(w, cp, run):
    """HWIO (k, k, C, N) -> the B operand of its k kernel rows, (k * run,
    N): row ky * run + kx * cp + c holds w[ky, kx, c]; the channels past C
    and the values past k * cp of a run are zero."""
    k, _, c, n = w.shape
    out = w.new_zeros(k, run, n)
    out[:, : k * cp].view(k, k, cp, n)[:, :, :c] = w
    return out.reshape(k * run, n)


def pack_weights(kernel, kernel_skip, bias, dtype=torch.float32):
    """B4's weights in the layout the kernel reads, one contiguous float32
    tensor: the body kernel (3, 3, Cin, cc) as 3 row-contiguous K runs over
    a halo of pixel stride ``_pixel_stride(Cin)``, the skip kernel (5, 5, C2,
    cc) as 5 runs over a stride of 3 (float32) or 4 (bf16), each run
    zero-padded to the k-step and cc to 16, both in mma fragment order
    (fused_wdsr_block._fragments: the TF32 hi/lo split for float32, bf16
    values for bfloat16), then the bias zero-padded, float32. Kernels and bias are rounded to ``dtype``
    first, as the plain version rounds them. Made once per set of weights
    (BasicModel.prepare, ResultNet.prepare)."""
    cin, cc = kernel.shape[2], kernel.shape[3]
    cp, run, cp2, run2, npad = _skip_plan(cin, cc, dtype)

    def rounded(t):
        return _pad(t.detach().to(dtype).float(), *t.shape[:-1], npad)

    body = _rows(rounded(kernel), cp, run)
    skip = _rows(rounded(kernel_skip), cp2, run2)
    return torch.cat([_fragments(body, dtype), _fragments(skip, dtype), rounded(bias)]).contiguous()


def _skip_refusal(kernel_shape, kernel_skip_shape, scale):
    """None when B4's kernel takes these kernels, else why not: it takes a
    3x3 body conv over 1..64 channels, a 5x5 skip conv over 1..3 channels
    and at most 64 conv channels, a multiple of s²."""
    k, k2 = SKIP_KERNELS
    cin, c2, cc = kernel_shape[2], kernel_skip_shape[2], kernel_shape[3]
    if (kernel_shape[0], kernel_skip_shape[0]) == (k, k2) and (
        1 <= cin <= MAX_BODY_CHANNELS and 1 <= c2 <= MAX_SKIP_CHANNELS and cc <= MAX_CONV_CHANNELS
        and cc % (scale * scale) == 0
    ):
        return None
    return (f"kernel={tuple(kernel_shape)} kernel_skip={tuple(kernel_skip_shape)} s={scale} not taken: the kernel "
            f"takes a {k}x{k} body conv over 1..{MAX_BODY_CHANNELS} channels, a {k2}x{k2} skip conv over "
            f"1..{MAX_SKIP_CHANNELS} channels and <= {MAX_CONV_CHANNELS} conv channels, a multiple of s²")


def pack_for_card(kernel, kernel_skip, bias, scale, dtype):
    """``pack_weights`` for a model's tail whose weights lie on the card in
    shapes the kernel takes, else None (the CPU runs the plain version; the
    wrapper raises on shapes it does not take)."""
    if not kernel.is_cuda or _skip_refusal(kernel.shape, kernel_skip.shape, scale):
        return None
    return pack_weights(kernel, kernel_skip, bias, dtype)


def _skip_verdict(x, kernel, bias, scale, x_skip, kernel_skip, packed):
    """None when B4's kernel takes these CUDA tensors, else why not."""
    cc = kernel.shape[3]
    k, k2 = kernel.shape[0], kernel_skip.shape[0]
    shapes = (f"x={tuple(x.shape)} kernel={tuple(kernel.shape)} x_skip={tuple(x_skip.shape)} "
              f"kernel_skip={tuple(kernel_skip.shape)} bias={tuple(bias.shape)}")
    if (
        x.dim() != 4 or x_skip.dim() != 4 or x_skip.shape[:3] != x.shape[:3]
        or kernel.shape[:3] != (k, k, x.shape[3]) or kernel_skip.shape != (k2, k2, x_skip.shape[3], cc)
        or bias.shape != (cc,)
    ):
        return f"fused_conv_pixel_shuffle_skip: bad shapes {shapes}"
    why = _skip_refusal(kernel.shape, kernel_skip.shape, scale)
    if why:
        return f"fused_conv_pixel_shuffle_skip: x={tuple(x.shape)} x_skip={tuple(x_skip.shape)} {why}"
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        return "fused_conv_pixel_shuffle_skip: inputs must be contiguous bf16 or f32"
    if x_skip.dtype != x.dtype or not x_skip.is_contiguous():
        return "fused_conv_pixel_shuffle_skip: x_skip must be contiguous, in x.dtype"
    others = (kernel, bias, x_skip, kernel_skip) + ((packed,) if packed is not None else ())
    if any(t.device != x.device for t in others) or x.device.index != torch.cuda.current_device():
        return "fused_conv_pixel_shuffle_skip: tensors must lie on the current CUDA device"
    if packed is not None and (packed.dtype != torch.float32 or not packed.is_contiguous() or packed.data_ptr() % 16
                               or packed.numel() != packed_size(x.shape[3], cc, x.dtype)):
        return f"fused_conv_pixel_shuffle_skip: packed must be pack_weights(..., {x.dtype}), contiguous float32"
    return None


_skip_verdicts = {}
_skip_launcher = []


def fused_conv_pixel_shuffle_skip(x, kernel, bias, scale, x_skip, kernel_skip, packed=None):
    """x: (B, H, W, C) bf16 or f32; kernel: (3, 3, C, s²·C'), 1 <= C <= 64,
    at most 64 conv channels; x_skip: (B, H, W, C2) in x.dtype, C2 <= 3;
    kernel_skip: (5, 5, C2, s²·C'); bias: (s²·C',). Accumulates both SAME
    convs in f32 (kernels and bias rounded to x.dtype first) and writes
    depth_to_space(conv(x) + conv(x_skip) + bias, s) as (B, s·H, s·W, C') in
    x.dtype, each pixel once. packed: optionally ``pack_weights(kernel,
    kernel_skip, bias, x.dtype)``, made once by a caller that reuses the
    weights; without it the wrapper packs per call. On the CPU the plain
    version runs (any odd kernels and widths). The checks of a call's
    shapes, dtypes and devices are kept per key, as B5's wrapper keeps them."""
    if x.device.type == "cpu":
        return fused_conv_pixel_shuffle_skip_plain(x, kernel, bias, scale, x_skip, kernel_skip)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_pixel_shuffle_skip: unsupported device {x.device}")
    key = (x.shape, x.dtype, x.device, x.is_contiguous(), torch.cuda.current_device(), kernel.shape, kernel.device,
           bias.shape, bias.device, scale, x_skip.shape, x_skip.dtype, x_skip.device, x_skip.is_contiguous(),
           kernel_skip.shape, kernel_skip.device,
           packed is None or (packed.dtype, packed.device, packed.is_contiguous(), packed.numel(),
                              packed.data_ptr() % 16))
    if key not in _skip_verdicts:
        _skip_verdicts[key] = _skip_verdict(x, kernel, bias, scale, x_skip, kernel_skip, packed)
    if _skip_verdicts[key] is not None:
        raise ValueError(_skip_verdicts[key])
    if packed is None:
        packed = pack_weights(kernel, kernel_skip, bias, x.dtype)
    if not _skip_launcher:
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        _skip_launcher[:] = [_build.load("fused_tail", _SIGNATURES).fused_conv_pixel_shuffle_skip_launch,
                             raw if raw is not None else (lambda _: torch.cuda.current_stream().cuda_stream)]
    fn, stream = _skip_launcher
    n, h, w, cin = x.shape
    cc = kernel.shape[3]
    y = x.new_empty((n, scale * h, scale * w, cc // (scale * scale)))
    rc = fn(x.data_ptr(), x_skip.data_ptr(), packed.data_ptr(), y.data_ptr(), n, h, w, cin,
            _pixel_stride(cin, x.dtype), x_skip.shape[3], cc, scale, int(x.dtype == torch.bfloat16),
            stream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"fused_conv_pixel_shuffle_skip_launch: CUDA error {rc}")
    fused_conv_pixel_shuffle_skip.launches += 1
    return y


fused_conv_pixel_shuffle_skip.launches = 0


class FusedTailSkipFn(torch.autograd.Function):
    """``fused_conv_pixel_shuffle_skip`` with a gradient, for training on
    weights that change every step: ``apply(x, kernel, bias, x_skip,
    kernel_skip, scale)``; forward = one kernel launch with the weights
    packed for that call (the plain version on the CPU); backward = the
    plain version recomputed under autograd, differentiated for every input
    that needs a gradient."""

    @staticmethod
    def forward(ctx, x, kernel, bias, x_skip, kernel_skip, scale):
        ctx.save_for_backward(x, kernel, bias, x_skip, kernel_skip)
        ctx.scale = scale
        return fused_conv_pixel_shuffle_skip(x, kernel, bias, scale, x_skip, kernel_skip)

    @staticmethod
    def backward(ctx, grad_y):
        def plain(x, kernel, bias, x_skip, kernel_skip):
            return fused_conv_pixel_shuffle_skip_plain(x, kernel, bias, ctx.scale, x_skip, kernel_skip)

        return plain_backward(plain, ctx, grad_y) + (None,)
