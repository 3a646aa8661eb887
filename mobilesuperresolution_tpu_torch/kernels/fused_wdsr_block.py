"""Kernel B3: the fused WDSR-B residual block,
x + conv_kxk(zero_pad(W2·relu(W1·x + b1) + b2)) + b3.

Replaces mobilesuperresolution_tpu/kernels/fused_wdsr_block.py::
fused_wdsr_block (Pallas) with the hand-written CUDA kernel
csrc/fused_wdsr_block.cu: the three products on the tensor cores
(mma.sync; 3xTF32 for float32, bf16 for bfloat16), the 6C-channel expansion
in registers and the M-channel h2 tile in shared memory, persistent blocks
with the next tile's input prefetched. Any H and W, and every block WDSR-B
builds at 8 to 64 residual units (E = int(6C), M = int(0.84C), k = 3).
The kernel reads its weights packed once by ``pack_weights``. On CPU tensors
the wrapper runs ``fused_wdsr_block_plain``; on CUDA tensors it launches the
kernel or raises. ``FusedWdsrBlockFn`` gives the block a gradient for
training: the kernel forward, the plain version recomputed backward.
"""

import ctypes

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import _build
from mobilesuperresolution_tpu_torch.kernels._autograd import plain_backward

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fused_wdsr_block_launch": [_P] * 3 + [_I] * 8 + [_P]}
# the padded channel widths the CUDA source is compiled for
WIDTHS = (8, 16, 24, 32, 48, 64)
KERNEL_SIZE = 3


def block_shape(c):
    """(C, E, M, k) of WDSR-B's block at C residual units (models/wdsr_basic.py)."""
    return c, int(c * 6.0), int(c * 0.84), KERNEL_SIZE


def fused_wdsr_block_plain(x, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch version: x (B, H, W, C); w1 (C, E); w2 (E, M);
    w3 (k, k, M, C) HWIO; biases (E,), (M,), (C,). The chain runs in float32
    on the weights as float32: 1x1, ReLU, 1x1, zero-pad by k // 2 (after the
    1x1s, as the reference pads), kxk, + b3 + x, rounded once to x.dtype.
    Returns (B, H, W, C)."""
    k = w3.shape[0]
    xn = x.float().permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(xn, w1.float().t()[:, :, None, None], b1.float()))
    h = F.conv2d(h, w2.float().t()[:, :, None, None], b2.float())
    y = F.conv2d(h, w3.float().permute(3, 2, 0, 1), b3.float(), padding=k // 2)
    return (xn + y).permute(0, 2, 3, 1).to(x.dtype)


def _round_up(n, m):
    return -(-n // m) * m


def _tf32_split(w):
    """(hi, lo): hi = w rounded to TF32 (nearest, ties away, as cvt.rna),
    lo = w - hi, exact in float32."""
    bits = w.contiguous().view(torch.int32).to(torch.int64)
    hi_bits = ((bits + 0x1000) & ~0x1FFF) & 0xFFFFFFFF
    hi = torch.where(hi_bits >= 2**31, hi_bits - 2**32, hi_bits).to(torch.int32).view(torch.float32)
    return hi, w - hi


def _fragments(b, dtype):
    """B operand (K, N) float32, K a multiple of the k-step, N of 8, in
    mma.sync fragment order (csrc/hopper.cuh): for each k-step s and n8 tile
    j, lane 4g + t holds rows k0 + 2t, k0 + 2t + 1 of column 8j + g (and,
    for bf16's 16-deep steps, rows k0 + 8 + 2t, + 1 after them); float32
    lanes are (hi, hi, lo, lo) of the TF32 split. Returns float32 words."""
    kdim, ndim = b.shape
    if dtype == torch.float32:
        v = b.reshape(kdim // 8, 4, 2, ndim // 8, 8).permute(0, 3, 4, 1, 2)  # s, j, g, t, e
        hi, lo = _tf32_split(v)
        return torch.stack((hi, lo), dim=4).reshape(-1)  # s, j, g, t, (hi, lo), e
    v = b.reshape(kdim // 16, 2, 4, 2, ndim // 8, 8).permute(0, 4, 5, 2, 1, 3)  # s, j, g, t, h, e
    return v.to(torch.bfloat16).contiguous().view(torch.float32).reshape(-1)


def _pad(t, *shape):
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _widths(c, e, dtype):
    """(CW, KC, MK, EP): the compiled width for C, GEMM 1's padded depth,
    M padded to the k-step, and E padded to 16 (csrc/fused_wdsr_block.cu)."""
    cw = next(wd for wd in WIDTHS if wd >= c)
    kg = 8 if dtype == torch.float32 else 16
    return cw, _round_up(cw, kg), _round_up(int(cw * 0.84), kg), _round_up(e, 16)


def packed_size(c, e, dtype):
    """float32 words of ``pack_weights`` for a block of C, E channels."""
    cw, kc, mk, ep = _widths(c, e, dtype)
    elems = kc * ep + ep * mk + KERNEL_SIZE**2 * mk * cw
    # a weight is two words (TF32 hi, lo) in f32, half a word in bf16
    return (2 * elems if dtype == torch.float32 else elems // 2) + ep + mk + cw


def pack_weights(w1, b1, w2, b2, w3, b3, dtype=torch.float32):
    """The block's weights in the layout the kernel reads, one contiguous
    float32 tensor: W1, W2 and the k² taps of W3 in mma fragment order
    (``_fragments``), zero-padded to the kernel's compile-time widths for C
    (K of GEMM 1 to the k-step, M to the k-step, E to 16), then b1, b2, b3
    zero-padded, float32. ``dtype`` is the I/O dtype the kernel will run:
    float32 packs the TF32 hi/lo split, bfloat16 the weights rounded to bf16.
    Made once per set of weights (BasicBlock.prepare)."""
    c, e = w1.shape
    m, k = w2.shape[1], w3.shape[0]
    cw, kc, mk, ep = _widths(c, e, dtype)
    w1p = _pad(w1.detach().float(), kc, ep)
    w2p = _pad(w2.detach().float(), ep, mk)
    w3p = _pad(w3.detach().float().reshape(k * k, m, c), k * k, mk, cw)
    parts = [_fragments(w1p, dtype), _fragments(w2p, dtype)]
    parts += [_fragments(w3p[i], dtype) for i in range(k * k)]
    parts += [_pad(b1.detach().float(), ep), _pad(b2.detach().float(), mk), _pad(b3.detach().float(), cw)]
    return torch.cat(parts).contiguous()


def fused_wdsr_block(x, w1, b1, w2, b2, w3, b3, packed=None):
    """x: (B, H, W, C) bf16 or f32, contiguous; weights as in
    ``fused_wdsr_block_plain``, float32 (a model in bf16 rounds them to bf16
    once, in ``prepare``). packed: optionally ``pack_weights(w1, ..., b3,
    x.dtype)``, made once by a caller that reuses the weights; without it
    the wrapper packs per call. Returns the block's output (B, H, W, C) in
    x.dtype."""
    if x.device.type == "cpu":
        return fused_wdsr_block_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"fused_wdsr_block: unsupported device {x.device}")
    if x.dim() != 4 or w1.dim() != 2 or w2.dim() != 2 or w3.dim() != 4:
        raise ValueError("fused_wdsr_block: x must be (B, H, W, C), w1/w2 2-D, w3 4-D")
    c, e = w1.shape
    m, k = w2.shape[1], w3.shape[0]
    if (x.shape[3], w2.shape[0], tuple(w3.shape), b1.shape, b2.shape, b3.shape) != (
        c, e, (k, k, m, c), (e,), (m,), (c,)
    ):
        raise ValueError(
            f"fused_wdsr_block: inconsistent shapes x={tuple(x.shape)} w1={tuple(w1.shape)} "
            f"w2={tuple(w2.shape)} w3={tuple(w3.shape)}"
        )
    if not 8 <= c <= 64 or (c, e, m, k) != block_shape(c):
        raise ValueError(
            f"fused_wdsr_block: (C, E, M, k) = {(c, e, m, k)} is not a WDSR-B block the kernel takes: "
            f"8 <= C <= 64, E = int(6C), M = int(0.84C), k = {KERNEL_SIZE}"
        )
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError("fused_wdsr_block: x must be contiguous bf16 or f32")
    ws = [w1, b1, w2, b2, w3, b3] + ([packed] if packed is not None else [])
    if any(t.device != x.device for t in ws) or x.device.index != torch.cuda.current_device():
        raise ValueError("fused_wdsr_block: tensors must lie on the current CUDA device")
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2, w3, b3, x.dtype)
    elif packed.dtype != torch.float32 or not packed.is_contiguous() or packed.numel() != packed_size(c, e, x.dtype):
        raise ValueError(f"fused_wdsr_block: packed must be pack_weights(..., {x.dtype}), contiguous float32")
    n, h, wd, _ = x.shape
    y = torch.empty_like(x)
    lib = _build.load("fused_wdsr_block", _SIGNATURES)
    _build.launch(
        lib, "fused_wdsr_block_launch",
        x.data_ptr(), packed.data_ptr(), y.data_ptr(),
        n, h, wd, c, e, m, k, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream,
    )
    fused_wdsr_block.launches += 1
    return y


fused_wdsr_block.launches = 0


class FusedWdsrBlockFn(torch.autograd.Function):
    """``fused_wdsr_block`` with a gradient, for training on weights that
    change every step: forward = one kernel launch with the weights packed
    for that call (the plain version on the CPU); backward = the plain
    version recomputed under autograd, differentiated for every input that
    needs a gradient."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3)
        return fused_wdsr_block(x, w1, b1, w2, b2, w3, b3)

    @staticmethod
    def backward(ctx, grad_y):
        return plain_backward(fused_wdsr_block_plain, ctx, grad_y)
