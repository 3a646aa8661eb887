"""Kernel B3: the fused WDSR-B residual block,
x + conv_kxk(zero_pad(W2·relu(W1·x + b1) + b2)) + b3.

Replaces mobilesuperresolution_tpu/kernels/fused_wdsr_block.py::
fused_wdsr_block (Pallas) with the hand-written CUDA kernel
csrc/fused_wdsr_block.cu, which keeps the 6C-channel expansion in registers
and the M-channel h2 tile in shared memory. Bound by f32 operations at the
SISR path's shape (see the source note). Any H and W; the kernel is
instantiated for (C, 6C, M, k) = (24, 144, 20, 3), WDSR-B at 24 residual
units. On CPU tensors the wrapper runs ``fused_wdsr_block_plain``; on CUDA
tensors it launches the kernel or raises.
"""

import ctypes

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fused_wdsr_block_launch": [_P] * 8 + [_I] * 8 + [_P]}
# (C, E, M, k) shapes the CUDA source instantiates
INSTANTIATED = {(24, 144, 20, 3)}


def fused_wdsr_block_plain(x, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch version: x (B, H, W, C); w1 (C, E); w2 (E, M);
    w3 (k, k, M, C) HWIO; biases (E,), (M,), (C,). The chain runs in float32
    on the weights as float32 (as the kernel reads them): 1x1, ReLU, 1x1,
    zero-pad by k // 2 (after the 1x1s, as the reference pads), kxk, + b3 +
    x, rounded once to x.dtype. Returns (B, H, W, C)."""
    k = w3.shape[0]
    xn = x.float().permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(xn, w1.float().t()[:, :, None, None], b1.float()))
    h = F.conv2d(h, w2.float().t()[:, :, None, None], b2.float())
    y = F.conv2d(h, w3.float().permute(3, 2, 0, 1), b3.float(), padding=k // 2)
    return (xn + y).permute(0, 2, 3, 1).to(x.dtype)


def fused_wdsr_block(x, w1, b1, w2, b2, w3, b3):
    """x: (B, H, W, C) bf16 or f32, contiguous; weights as in
    ``fused_wdsr_block_plain``, read as float32 (a model in bf16 rounds them
    to bf16 once, in ``prepare``). Returns the block's output (B, H, W, C) in x.dtype."""
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
    if (c, e, m, k) not in INSTANTIATED:
        raise ValueError(f"fused_wdsr_block: (C, E, M, k) = {(c, e, m, k)} not instantiated; have {INSTANTIATED}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError("fused_wdsr_block: x must be contiguous bf16 or f32")
    ws = [w1, b1, w2, b2, w3, b3]
    if any(t.device != x.device for t in ws) or x.device.index != torch.cuda.current_device():
        raise ValueError("fused_wdsr_block: tensors must lie on the current CUDA device")
    ws = [t.float().contiguous() for t in ws]
    n, h, wd, _ = x.shape
    y = torch.empty_like(x)
    lib = _build.load("fused_wdsr_block", _SIGNATURES)
    _build.launch(
        lib, "fused_wdsr_block_launch",
        x.data_ptr(), *(t.data_ptr() for t in ws), y.data_ptr(),
        n, h, wd, c, e, m, k, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream,
    )
    fused_wdsr_block.launches += 1
    return y


fused_wdsr_block.launches = 0
