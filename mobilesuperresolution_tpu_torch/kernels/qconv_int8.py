"""Kernel Q1: int8 dynamic-range SAME conv with exact int32 accumulation.

Not a TPU kernel: it replaces the XLA int8 convolution that
mobilesuperresolution_tpu/ops/quant.py::qconv2d runs (``conv_general_dilated``
of int8 operands into int32), which PyTorch has no CUDA path for. The
hand-written CUDA kernel csrc/qconv_int8.cu sums int8 x int8 products in
int32 with ``__dp4a`` and fuses the rescale ``acc * (xs * ks)`` and the
float32 bias into its epilogue, in the JAX package's order, so it equals its
plain version bit for bit. On CPU tensors the wrapper runs
``qconv_int8_plain``; on CUDA tensors it launches the kernel or raises.
"""

import ctypes

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"qconv_int8_launch": [_P] * 6 + [_I] * 8 + [_P]}
KERNEL_SIZES = (1, 3, 5, 7)
CHUNK = 16  # input channels per shared-memory chunk (csrc/qconv_int8.cu)


def co_tile(cout):
    """Output channels per block of the kernel: 8, 16 or 32."""
    return 8 if cout <= 8 else 16 if cout <= 16 else 32


def pack_weights(wq):
    """OIHW int8 (Co, Ci, k, k) → int32 words (Co tiles, Ci chunks, k, k, 4,
    co_tile, 1): for each tile of ``co_tile(Co)`` output channels and chunk of
    16 input channels, the k·k·4 words of each output channel, a word holding
    4 consecutive input channels (the lowest in its low byte, as the kernel
    reads the input), zero past Ci and Co. Made once per weight."""
    co, ci, k, _ = wq.shape
    t = co_tile(co)
    ct, chunks = -(-co // t), -(-ci // CHUNK)
    w = wq.new_zeros((ct * t, chunks * CHUNK, k, k))
    w[:co, :ci] = wq
    w = w.reshape(ct, t, chunks, 4, 4, k, k).permute(0, 2, 5, 6, 3, 1, 4)
    return w.contiguous().view(torch.int32)


def qconv_int8_plain(xq, wq, xs, ks, bias=None, out_dtype=torch.float32):
    """Plain PyTorch version: xq (N, H, W, Ci) int8, wq (Co, Ci, k, k) int8,
    xs (N,) and ks (Co,) float32, bias (Co,) float32 or None. The integer
    conv runs in float64, exact while every partial sum stays below 2^53
    (127² · 6,400 ≈ 1.0e8 at SpyNet's widest), then
    ``acc.float() * (xs · ks) (+ bias)`` in float32, cast to ``out_dtype``."""
    k = wq.shape[-1]
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), padding=k // 2).to(torch.int32)
    y = acc.permute(0, 2, 3, 1).float() * (xs.float().reshape(-1, 1, 1, 1) * ks.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def qconv_int8(xq, wq, xs, ks, bias=None, out_dtype=torch.float32, packed=None):
    """The int8 SAME conv of ``qconv_int8_plain``, on the card by kernel Q1.
    k in (1, 3, 5, 7), any N, H, W, Ci, Co; ``out_dtype`` float32 or
    bfloat16. ``packed``: optionally ``pack_weights(wq)``, made once by a
    caller that reuses the weight (``ops.quant.QConvWeight``)."""
    if xq.device.type == "cpu":
        return qconv_int8_plain(xq, wq, xs, ks, bias, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"qconv_int8: unsupported device {xq.device}")
    co, ci, k, k2 = wq.shape
    n, h, wd, cin = xq.shape
    if k != k2 or k not in KERNEL_SIZES or ci != cin or xs.shape != (n,) or ks.shape != (co,) or (
            bias is not None and bias.shape != (co,)):
        raise ValueError(f"qconv_int8: bad shapes xq={tuple(xq.shape)} wq={tuple(wq.shape)} xs={tuple(xs.shape)} "
                         f"ks={tuple(ks.shape)} bias={None if bias is None else tuple(bias.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qconv_int8: needs int8 operands and an f32 or bf16 output, got {xq.dtype}, {wq.dtype}, "
                         f"{out_dtype}")
    tensors = [xq, wq, xs, ks] + ([] if bias is None else [bias])
    if any(t.device != xq.device for t in tensors) or xq.device.index != torch.cuda.current_device():
        raise ValueError("qconv_int8: tensors must lie on the current CUDA device")
    if packed is None:
        packed = pack_weights(wq)
    t = co_tile(co)
    if packed.shape != (-(-co // t), -(-ci // CHUNK), k, k, 4, t, 1) or packed.dtype != torch.int32:
        raise ValueError(f"qconv_int8: packed {tuple(packed.shape)} {packed.dtype} is not pack_weights(wq)")
    xq = xq.contiguous()
    xs, ks = xs.float().contiguous(), ks.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    y = torch.empty((n, h, wd, co), dtype=out_dtype, device=xq.device)
    lib = _build.load("qconv_int8", _SIGNATURES)
    _build.launch(
        lib, "qconv_int8_launch",
        xq.data_ptr(), packed.data_ptr(), xs.data_ptr(), ks.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), n, h, wd, cin, co, k, t, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream,
    )
    qconv_int8.launches += 1
    return y


qconv_int8.launches = 0
