"""Kernel B1: 5x5 SAME conv, NHWC, f32 accumulation, + bias, optional ReLU.

Replaces mobilesuperresolution_tpu/kernels/conv5x5.py::conv5x5_same (Pallas)
with the hand-written CUDA kernel csrc/conv5x5.cu. bf16 inputs (the main
path: SpyNet's space-to-depth convs) run a Hopper implicit GEMM: wgmma with A
loaded from a swizzled shared-memory halo by ldmatrix and B (the weights) by
descriptor, fed by a ring of stages (bulk copies of the packed weights on an
mbarrier, cp.async for the halo); it is bound by tensor-core throughput at
SpyNet's finest level. float32 inputs run a CUDA-core kernel in full f32
FMA. Routing by dtype between these two hand kernels is a design choice, not
a fallback; see the source note. On CPU tensors the wrapper runs
``conv5x5_same_plain``; on CUDA tensors it launches a kernel or raises.
"""

import ctypes

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"conv5x5_same_launch": [_P] * 5 + [_I] * 7 + [_P]}


def pack_weights(w):
    """HWIO (5, 5, Cin, Cout) → (25, Cin/8, Cout/64, 8, 64): for each tap and
    group of 8 input channels, atoms of 8 input x 64 output channels in the
    order the bf16 kernel's weight stages hold them in shared memory (the
    128-byte swizzle of wgmma: in row r, 16-byte chunk c holds output
    channels 8 (c ^ r) .. + 7 of the atom), so each stage is a few contiguous
    runs. Needs Cin a multiple of 8 and Cout of 64; every tile of the kernel
    reads the same packing."""
    _, _, cin, cout = w.shape
    atoms = w.reshape(25, cin // 8, 8, cout // 64, 8, 8).permute(0, 1, 3, 2, 4, 5)  # tap, kg, mg, r, j, e
    r = torch.arange(8, device=w.device)
    return atoms[:, :, :, r[:, None], r[None, :] ^ r[:, None]].reshape(25, cin // 8, cout // 64, 8, 64).contiguous()


def conv5x5_same_plain(x, w, b, relu=False):
    """Plain PyTorch version: x (N, H, W, Cin), w (5, 5, Cin, Cout) HWIO,
    b (Cout,) → (N, H, W, Cout) in x.dtype."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype), b.to(x.dtype), padding=2
    )
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def conv5x5_same(x, w, b, relu=False, w_packed=None):
    """x: (N, H, W, Cin) bf16 or f32; w: (5, 5, Cin, Cout) in x.dtype;
    b: (Cout,), added in float32. Returns the SAME 5x5 conv (N, H, W, Cout)
    in x.dtype, optionally with a fused ReLU. Any N, H, W, Cin, Cout.
    w_packed: optionally ``pack_weights(w)``, made once by a caller that
    reuses w (SpyNet's prepare). The bf16 kernel decides where it reads it:
    in N tiles of 64 and 128 whose Cin chunk divides Cin (csrc/conv5x5.cu,
    launch_wgmma). When it is not given, w is packed per call only where
    every tile the kernel may pick reads it: Cin and Cout multiples of 64."""
    if x.device.type == "cpu":
        return conv5x5_same_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv5x5_same: unsupported device {x.device}")
    if x.dim() != 4 or w.shape[:3] != (5, 5, x.shape[-1]) or b.shape != (w.shape[3],):
        raise ValueError(f"conv5x5_same: bad shapes x={tuple(x.shape)} w={tuple(w.shape)} b={tuple(b.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise ValueError(f"conv5x5_same: x and w must both be bf16 or f32, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv5x5_same: x and w must be contiguous")
    if not (w.device == x.device == b.device) or x.device.index != torch.cuda.current_device():
        raise ValueError("conv5x5_same: tensors must lie on the current CUDA device")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    wp = None
    if x.dtype == torch.bfloat16 and cin % 8 == 0 and cout % 64 == 0:
        wp = pack_weights(w) if w_packed is None and cin % 64 == 0 else w_packed
    if wp is not None:
        if wp.shape != (25, cin // 8, cout // 64, 8, 64) or wp.dtype != w.dtype or wp.device != w.device:
            raise ValueError(f"conv5x5_same: w_packed {tuple(wp.shape)} {wp.dtype} is not pack_weights(w)")
        wp = wp.contiguous()
    bias = b.float().contiguous()
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv5x5", _SIGNATURES)
    _build.launch(
        lib, "conv5x5_same_launch",
        x.data_ptr(), w.data_ptr(), None if wp is None else wp.data_ptr(), bias.data_ptr(), y.data_ptr(),
        n, h, wd, cin, cout, int(relu), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream,
    )
    conv5x5_same.launches += 1
    return y


conv5x5_same.launches = 0
