"""Kernel B5: the fused separable conv of the NAS supernet,
relu(depthwise_kxk(x) + b_depth) @ w_point + b_point.

Replaces mobilesuperresolution_tpu/kernels/fused_convsep.py::fused_convsep
(Pallas) with the hand-written CUDA kernel csrc/fused_convsep.cu: the
depthwise conv register-blocked on the CUDA cores, its ReLU'd output kept in
registers as the A operand of the 1x1 on the tensor cores (mma.sync; 3xTF32
for float32, bf16 for bfloat16), persistent blocks with the next tile's halo
prefetched. Any H and W, any C and C_out from 1 to 64, k in {3, 5, 7}. On
CPU tensors the wrapper runs ``fused_convsep_plain``; on CUDA tensors it
launches the kernel or raises.

The wrapper is lean because the search calls it 48 times per forward at a
shape where the host sets the pace: it validates each (shapes, dtype,
device) key once and keeps the verdict, converts no weight that is already
contiguous float32, and holds the C function.

``FusedConvSepFn`` makes the kernel trainable: its forward is one launch, its
backward recomputes the branch with the plain version and differentiates
that, as the JAX package differentiates ConvSep with XLA autodiff (it has no
backward kernel either).
"""

import ctypes

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import _build
from mobilesuperresolution_tpu_torch.kernels._autograd import plain_backward

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fused_convsep_launch": [_P] * 6 + [_I] * 7 + [_P]}
MAX_CHANNELS = 64
KERNEL_SIZES = (3, 5, 7)
_verdicts = {}  # call key -> None (launchable) or the ValueError message
_launcher = []  # [C function, current raw stream getter], once loaded


def fused_convsep_plain(x, w_depth, b_depth, w_point, b_point):
    """Plain PyTorch version: x (B, H, W, C); w_depth (k, k, C); b_depth (C,);
    w_point (C, C_out); b_point (C_out,). Depthwise SAME conv (zero padding)
    + b_depth, ReLU, 1x1 conv + b_point, in float32 on the weights as float32,
    rounded once to x.dtype. Returns (B, H, W, C_out)."""
    k, c = w_depth.shape[0], x.shape[-1]
    xn = x.float().permute(0, 3, 1, 2)
    h = F.conv2d(xn, w_depth.float().permute(2, 0, 1)[:, None], b_depth.float(), padding=k // 2, groups=c)
    y = F.conv2d(F.relu(h), w_point.float().t()[:, :, None, None], b_point.float())
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _verdict(x, w_depth, b_depth, w_point, b_point):
    """None if the kernel takes these CUDA tensors, else why not."""
    if x.dim() != 4 or w_depth.dim() != 3 or w_point.dim() != 2:
        return "fused_convsep: x must be (B, H, W, C), w_depth 3-D, w_point 2-D"
    k, c, c_out = w_depth.shape[0], x.shape[3], w_point.shape[1]
    if (tuple(w_depth.shape), tuple(b_depth.shape), w_point.shape[0], tuple(b_point.shape)) != (
        (k, k, c), (c,), c, (c_out,)
    ):
        return (f"fused_convsep: inconsistent shapes x={tuple(x.shape)} w_depth={tuple(w_depth.shape)} "
                f"w_point={tuple(w_point.shape)}")
    if not (1 <= c <= MAX_CHANNELS and 1 <= c_out <= MAX_CHANNELS) or k not in KERNEL_SIZES:
        return (f"fused_convsep: (C, C_out) = {(c, c_out)}, k = {k} not taken; "
                f"need C, C_out <= {MAX_CHANNELS} and k in {KERNEL_SIZES}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        return "fused_convsep: x must be contiguous bf16 or f32"
    if any(t.device != x.device for t in (w_depth, b_depth, w_point, b_point)) or (
        x.device.index != torch.cuda.current_device()
    ):
        return "fused_convsep: tensors must lie on the current CUDA device"
    return None


def _load():
    lib = _build.load("fused_convsep", _SIGNATURES)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw if raw is not None else (lambda _: torch.cuda.current_stream().cuda_stream)
    _launcher[:] = [lib.fused_convsep_launch, stream]


def fused_convsep(x, w_depth, b_depth, w_point, b_point):
    """x: (B, H, W, C) bf16 or f32, contiguous; weights as in
    ``fused_convsep_plain``, read as float32 (a model in bf16 rounds them to
    bf16 first). Returns (B, H, W, C_out) in x.dtype."""
    if x.device.type == "cpu":
        return fused_convsep_plain(x, w_depth, b_depth, w_point, b_point)
    if x.device.type != "cuda":
        raise ValueError(f"fused_convsep: unsupported device {x.device}")
    key = (x.shape, x.dtype, x.device, x.is_contiguous(), torch.cuda.current_device(), w_depth.shape,
           w_depth.device, b_depth.shape, b_depth.device, w_point.shape, w_point.device, b_point.shape,
           b_point.device)
    if key not in _verdicts:
        _verdicts[key] = _verdict(x, w_depth, b_depth, w_point, b_point)
    if _verdicts[key] is not None:
        raise ValueError(_verdicts[key])
    ws = [t if t.dtype == torch.float32 and t.is_contiguous() else t.detach().float().contiguous()
          for t in (w_depth, b_depth, w_point, b_point)]
    if not _launcher:
        _load()
    fn, stream = _launcher
    n, h, w, c = x.shape
    k, c_out = w_depth.shape[0], w_point.shape[1]
    y = x.new_empty((n, h, w, c_out))
    rc = fn(x.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(), ws[2].data_ptr(), ws[3].data_ptr(), y.data_ptr(),
            n, h, w, c, c_out, k, int(x.dtype == torch.bfloat16), stream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"fused_convsep_launch: CUDA error {rc}")
    fused_convsep.launches += 1
    return y


fused_convsep.launches = 0


class FusedConvSepFn(torch.autograd.Function):
    """``fused_convsep`` with a gradient: forward = one kernel launch (the
    plain version on the CPU); backward = the plain version recomputed under
    autograd, differentiated for every input that needs a gradient."""

    @staticmethod
    def forward(ctx, x, w_depth, b_depth, w_point, b_point):
        ctx.save_for_backward(x, w_depth, b_depth, w_point, b_point)
        return fused_convsep(x, w_depth, b_depth, w_point, b_point)

    @staticmethod
    def backward(ctx, grad_y):
        return plain_backward(fused_convsep_plain, ctx, grad_y)
