"""Kernel B1: 5x5 SAME conv, NHWC, f32 accumulation, + bias, optional ReLU.

Replaces mobilesuperresolution_tpu/kernels/conv5x5.py::conv5x5_same (Pallas)
with the hand-written CUDA kernel csrc/conv5x5.cu. bf16 inputs (the main
path: SpyNet's space-to-depth convs) run a Hopper implicit GEMM: wgmma with A
loaded from a swizzled shared-memory halo by ldmatrix and B (the weights) by
descriptor, fed by a ring of stages (bulk copies of the packed weights on an
mbarrier, cp.async for the halo); it is bound by tensor-core throughput at
SpyNet's finest level. float32 inputs (the VSR training step, f32 eval)
run a 3xTF32 implicit GEMM on the tensor cores (each operand split into
tf32 hi and lo, so no low bit is lost) on the tile the launcher picks per
call (``f32_plan``): 8-warp tiles of 64 or 128 channels on tf32 wgmma where
the weights come split and packed (``pack_weights_f32``, once, in SpyNet's
prepare), else mma.sync m16n8k8 with the weights split in registers, whole
images folded together at the coarse pyramid levels and taps that read only
padding skipped. Each output sums K
in an order fixed by Cin with the same tf32 products on both routes, so
every plan gives the same bits. It is bound by operations at 3xTF32 (165
TFLOP/s) on the fine levels. Routing by dtype and tile between these hand
kernels is a design choice, not a fallback; see the source note. On CPU
tensors the wrapper runs ``conv5x5_same_plain``; on CUDA tensors it
launches a kernel or raises.
"""

import ctypes

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "conv5x5_same_launch": [_P] * 5 + [_I] * 6 + [_P],
    "conv5x5_same_f32_launch": [_P] * 5 + [_I] * 6 + [_P],
    "conv5x5_same_f32_plan": [_I] * 6 + [_P],
}


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


def tf32_split(w):
    """(hi, lo) of a float32 tensor: hi = w rounded to tf32 (to nearest,
    ties away from zero, as cvt.rna.tf32.f32), lo = w - hi; hi + lo == w
    exactly."""
    bits = w.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w - hi


def pack_weights_f32(w):
    """HWIO (5, 5, Cin, Cout) float32 → (Cout/64, Cin/8, 25, 2, 64, 2, 4)
    float32, what the f32 kernel's wgmma route reads: for each tile of 64
    output channels, chunk of 8 input channels and tap, the tf32 hi then lo
    (``tf32_split``) of a K-major k-step, a row of 8 input channels per
    output channel in two 16-byte halves, swapped in rows 4-7 of every 8 (the
    32-byte swizzle: position p of row r holds half p ^ ((r >> 2) & 1)),
    zero past Cin and Cout. Made once per set of weights (SpyNet's prepare);
    without it the f32 launcher takes mma.sync."""
    _, _, cin, cout = w.shape
    tiles, chunks = -(-cout // 64), -(-cin // 8)
    wz = w.new_zeros(5, 5, chunks * 8, tiles * 64)
    wz[:, :, :cin, :cout] = w
    hl = torch.stack(tf32_split(wz))  # hl, ky, kx, c, n
    t = hl.reshape(2, 25, chunks, 2, 4, tiles, 64).permute(5, 2, 1, 0, 6, 3, 4)  # tile, chunk, tap, hl, r, half, j
    r = torch.arange(64, device=w.device)
    pos = torch.arange(2, device=w.device)
    return t[:, :, :, :, r[:, None], pos[None, :] ^ ((r[:, None] >> 2) & 1)].contiguous()


def f32_packed_shape(cin, cout):
    """The shape of ``pack_weights_f32`` of a (5, 5, cin, cout) weight."""
    return (-(-cout // 64), -(-cin // 8), 25, 2, 64, 2, 4)


def f32_plan(n, h, w, cout, packed, sms=None):
    """The f32 launcher's tile (csrc/conv5x5.cu::f32_plan) for an (n, h, w)
    map and cout output channels, with packed weights or without, on ``sms``
    SMs (the current card's when None): (warps, nb, ti, tr, tc), for tests
    and logs. Needs the card's library."""
    if sms is None:
        sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    plan = (ctypes.c_int * 5)()
    _build.launch(_build.load("conv5x5", _SIGNATURES), "conv5x5_same_f32_plan", n, h, w, cout, int(packed), sms,
                  plan)
    return tuple(plan)


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
    every tile the kernel may pick reads it: Cin and Cout multiples of 64.
    float32 runs 3xTF32 on the tile of ``f32_plan``: wgmma for its 8-warp
    tiles, which it picks only where w_packed = ``pack_weights_f32(w)`` is
    given, else mma.sync; both routes give the same bits."""
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
        want, packer = (25, cin // 8, cout // 64, 8, 64), "pack_weights"
    elif x.dtype == torch.float32:
        wp, want, packer = w_packed, f32_packed_shape(cin, cout), "pack_weights_f32"
    if wp is not None:
        if wp.shape != want or wp.dtype != w.dtype or wp.device != w.device:
            raise ValueError(f"conv5x5_same: w_packed {tuple(wp.shape)} {wp.dtype} is not {packer}(w)")
        wp = wp.contiguous()
    bias = b.float().contiguous()
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("conv5x5", _SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    if x.dtype == torch.bfloat16:
        _build.launch(lib, "conv5x5_same_launch", x.data_ptr(), w.data_ptr(), None if wp is None else wp.data_ptr(),
                      bias.data_ptr(), y.data_ptr(), n, h, wd, cin, cout, int(relu), stream)
    else:
        _build.launch(lib, "conv5x5_same_f32_launch", x.data_ptr(), w.data_ptr(),
                      None if wp is None else wp.data_ptr(), bias.data_ptr(), y.data_ptr(), n, h, wd, cin, cout,
                      int(relu), stream)
        conv5x5_same.f32_launches += 1
    conv5x5_same.launches += 1
    return y


# launches of every route, and of the float32 route alone
conv5x5_same.launches = 0
conv5x5_same.f32_launches = 0
