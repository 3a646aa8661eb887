"""Kernels Q1s and Q1: the int8 dynamic-range SAME conv of a float NHWC
activation, quantized per sample, with exact int32 accumulation.

Not TPU kernels: they replace the per-sample quantization and the XLA int8
convolution (``conv_general_dilated`` of int8 operands into int32) of
mobilesuperresolution_tpu/ops/quant.py::qconv2d, which PyTorch has no CUDA
path for. In csrc/qconv_int8.cu, Q1s computes the per-sample scale
``xs[n] = max(max|x[n]| / 127, 1e-12)`` in one pass over x, and Q1 quantizes
x with it as it stages its input, sums int8 x int8 products in int32 on
Hopper's int8 tensor cores (``wgmma`` s8; Cin < 16 or Cout < 8 on a
CUDA-core ``__dp4a`` kernel, chosen by shape), and fuses the rescale
``acc * (xs * ks)`` and the float32 bias into its epilogue, in the JAX
package's order, so both equal their plain versions bit for bit. On CPU
tensors the wrappers run ``act_scale_plain`` and ``qconv_int8_plain``; on
CUDA tensors they launch the kernels or raise.
"""

import ctypes

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "qconv_int8_launch": [_P] * 7 + [_I] * 6 + [_L] * 2 + [_I] * 4 + [_P],
    "act_scale_launch": [_P] * 3 + [_I] * 4 + [_L] * 2 + [_I] + [_P],
}
KERNEL_SIZES = (1, 3, 5, 7)
EPS = 1e-12
KSTEP = 32  # input channels of one wgmma k-step (32 bytes of int8)
CHUNK = 16  # input channels per shared-memory chunk of the CUDA-core route
N_TILES = (8, 16, 24, 32, 48, 64, 128)  # wgmma widths the tensor-core route is built for


def tensor_cores(ci, co):
    """Whether a conv of ``ci`` -> ``co`` channels runs on the tensor cores:
    narrower ones would be mostly zero padding of a 32-channel k-step or an
    8-wide N tile, and run on the CUDA cores."""
    return ci >= 16 and co >= 8


def n_tile(co):
    """Output channels per block of the tensor-core route: the narrowest
    width that holds ``co``; past 128 the one of 128, 64, 48 that pads
    least (144 = 3 x 48, 256 = 2 x 128)."""
    for t in N_TILES:
        if co <= t:
            return t
    return min((128, 64, 48), key=lambda t: (-(-co // t) * t, -t))


def k_chunk(dtype, ci, co, k):
    """Input channels per staged chunk of the tensor-core route: 64 (two
    k-steps a tap, twice the products per wgmma batch) for bf16 inputs of
    more than 32 channels into N tiles of 64 or 128 with k <= 5, where two
    float and two int8 halos of 64 channels fit in shared memory beside the
    weight stages; else 32."""
    wide = dtype == torch.bfloat16 and k <= 5 and ci > KSTEP and n_tile(co) >= 64
    return 2 * KSTEP if wide and tensor_cores(ci, co) else KSTEP


def co_tile(cout):
    """Output channels per block of the CUDA-core route: 8, 16 or 32."""
    return 8 if cout <= 8 else 16 if cout <= 16 else 32


def pack_weights(wq, kc=KSTEP):
    """The packed weight Q1 reads, made once per weight. OIHW int8 (Co, Ci,
    k, k) →

    - tensor-core route: int8 (N tiles, Ci chunks of kc, k, k, kc / 32,
      n_tile(Co), 2, 16): for each tile of output channels, chunk of input
      channels, tap and k-step, the K-major k-step wgmma reads (a row of 32
      input channels per output channel), its 16-byte halves swapped in rows
      4-7 of every 8 (the 32-byte swizzle), zero past Ci and Co; ``kc`` is
      ``k_chunk``'s for the input's dtype;
    - CUDA-core route: int32 words (Co tiles, Ci chunks of 16, k, k, 4,
      co_tile, 1): the k·k·4 words of each output channel per tile and
      chunk, a word holding 4 consecutive input channels (the lowest in its
      low byte), zero past Ci and Co."""
    co, ci, k, _ = wq.shape
    if tensor_cores(ci, co):
        t = n_tile(co)
        tiles, chunks, ks = -(-co // t), -(-ci // kc), kc // KSTEP
        w = wq.new_zeros((tiles * t, chunks * kc, k, k))
        w[:co, :ci] = wq
        # tile, chunk, ky, kx, k-step, r, half, 16
        w = w.reshape(tiles, t, chunks, ks, 2, 16, k, k).permute(0, 2, 6, 7, 3, 1, 4, 5)
        r = torch.arange(t, device=wq.device)
        pos = torch.arange(2, device=wq.device)
        # position p of row r holds half p ^ ((r >> 2) & 1)
        return w[:, :, :, :, :, r[:, None], pos[None, :] ^ ((r[:, None] >> 2) & 1)].contiguous()
    t = co_tile(co)
    ct, chunks = -(-co // t), -(-ci // CHUNK)
    w = wq.new_zeros((ct * t, chunks * CHUNK, k, k))
    w[:co, :ci] = wq
    w = w.reshape(ct, t, chunks, 4, 4, k, k).permute(0, 2, 5, 6, 3, 1, 4)
    return w.contiguous().view(torch.int32)


def packed_shape(co, ci, k, kc=KSTEP):
    """The shape of ``pack_weights`` of a (co, ci, k, k) weight."""
    if tensor_cores(ci, co):
        t = n_tile(co)
        return (-(-co // t), -(-ci // kc), k, k, kc // KSTEP, t, 2, 16)
    t = co_tile(co)
    return (-(-co // t), -(-ci // CHUNK), k, k, 4, t, 1)


def over_127(a):
    """a / 127, correctly rounded on every device: PyTorch's CUDA division by
    a Python number multiplies by its rounded reciprocal instead, which
    differs in the last bit for some a; a tensor divisor divides."""
    return a / torch.full((), 127.0, dtype=a.dtype, device=a.device)


def act_scale_plain(x):
    """Q1s's plain version: x (N, H, W, C) → the per-sample scale
    max(max|x[n]| / 127, 1e-12), (N,) float32 (``quantize_symmetric``'s over
    dims (1, 2, 3))."""
    return torch.clamp_min(over_127(x.float().abs().amax(dim=(1, 2, 3))), EPS)


def quantize_plain(x, xs):
    """x (N, H, W, C) float → int8, clip(round_half_even(x / xs[n]), -127,
    127) in float32 (``quantize_symmetric``'s rounding with the given
    scale)."""
    return torch.clamp(torch.round(x.float() / xs.float().reshape(-1, 1, 1, 1)), -127, 127).to(torch.int8)


def qconv_int8_plain(x, xs, wq, ks, bias=None):
    """Q1's plain version: x (N, H, W, Ci) f32 or bf16 quantized with xs (N,)
    by ``quantize_plain``, wq (Co, Ci, k, k) int8, ks (Co,) float32, bias
    (Co,) float32 or None. The integer conv runs in float64, exact while
    every partial sum stays below 2^53 (127² · 6,400 ≈ 1.0e8 at SpyNet's
    widest), then ``acc.float() * (xs · ks) (+ bias)`` in float32, cast to
    x.dtype."""
    k = wq.shape[-1]
    xq = quantize_plain(x, xs)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), padding=k // 2).to(torch.int32)
    y = acc.permute(0, 2, 3, 1).float() * (xs.float().reshape(-1, 1, 1, 1) * ks.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _rows(x):
    """x, or a contiguous copy where its W and C are not dense (the kernels
    take any sample and row strides, a row of W·C contiguous elements)."""
    _, _, w, c = x.shape
    if (c == 1 or x.stride(3) == 1) and (w == 1 or x.stride(2) == c):
        return x
    return x.contiguous()


def _check_input(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: needs an (N, H, W, C) float32 or bfloat16 tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x must lie on the current CUDA device")


_lib = None
_scratch = {}


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load("qconv_int8", _SIGNATURES)
    return _lib


def _scale_scratch(device, stream, n):
    """Q1s's scratch on ``device`` for ``stream``, as two addresses: N float32
    scales for a conv that takes them on the way (Q1 reads them right after
    Q1s, in stream order), then the per-sample words (a max and a count
    each), zero between calls. Allocated zeroed once per device and stream
    (grown when N grows); the kernel sets the words back to zero itself."""
    entry = _scratch.get((device.index, stream))
    if entry is None or entry[2] < n:
        cap = max(n, 64)
        buf = torch.zeros(3 * cap, dtype=torch.int32, device=device)
        entry = _scratch[device.index, stream] = (buf, buf.data_ptr(), cap)
    _, base, cap = entry
    return base, base + 4 * cap


def _stream(device):
    """The raw handle of ``device``'s current stream (the kernels launch on it)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def act_scale(x):
    """The per-sample int8 scale of NHWC ``x`` (float32 or bfloat16), (N,)
    float32: on the card by kernel Q1s, one launch."""
    if x.device.type == "cpu":
        return act_scale_plain(x)
    _check_input("act_scale", x)
    x = _rows(x)
    n, h, w, c = x.shape
    xs = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = _stream(x.device)
    _build.launch(_library(), "act_scale_launch", x.data_ptr(), xs.data_ptr(), _scale_scratch(x.device, stream, n)[1],
                  n, h, w, c, x.stride(0), x.stride(1), int(x.dtype == torch.bfloat16), stream)
    act_scale.launches += 1
    return xs


def qconv_int8(x, xs, wq, ks, bias=None, packed=None):
    """The int8 SAME conv of ``qconv_int8_plain``, on the card by kernel Q1:
    x (N, H, W, Ci) float32 or bfloat16 (any sample and row strides), xs its
    per-sample scale, or None to take it on the way (``act_scale``: on the
    card Q1s, launched by the same call before Q1); k in (1, 3, 5, 7), any
    N, H, W, Ci, Co; the output (N, H, W, Co) in x.dtype. ``packed``:
    optionally ``pack_weights(wq, k_chunk(x.dtype, Ci, Co, k))``, made once
    by a caller that reuses the weight (``ops.quant.QConvWeight``)."""
    if x.device.type == "cpu":
        return qconv_int8_plain(x, act_scale_plain(x) if xs is None else xs, wq, ks, bias)
    _check_input("qconv_int8", x)
    co, ci, k, k2 = wq.shape
    n, h, wd, cin = x.shape
    if k != k2 or k not in KERNEL_SIZES or ci != cin or (xs is not None and xs.shape != (n,)) or \
            ks.shape != (co,) or (bias is not None and bias.shape != (co,)):
        raise ValueError(f"qconv_int8: bad shapes x={tuple(x.shape)} wq={tuple(wq.shape)} "
                         f"xs={None if xs is None else tuple(xs.shape)} ks={tuple(ks.shape)} "
                         f"bias={None if bias is None else tuple(bias.shape)}")
    if wq.dtype != torch.int8:
        raise ValueError(f"qconv_int8: needs an int8 weight, got {wq.dtype}")
    dev = x.device
    if wq.device != dev or ks.device != dev or (xs is not None and xs.device != dev) or (
            bias is not None and bias.device != dev):
        raise ValueError("qconv_int8: tensors must lie on the current CUDA device")
    tc = tensor_cores(ci, co)
    kc = k_chunk(x.dtype, ci, co, k)
    if packed is None:
        packed = pack_weights(wq, kc)
    if packed.shape != packed_shape(co, ci, k, kc) or packed.dtype != (torch.int8 if tc else torch.int32) or \
            not packed.is_contiguous():
        raise ValueError(f"qconv_int8: packed {tuple(packed.shape)} {packed.dtype} is not pack_weights(wq)")
    x = _rows(x)
    stream = _stream(dev)
    scratch = None
    if xs is None:
        xs_ptr, scratch = _scale_scratch(dev, stream, n)
    else:
        if xs.dtype != torch.float32 or not xs.is_contiguous():
            xs = xs.float().contiguous()
        xs_ptr = xs.data_ptr()
    if ks.dtype != torch.float32 or not ks.is_contiguous():
        ks = ks.float().contiguous()
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()):
        bias = bias.float().contiguous()
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=dev)
    _build.launch(
        _library(), "qconv_int8_launch",
        x.data_ptr(), packed.data_ptr(), xs_ptr, scratch, ks.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), n, h, wd, cin, co, k, x.stride(0), x.stride(1),
        n_tile(co) if tc else co_tile(co), int(tc), kc, int(x.dtype == torch.bfloat16), stream,
    )
    if scratch is not None:
        act_scale.launches += 1
    qconv_int8.launches += 1
    return y


act_scale.launches = 0
qconv_int8.launches = 0
