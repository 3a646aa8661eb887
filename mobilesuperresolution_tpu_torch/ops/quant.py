"""Dynamic-range int8 quantized convolution, the opt-in inference path
(counterpart of mobilesuperresolution_tpu/ops/quant.py).

The numerics class of the reference's int8 TFLite deployment:
per-output-channel symmetric int8 weights, per-sample dynamic symmetric int8
activations (the scale from the live activation's max, so a sample's numbers
do not depend on what it is batched with), int8 x int8 → int32 convolution
(kernel Q1 on the card, kernels/qconv_int8.py), then ``acc * (xs · ks)`` and
the float32 bias, cast to the input's dtype. Scales and rounding follow the
JAX package's: float32 whatever the input dtype, round half to even, clip
to [-127, 127], a scale floor of 1e-12.

The models quantize their constant weights once, in ``prepare()``
(``QConvWeight``): the same numbers as JAX's per-call quantization.
"""

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels.qconv_int8 import pack_weights, qconv_int8

_EPS = 1e-12


def quantize_symmetric(x, dims=None):
    """Symmetric int8 quantization, (q, scale) with x ≈ q · scale, in float32.
    dims=None: one scale for the tensor; else the scale reduced over ``dims``,
    kept as broadcastable dims."""
    xf = x.float()
    a = xf.abs()
    scale = (a.amax() if dims is None else a.amax(dim=dims, keepdim=True)) / 127.0
    scale = torch.clamp_min(scale, _EPS)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kernel(w):
    """Per-output-channel int8 weight: w OIHW float → (q int8 OIHW, scale
    (O,) float32)."""
    q, scale = quantize_symmetric(w, dims=(1, 2, 3))
    return q, scale.reshape(-1)


class QConvWeight:
    """One conv's weight quantized once: ``wq`` (O, I, k, k) int8, ``ks``
    (O,) float32, ``bias`` (O,) float32 or None (added in float32 inside the
    conv), and on the card ``packed`` for kernel Q1."""

    def __init__(self, weight, bias=None):
        with torch.no_grad():
            self.wq, self.ks = quantize_kernel(weight.detach())
            self.bias = None if bias is None else bias.detach().float().clone()
        self.packed = pack_weights(self.wq) if self.wq.is_cuda else None

    def __call__(self, x):
        """The quantized SAME conv of NHWC ``x``, in x.dtype."""
        xq, xs = quantize_symmetric(x, dims=(1, 2, 3))
        return qconv_int8(xq, self.wq, xs.reshape(-1), self.ks, self.bias, x.dtype, packed=self.packed)


def qconv2d(x, weight, bias=None, groups=1):
    """Dynamic-range int8 SAME conv of NHWC ``x`` with an OIHW odd-size
    ``weight`` (+ ``bias`` in float32), in x.dtype: x quantized per sample,
    the weight per output channel."""
    if groups != 1:
        raise ValueError(f"qconv2d: grouped convs are not quantized (groups={groups}, x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)})")
    return QConvWeight(weight, bias)(x)


def conv2d_maybe_quantized(x, weight, bias=None, quantized=False, groups=1):
    """SAME conv of NHWC ``x`` with an OIHW odd-size ``weight`` (+ bias):
    exact by default, int8 dynamic-range when ``quantized``."""
    if quantized:
        return qconv2d(x, weight, bias, groups)
    # ops.layers.conv2d_nhwc's call, inlined: ops.layers imports this module
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=weight.shape[-1] // 2, groups=groups)
    return y.permute(0, 2, 3, 1)
