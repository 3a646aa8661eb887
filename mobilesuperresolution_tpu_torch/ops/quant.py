"""Dynamic-range int8 quantized convolution, the opt-in inference path
(counterpart of mobilesuperresolution_tpu/ops/quant.py).

The numerics class of the reference's int8 TFLite deployment:
per-output-channel symmetric int8 weights, per-sample dynamic symmetric int8
activations (the scale from the live activation's max, so a sample's numbers
do not depend on what it is batched with), int8 x int8 → int32 convolution,
then ``acc * (xs · ks)`` and the float32 bias, cast to the input's dtype. On
the card a conv is two launches (kernels/qconv_int8.py): Q1s takes the
per-sample scale, Q1 quantizes the activation as it stages it and
convolves on the int8 tensor cores. Scales and rounding follow the
JAX package's: float32 whatever the input dtype, round half to even, clip
to [-127, 127], a scale floor of 1e-12.

The models quantize their constant weights once, in ``prepare()``
(``QConvWeight``): the same numbers as JAX's per-call quantization.
"""

import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu_torch.kernels.qconv_int8 import k_chunk, over_127, pack_weights, qconv_int8

_EPS = 1e-12


def quantize_symmetric(x, dims=None):
    """Symmetric int8 quantization, (q, scale) with x ≈ q · scale, in float32.
    dims=None: one scale for the tensor; else the scale reduced over ``dims``,
    kept as broadcastable dims."""
    xf = x.float()
    a = xf.abs()
    scale = over_127(a.amax() if dims is None else a.amax(dim=dims, keepdim=True))
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
    conv), and on the card ``packed`` for kernel Q1: its packing for each
    chunk width the input dtypes take (``k_chunk``)."""

    def __init__(self, weight, bias=None):
        with torch.no_grad():
            self.wq, self.ks = quantize_kernel(weight.detach())
            self.bias = None if bias is None else bias.detach().float().clone()
        co, ci, k, _ = self.wq.shape
        self.packed = None
        if self.wq.is_cuda:
            self.packed = {kc: pack_weights(self.wq, kc)
                           for kc in {k_chunk(dt, ci, co, k) for dt in (torch.float32, torch.bfloat16)}}

    def __call__(self, x):
        """The quantized SAME conv of NHWC ``x``, in x.dtype: x's per-sample
        scale, then the conv that quantizes x with it (on the card Q1s then
        Q1, from one call)."""
        packed = None
        if self.packed is not None:
            co, ci, k, _ = self.wq.shape
            packed = self.packed[k_chunk(x.dtype, ci, co, k)]
        return qconv_int8(x, None, self.wq, self.ks, self.bias, packed=packed)


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
