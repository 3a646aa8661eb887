"""Motion-vector VSR, the "basic_mv" type (counterpart of
mobilesuperresolution_tpu/models/mvvsr.py): BasicVSR whose flows come from
the codec's motion vectors instead of SpyNet.

The input is (B, T, H, W, 5): RGB, then the motion vector (dx, dy) of each
pixel, in pixels (not divided by 255). The forward flows are the vectors of
frames 1..T-1, time-major, and the backward flows their negation. There is
no SpyNet, so no ``spynet`` module or parameter, and ``flow_downscale`` does
not apply. Propagation is BasicVSR's; the reconstruction is mobile
BasicVSR's 2nf→3 one (fusion, then the sub-pixel transpose conv on kernel
B2, once per forward) with the bilinear base of the RGB channels.
``quantized`` runs the trunks' convs as int8 dynamic-range convs (kernel Q1
on the card), as BasicVSR's.
"""

import torch

from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR


class MotionVectorVSR(BasicVSR):
    """nf 20 and 8 blocks at the reference's size. Parameter names are
    BasicVSR's (``propagation/trunks/...``, ``fusion``, ``conv_last``),
    without ``spynet``."""

    has_spynet = False

    def __init__(self, num_feat=20, num_block=8, scale=4, compute_dtype=torch.float32, remat=False, quantized=False):
        super().__init__(num_feat, num_block, scale, compute_dtype, flow_downscale=1, remat=remat,
                         quantized=quantized)

    def forward(self, x_mv, height=1080, width=1920):
        """x_mv: (B, T, H, W, 5) → (B, T, height, width, 3) in x_mv.dtype."""
        in_dtype = x_mv.dtype
        x_mv = x_mv.to(self.compute_dtype)
        x = x_mv[..., :3]
        ff = x_mv[:, 1:, ..., 3:5].movedim(1, 0)  # (T-1, B, H, W, 2)
        return self._reconstruct(x, *self._propagate(x, ff, -ff), height, width).to(in_dtype)
