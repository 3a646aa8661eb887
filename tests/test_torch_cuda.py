"""The hand kernels on the card against their plain versions. Needs an
NVIDIA GPU and skips without one. This file imports no JAX, so on a machine
without it run it with the repository's conftest (which imports JAX) turned
off:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

from mobilesuperresolution_tpu_torch.kernels.conv5x5 import (
    conv5x5_same,
    conv5x5_same_plain,
    f32_plan,
    pack_weights,
    pack_weights_f32,
)
from mobilesuperresolution_tpu_torch.kernels.fused_convsep import FusedConvSepFn, fused_convsep, fused_convsep_plain
from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
    FusedConvPixelShuffleFn,
    FusedTailSkipFn,
    fused_conv_pixel_shuffle,
    fused_conv_pixel_shuffle_plain,
    fused_conv_pixel_shuffle_skip,
    fused_conv_pixel_shuffle_skip_plain,
)
from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import (
    FusedWdsrBlockFn,
    block_shape,
    fused_wdsr_block,
    fused_wdsr_block_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(want, dtype):
    # bf16: both sides round once to bf16 (2 ulps at the largest magnitude);
    # f32: full-f32 FMA on both sides, sums in another order
    top = float(want.float().abs().max())
    return 2.0 ** -6 * top if dtype == torch.bfloat16 else 1e-5 + 1e-4 * top


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 16, 40, 32, 128), (3, 4, 7, 64, 8), (1, 9, 33, 20, 24)])
def test_conv5x5_kernel_matches_plain(cuda, dtype, shape):
    n, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((n, h, w, cin), generator=g) * 2 - 1).to(cuda, dtype)
    wt = ((torch.rand((5, 5, cin, cout), generator=g) * 2 - 1) / (5 * cin ** 0.5)).to(cuda, dtype)
    b = (torch.rand(cout, generator=g) - 0.5).to(cuda)
    before = conv5x5_same.launches
    got = conv5x5_same(x, wt, b, relu=True)
    want = conv5x5_same_plain(x, wt, b, relu=True)
    torch.cuda.synchronize()
    assert conv5x5_same.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, h, w, cout)
    assert float((got.float() - want.float()).abs().max()) <= _tol(want, dtype)


B1_PATH_PAIRS = [(32, 128), (128, 256), (256, 128), (128, 64), (64, 8)]


@pytest.mark.parametrize(
    "shape",
    [(2, 12, 40, cin, cout) for cin, cout in B1_PATH_PAIRS]  # every main-path channel pair
    + [(1, 9, 33, 20, 8), (1, 9, 33, 24, 24), (2, 10, 18, 24, 8)]  # K tails (Cin 20, 24), N tails (Cout 8, 24)
    + [(1, 9, 33, 32, 24), (1, 9, 33, 32, 192)]  # N tails in a 32 tile and in a 128 tile copied in bulk
    + [(1, 9, 33, 40, 96), (1, 9, 33, 20, 64)]  # K and N tails in a 128 tile (cp.async); Cin 20 in a 64 tile
    + [(1, 19, 37, 128, 256), (1, 21, 35, 256, 128), (1, 19, 37, 64, 8)]  # H, W not multiples of the tile
    + [(18, 4, 7, cin, cout) for cin, cout in B1_PATH_PAIRS]  # the coarsest level: a map smaller than a tile
    + [(1, 64, 112, 128, 256), (1, 8, 14, 128, 256)],  # N = 1 at a large and a small map
    ids=lambda s: "x".join(map(str, s)),
)
def test_conv5x5_bf16_tile_edges(cuda, shape):
    """B1's bf16 wgmma kernel at the channel pairs of the main path, channel
    tails in K and N, ragged maps, maps smaller than one tile and N = 1,
    with random (non-symmetric) weights and biases, ReLU on and off, the
    packed weights made per call and passed in."""
    n, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(cin * 1000 + cout)
    x = (torch.rand((n, h, w, cin), generator=g) * 2 - 1).to(cuda, torch.bfloat16)
    wt = ((torch.rand((5, 5, cin, cout), generator=g) * 2 - 1) / (5 * cin ** 0.5)).to(cuda, torch.bfloat16)
    b = (torch.rand(cout, generator=g) - 0.5).to(cuda)
    packed = pack_weights(wt) if cin % 8 == 0 and cout % 64 == 0 else None
    for relu, wp in ((True, None), (False, packed)):
        before = conv5x5_same.launches
        got = conv5x5_same(x, wt, b, relu=relu, w_packed=wp)
        want = conv5x5_same_plain(x, wt, b, relu=relu)
        torch.cuda.synchronize()
        assert conv5x5_same.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == (n, h, w, cout)
        assert float((got.float() - want.float()).abs().max()) <= _tol(want, torch.bfloat16)


# B1 f32 (3xTF32): the VSR step's finest and coarse levels (36 samples),
# 128 samples at 1x1 (the folded tile past 36), a batch of 16 clips' 288
# samples at 8x8 and 4x4 (whole images folded into the wgmma route's tile),
# N = 1, ragged maps with K and N tails, a 4x7 level, 3x3 images (margins of
# 2 in a 7x7 halo) and maps of one row or two (taps skipped)
B1_F32_EDGES = [(36, 32, 32, 128, 256), (36, 4, 4, 256, 128), (36, 1, 1, 64, 8), (128, 1, 1, 128, 256),
                (288, 8, 8, 128, 256), (288, 4, 4, 256, 256), (1, 64, 112, 128, 256), (2, 37, 53, 20, 8),
                (1, 37, 53, 40, 96), (18, 4, 7, 32, 128), (2, 3, 3, 13, 5), (5, 1, 9, 8, 16), (3, 2, 5, 7, 3)]


@pytest.mark.parametrize("shape", [(36, 32, 32, 128), (36, 32, 32, 8), (36, 16, 16, 64), (36, 8, 8, 256),
                                   (36, 4, 4, 256), (36, 2, 2, 128), (36, 1, 1, 8), (128, 1, 1, 256),
                                   (288, 8, 8, 256), (288, 4, 4, 256), (1, 37, 53, 96), (18, 4, 7, 8),
                                   (2, 3, 3, 5), (5, 1, 9, 16), (3000, 8, 8, 64), (1, 1000, 3, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_conv5x5_f32_plan_tiles_the_map(cuda, shape, packed):
    """B1's f32 tile on an H100's 132 SMs: 4 warps (mma.sync) on 1-8 n8
    tiles, or, with packed weights only, 8 (wgmma) on 64 channels, 128
    where Cout is a multiple of 128; at most 32 positions a warp; whole
    images folded where a map holds at most half a tile, so no position of
    such a tile lies outside its image; every position of the map in
    exactly one tile."""
    n, h, w, cout = shape
    warps, nb, ti, tr, tc = f32_plan(n, h, w, cout, packed, sms=132)
    if warps == 8:
        assert packed and (nb == 8 or (nb == 16 and cout % 128 == 0))
    else:
        assert warps == 4 and 1 <= nb <= min(8, -(-cout // 8))
    assert ti * tr * tc <= 32 * warps and tr <= h and tc <= w
    if h * w <= 16 * warps:
        assert (tr, tc) == (h, w) and ti == 32 * warps // (h * w)
    else:
        assert ti == 1 and tc == min(w, 16)
    covered = np.zeros((n, h, w), np.int64)
    for i0 in range(0, n, ti):
        for y0 in range(0, h, tr):
            for x0 in range(0, w, tc):
                covered[i0:i0 + ti, y0:y0 + tr, x0:x0 + tc] += 1
    assert (covered == 1).all()


def test_conv5x5_f32_plan_fills_the_card_at_the_coarse_levels(cuda):
    """At the VSR step's coarse levels (36 samples, 8x8 to 1x1) the plan
    folds 2, 8, 32 and 128 images into a tile and narrows N until the grid
    fills the SMs; at 32x32 the wide convs take 8-warp 16x16 tiles of 128
    channels (64 for Cout 64); 288 samples at 8x8 and 4x4 take the 8-warp
    tiles with 4 and 16 images folded."""
    assert f32_plan(36, 32, 32, 256, True, sms=132) == (8, 16, 1, 16, 16)
    assert f32_plan(36, 32, 32, 64, True, sms=132) == (8, 8, 1, 16, 16)
    assert f32_plan(36, 32, 32, 256, False, sms=132)[0] == 4
    assert [f32_plan(36, h, h, 128, True, sms=132)[2] for h in (8, 4, 2, 1)] == [2, 8, 32, 128]
    assert f32_plan(36, 4, 4, 256, True, sms=132)[1] < 8 and f32_plan(36, 1, 1, 256, True, sms=132)[1] < 8
    assert f32_plan(288, 8, 8, 256, True, sms=132) == (8, 16, 4, 8, 8)
    assert f32_plan(288, 4, 4, 256, True, sms=132) == (8, 8, 16, 4, 4)


@pytest.mark.parametrize("shape", B1_F32_EDGES, ids=lambda s: "x".join(map(str, s)))
def test_conv5x5_f32_tile_edges_and_determinism(cuda, shape):
    """B1's 3xTF32 kernel against its plain version at f32's tolerance, one
    launch a call, two calls bit-equal, and the rows of a window of the map
    at least 2 rows from its cut bit-equal to the whole map's (the K order
    does not follow the tile or the map)."""
    n, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(cin * 1000 + cout)
    x = (torch.rand((n, h, w, cin), generator=g) * 2 - 1).to(cuda)
    wt = ((torch.rand((5, 5, cin, cout), generator=g) * 2 - 1) / (5 * cin ** 0.5)).to(cuda)
    b = (torch.rand(cout, generator=g) - 0.5).to(cuda)
    before = conv5x5_same.launches
    got = conv5x5_same(x, wt, b, relu=True)
    again = conv5x5_same(x, wt, b, relu=True)
    want = conv5x5_same_plain(x, wt, b, relu=True)
    torch.cuda.synchronize()
    assert conv5x5_same.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (n, h, w, cout)
    assert float((got - want).abs().max()) <= _tol(want, torch.float32)
    assert torch.equal(got, again)
    assert torch.equal(conv5x5_same(x, wt, b, relu=True, w_packed=pack_weights_f32(wt)), got)
    if h >= 12:
        cut = h // 2 + 2
        part = conv5x5_same(x[:, :cut].contiguous(), wt, b, relu=True)
        assert torch.equal(part[:, : h // 2], got[:, : h // 2])


@pytest.mark.parametrize("shape", [(36, 32, 32, 128, 256), (36, 16, 16, 256, 128), (288, 8, 8, 128, 256),
                                   (288, 4, 4, 256, 256), (4, 24, 40, 20, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv5x5_f32_routes_give_the_same_bits(cuda, shape):
    """B1's two f32 routes, wgmma on 8-warp tiles (taken with packed
    weights: 16x16, or 4 and 16 whole images at 288 samples of 8x8 and 4x4)
    and mma.sync on 4-warp tiles of 8 to 64 channels (without), sum each
    output in one order with the same tf32 products: both routes, and the
    plans of slices of the batch, give the same bits."""
    n, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(cout)
    x = (torch.rand((n, h, w, cin), generator=g) * 2 - 1).to(cuda)
    wt = ((torch.rand((5, 5, cin, cout), generator=g) * 2 - 1) / (5 * cin ** 0.5)).to(cuda)
    b = (torch.rand(cout, generator=g) - 0.5).to(cuda)
    wp = pack_weights_f32(wt)
    got = conv5x5_same(x, wt, b, w_packed=wp)
    want = conv5x5_same_plain(x, wt, b)
    assert float((got - want).abs().max()) <= _tol(want, torch.float32)
    plans = set()
    for k in (n, n // 2 + 1, 1):
        for packed in (wp, None):
            assert torch.equal(conv5x5_same(x[:k], wt, b, w_packed=packed), got[:k]), (k, packed is None)
            plans.add(f32_plan(k, h, w, cout, packed is not None))
    assert len(plans) >= 2
    if n == 288:
        assert any(p[0] == 8 and p[2] > 1 for p in plans), plans


# B2 f32 (3xTF32): the main-path form with odd crops, Cin 16 and 40, the 3x3
# form at s 3 (27 conv channels), basic_origin's upconv (groups of 32), a
# 7x7 kernel staged in pieces and s 8 (groups of 64)
B2_F32_EDGES = {
    "crop": (2, 13, 21, 48, 2, 4, 48, ((1, 2), (1, 2)), (51, 83), False),
    "cin16": (2, 11, 19, 16, 2, 4, 48, ((1, 2), (1, 2)), (45, 77), False),
    "cin40": (1, 11, 19, 40, 2, 4, 48, ((1, 2), (1, 2)), (43, 75), False),
    "3x3s3": (2, 11, 19, 16, 3, 3, 27, ((1, 1), (1, 1)), None, False),
    "upconv": (2, 13, 21, 64, 3, 2, 256, ((1, 1), (1, 1)), None, True),
    "7x7": (1, 10, 19, 64, 7, 2, 64, ((3, 3), (3, 3)), None, False),
    "s8": (2, 9, 11, 8, 3, 8, 128, ((1, 1), (1, 1)), None, True),
}


@pytest.mark.parametrize("case", list(B2_F32_EDGES))
def test_fused_tail_f32_tile_edges_and_determinism(cuda, case):
    """B2's 3xTF32 kernel against its plain version at f32's tolerance, one
    launch a call, and two calls bit-equal."""
    n, h, w, cin, k, s, cc, pad, crop, lrelu = B2_F32_EDGES[case]
    g = torch.Generator().manual_seed(cin * 100 + cc)
    x = (torch.rand((n, h, w, cin), generator=g) * 2 - 1).to(cuda)
    kern = ((torch.rand((k, k, cin, cc), generator=g) * 2 - 1) / (k * cin ** 0.5)).to(cuda)
    b = (torch.rand(cc, generator=g) - 0.5).to(cuda)
    before = fused_conv_pixel_shuffle.launches
    got = fused_conv_pixel_shuffle(x, kern, b, s, pad, crop, lrelu)
    again = fused_conv_pixel_shuffle(x, kern, b, s, pad, crop, lrelu)
    want = fused_conv_pixel_shuffle_plain(x, kern, b, s, pad, crop, lrelu)
    torch.cuda.synchronize()
    assert fused_conv_pixel_shuffle.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= _tol(want, torch.float32)
    assert torch.equal(got, again)


@pytest.mark.parametrize(
    "n,h,w,cin,k,s,cc,pad,crop",
    [
        (2, 13, 21, 48, 2, 4, 48, ((1, 2), (1, 2)), (4 * 13 + 1, 4 * 21 + 1)),  # main-path form, ragged, odd crop
        (1, 17, 30, 48, 2, 4, 48, ((1, 2), (1, 2)), (61, 107)),  # a crop inside the last tile
        (2, 11, 19, 16, 2, 4, 48, ((1, 2), (1, 2)), (45, 77)),  # Cin 16
        (1, 11, 19, 40, 2, 4, 48, ((1, 2), (1, 2)), (45, 77)),  # Cin 40 (a K tail)
        (2, 11, 19, 24, 2, 2, 12, ((1, 2), (1, 2)), None),  # Cc 12 (an N tail)
        (2, 11, 19, 16, 3, 2, 12, ((1, 1), (1, 1)), None),  # the Pallas kernel's 3x3/pad-1 form at s 2
        (1, 10, 19, 64, 7, 2, 64, ((3, 3), (3, 3)), None),  # weights too large to stage at once
    ],
    ids=["main", "crop", "cin16", "cin40", "cc12", "3x3s2", "7x7"],
)
def test_fused_tail_bf16_tile_edges(cuda, n, h, w, cin, k, s, cc, pad, crop):
    """B2's bf16 tensor-core kernel: the main-path form with ragged H, W and
    odd crops, channel tails in K and N, the 3x3/pad-1 form at s 2, and a
    geometry staged in pieces."""
    g = torch.Generator().manual_seed(cin * 100 + cc)
    x = (torch.rand((n, h, w, cin), generator=g) * 2 - 1).to(cuda, torch.bfloat16)
    kern = ((torch.rand((k, k, cin, cc), generator=g) * 2 - 1) / (k * cin ** 0.5)).to(cuda, torch.bfloat16)
    b = (torch.rand(cc, generator=g) - 0.5).to(cuda, torch.bfloat16)
    before = fused_conv_pixel_shuffle.launches
    got = fused_conv_pixel_shuffle(x, kern, b, s, pad, crop)
    want = fused_conv_pixel_shuffle_plain(x, kern, b, s, pad, crop)
    torch.cuda.synchronize()
    assert fused_conv_pixel_shuffle.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= _tol(want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "k,s,pad,crop", [(2, 4, ((1, 2), (1, 2)), (4 * 11 + 1, 4 * 19 + 1)), (3, 2, ((1, 1), (1, 1)), None)]
)
def test_fused_tail_kernel_matches_plain(cuda, dtype, k, s, pad, crop):
    g = torch.Generator().manual_seed(0)
    cin, cc = 16, 3 * s * s
    x = (torch.rand((2, 11, 19, cin), generator=g) * 2 - 1).to(cuda, dtype)
    kern = ((torch.rand((k, k, cin, cc), generator=g) * 2 - 1) / k).to(cuda, dtype)
    b = (torch.rand(cc, generator=g) - 0.5).to(cuda, dtype)
    before = fused_conv_pixel_shuffle.launches
    got = fused_conv_pixel_shuffle(x, kern, b, s, pad, crop)
    want = fused_conv_pixel_shuffle_plain(x, kern, b, s, pad, crop)
    torch.cuda.synchronize()
    assert fused_conv_pixel_shuffle.launches == before + 1
    assert got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= _tol(want, dtype)


# B2 past 64 conv channels (groups of 64 over the grid): BasicVSROrigin's
# upconvs (3x3, s 2, 64 -> 256 and a 128-channel form) on ragged maps, and
# a width whose last group is short (260 = 4 x 64 + 4)
WIDE_TAILS = {"cc128": (2, 13, 21, 64, 128), "cc256": (2, 13, 21, 64, 256), "cc260": (1, 9, 10, 20, 260)}


@pytest.mark.parametrize("lrelu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(WIDE_TAILS))
def test_fused_tail_wide_channels_match_plain(cuda, case, dtype, lrelu):
    """B2 at 128, 256 and 260 conv channels, 3x3 SAME, s 2, with and without
    the fused leaky ReLU, against the plain version: one launch."""
    n, h, w, cin, cc = WIDE_TAILS[case]
    g = torch.Generator().manual_seed(cc)
    x = (torch.rand((n, h, w, cin), generator=g) * 2 - 1).to(cuda, dtype)
    kern = ((torch.rand((3, 3, cin, cc), generator=g) * 2 - 1) / (3 * cin ** 0.5)).to(cuda, dtype)
    b = (torch.rand(cc, generator=g) - 0.5).to(cuda, dtype)
    pad = ((1, 1), (1, 1))
    before = fused_conv_pixel_shuffle.launches
    got = fused_conv_pixel_shuffle(x, kern, b, 2, pad, None, lrelu)
    want = fused_conv_pixel_shuffle_plain(x, kern, b, 2, pad, None, lrelu)
    torch.cuda.synchronize()
    assert fused_conv_pixel_shuffle.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape == (n, 2 * h, 2 * w, cc // 4)
    assert float((got.float() - want.float()).abs().max()) <= _tol(want, dtype)
    assert (float(got.min()) < 0) == (float(want.min()) < 0)


def _rand(g, shape, scale, dev, dtype=torch.float32):
    return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 37, 53), (1, 5, 3)], ids=["tiles", "ragged", "tiny"])
@pytest.mark.parametrize("c", [24, 16, 32, 13, 64])
def test_fused_wdsr_block_kernel_matches_plain(cuda, dtype, shape, c):
    """Whole tiles, ragged tiles (H, W not multiples of 14) and a map smaller
    than the halo, at WDSR-B's block for 24 units (the main path) and at 16
    (E 96, M 13), 32 (E 192, M 26), 13 (odd: pixels staged without cp.async)
    and 64 units (weights read from global memory in f32): h2 must be zero
    outside the image on every border. Per-call packing and weights packed
    once give the same result."""
    from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import block_shape, pack_weights

    n, h, w = shape
    _, e, m, _ = block_shape(c)
    g = torch.Generator().manual_seed(c)
    x = _rand(g, (n, h, w, c), 1.0, cuda, dtype)
    w1, b1 = _rand(g, (c, e), c ** -0.5, cuda), _rand(g, (e,), 0.2, cuda)
    w2, b2 = _rand(g, (e, m), e ** -0.5, cuda), _rand(g, (m,), 0.2, cuda)
    w3, b3 = _rand(g, (3, 3, m, c), (9 * m) ** -0.5, cuda), _rand(g, (c,), 0.2, cuda)
    if dtype == torch.bfloat16:
        w1, b1, w2, b2, w3, b3 = (t.to(dtype).float() for t in (w1, b1, w2, b2, w3, b3))
    before = fused_wdsr_block.launches
    got = fused_wdsr_block(x, w1, b1, w2, b2, w3, b3)
    again = fused_wdsr_block(x, w1, b1, w2, b2, w3, b3, packed=pack_weights(w1, b1, w2, b2, w3, b3, dtype))
    want = fused_wdsr_block_plain(x, w1, b1, w2, b2, w3, b3)
    torch.cuda.synchronize()
    assert fused_wdsr_block.launches == before + 2
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - want.float()).abs().max()) <= _tol(want, dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("cin", [8, 13, 18, 21, 24, 32, 64])
def test_fused_tail_skip_kernel_matches_plain(cuda, dtype, scale, cin):
    """B4 on the tensor cores: tail 3x3 (8..64 body channels: WDSR-B's
    units, ResultNet's 18, the searched 21 and 32; 13 and 21 staged without
    16-byte copies) + skip 5x5 from 3 channels, s 2, 3, 4 (12, 27, 48 conv
    channels: 27 pads N and masks), batch 2 on ragged maps: 21x35, whose
    output rows are written row by row, and 21x40, whose rows are a whole
    number of 16-byte chunks and go out as TMA boxes. A repeated call is
    bit-equal, and weights packed once give the per-call result."""
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import pack_weights as pack_b4

    cc = 3 * scale * scale
    g = torch.Generator().manual_seed(cin * 10 + scale)
    kern = _rand(g, (3, 3, cin, cc), (9 * cin) ** -0.5, cuda)
    ks = _rand(g, (5, 5, 3, cc), 75 ** -0.5, cuda)
    b = _rand(g, (cc,), 0.5, cuda)
    for h, w in ((21, 35), (21, 40)):
        x = _rand(g, (2, h, w, cin), 1.0, cuda, dtype)
        xs = _rand(g, (2, h, w, 3), 0.5, cuda, dtype)
        before = (fused_conv_pixel_shuffle.launches, fused_conv_pixel_shuffle_skip.launches)
        got = fused_conv_pixel_shuffle_skip(x, kern, b, scale, xs, ks)
        again = fused_conv_pixel_shuffle_skip(x, kern, b, scale, xs, ks)
        packed = fused_conv_pixel_shuffle_skip(x, kern, b, scale, xs, ks, packed=pack_b4(kern, ks, b, dtype))
        want = fused_conv_pixel_shuffle_skip_plain(x, kern, b, scale, xs, ks)
        torch.cuda.synchronize()
        assert (fused_conv_pixel_shuffle.launches, fused_conv_pixel_shuffle_skip.launches) == (before[0],
                                                                                                before[1] + 3)
        assert got.dtype == dtype and got.shape == (2, h * scale, w * scale, 3)
        assert float((got.float() - want.float()).abs().max()) <= _tol(want, dtype), (h, w)
        assert torch.equal(got, again) and torch.equal(got, packed)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize(
    "shape",
    [(2, 48, 48, 32, 32), (1, 37, 53, 32, 32), (3, 5, 3, 8, 8), (2, 20, 40, 16, 16), (1, 37, 53, 48, 48),
     (1, 21, 35, 24, 40), (1, 13, 19, 13, 11), (1, 19, 45, 64, 64)],
    ids=["search", "ragged", "tiny", "c16", "c48", "c24to40", "odd", "c64"],
)
def test_fused_convsep_kernel_matches_plain(cuda, dtype, k, shape):
    """B5 at the search's patch size (whole 8x32 tiles), on a ragged map and
    on a map smaller than the halo, at 32, 8, 16, 48 and 64 channels (f32 at
    32 and 64 stages 16-byte swizzled chunks, the others channel pairs), with
    C != C_out, and at odd C and C_out (pixels staged without cp.async);
    its autograd Function launches once forward and none backward."""
    n, h, w, c, co = shape
    g = torch.Generator().manual_seed(k)
    x = _rand(g, (n, h, w, c), 1.0, cuda, dtype)
    wd, bd = _rand(g, (k, k, c), 1.0 / k, cuda), _rand(g, (c,), 0.2, cuda)
    wp, bp = _rand(g, (c, co), c ** -0.5, cuda), _rand(g, (co,), 0.2, cuda)
    if dtype == torch.bfloat16:
        wd, bd, wp, bp = (t.to(dtype).float() for t in (wd, bd, wp, bp))
    before = fused_convsep.launches
    got = fused_convsep(x, wd, bd, wp, bp)
    want = fused_convsep_plain(x, wd, bd, wp, bp)
    torch.cuda.synchronize()
    assert fused_convsep.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, h, w, co)
    assert float((got.float() - want.float()).abs().max()) <= _tol(want, dtype)
    xg = x.float().requires_grad_()
    FusedConvSepFn.apply(xg, wd, bd, wp, bp).square().sum().backward()
    assert fused_convsep.launches == before + 2 and torch.isfinite(xg.grad).all()


@pytest.mark.parametrize("units", [16, 32])
def test_basic_model_runs_b3_at_other_widths(cuda, units):
    """WDSR-B at 16 and 32 residual units runs every block through B3 on the
    card and agrees with the same model on the CPU."""
    from mobilesuperresolution_tpu_torch.models import BasicModel
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    x = torch.rand((1, 23, 31, 3), generator=torch.Generator().manual_seed(units))
    outs = []
    for dev in ("cpu", cuda):
        m = BasicModel(num_blocks=2, num_residual_units=units, scale=2).to(dev)
        load_params_npz(m, random_jax_params(m, seed=units))
        before = fused_wdsr_block.launches
        with torch.inference_mode():
            outs.append(m(x.to(dev)).cpu())
        assert fused_wdsr_block.launches - before == (2 if dev == cuda else 0)
    assert float((outs[1] - outs[0]).abs().max()) <= 1e-4


def test_supernet_runs_b5_at_16_units(cuda):
    """The NAS supernet at 16 units launches B5 three times per block on the
    card and agrees with the same model on the CPU."""
    from mobilesuperresolution_tpu_torch.models import NASModel
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    x = torch.rand((2, 20, 24, 3), generator=torch.Generator().manual_seed(16))
    outs = []
    for dev in ("cpu", cuda):
        m = NASModel(num_blocks=2, num_residual_units=16, scale=2).to(dev)
        load_params_npz(m, random_jax_params(m, seed=16))
        before = fused_convsep.launches
        with torch.no_grad():
            outs.append(m(x.to(dev))[0].cpu())
        assert fused_convsep.launches - before == (6 if dev == cuda else 0)
    assert float((outs[1] - outs[0]).abs().max()) <= 1e-4


def test_kernels_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        conv5x5_same(x, torch.zeros(5, 5, 4, 4, device=cuda, dtype=torch.float16), torch.zeros(4, device=cuda))
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        conv5x5_same(x[:, :, ::2], torch.zeros(5, 5, 4, 4, device=cuda), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):  # 78 conv channels: not a multiple of s² = 4
        fused_conv_pixel_shuffle(x, torch.zeros(3, 3, 4, 78, device=cuda), torch.zeros(78, device=cuda), 2)
    with pytest.raises(ValueError):  # s² = 81 > 64: a channel group would not hold one output channel
        fused_conv_pixel_shuffle(x, torch.zeros(3, 3, 4, 81, device=cuda), torch.zeros(81, device=cuda), 9)
    z = torch.zeros
    with pytest.raises(ValueError, match="not a WDSR-B block"):  # C > 64
        fused_wdsr_block(z(1, 8, 8, 72, device=cuda), z(72, 432, device=cuda), z(432, device=cuda),
                         z(432, 60, device=cuda), z(60, device=cuda), z(3, 3, 60, 72, device=cuda), z(72, device=cuda))
    with pytest.raises(ValueError, match="not a WDSR-B block"):  # M != int(0.84 C)
        fused_wdsr_block(z(1, 8, 8, 16, device=cuda), z(16, 96, device=cuda), z(96, device=cuda),
                         z(96, 14, device=cuda), z(14, device=cuda), z(3, 3, 14, 16, device=cuda), z(16, device=cuda))
    with pytest.raises(ValueError, match="not a WDSR-B block"):  # k = 5
        fused_wdsr_block(z(1, 8, 8, 16, device=cuda), z(16, 96, device=cuda), z(96, device=cuda),
                         z(96, 13, device=cuda), z(13, device=cuda), z(5, 5, 13, 16, device=cuda), z(16, device=cuda))
    with pytest.raises(ValueError, match="not taken"):  # C > 64
        fused_convsep(z(1, 8, 8, 72, device=cuda), z(3, 3, 72, device=cuda), z(72, device=cuda),
                      z(72, 72, device=cuda), z(72, device=cuda))
    with pytest.raises(ValueError, match="not taken"):  # k = 9
        fused_convsep(z(1, 8, 8, 8, device=cuda), z(9, 9, 8, device=cuda), z(8, device=cuda),
                      z(8, 8, device=cuda), z(8, device=cuda))
    with pytest.raises(ValueError):
        fused_conv_pixel_shuffle_skip(x, torch.zeros(3, 3, 4, 12, device=cuda), torch.zeros(12, device=cuda), 2,
                                      torch.zeros(1, 8, 9, 3, device=cuda), torch.zeros(5, 5, 3, 12, device=cuda))


def test_fused_tail_skip_raises_past_its_widths(cuda):
    """B4 raises, naming the shapes, on a body past 64 channels, more than 64
    conv channels, a skip past 3 channels and kernels other than 3x3 + 5x5;
    it never runs its plain version on the card."""
    z = torch.zeros
    before = fused_conv_pixel_shuffle_skip.launches
    for cin, cc, c2, k, k2, s in ((72, 12, 3, 3, 5, 2), (24, 75, 3, 3, 5, 5), (24, 12, 4, 3, 5, 2),
                                  (24, 12, 3, 5, 5, 2), (24, 12, 3, 3, 3, 2)):
        with pytest.raises(ValueError, match="not taken"):
            fused_conv_pixel_shuffle_skip(z(1, 8, 8, cin, device=cuda), z(k, k, cin, cc, device=cuda),
                                          z(cc, device=cuda), s, z(1, 8, 8, c2, device=cuda),
                                          z(k2, k2, c2, cc, device=cuda))
    assert fused_conv_pixel_shuffle_skip.launches == before


def _fn_against_plain(fn, plain, inputs, dtype):
    """Forward of an autograd Function (a kernel launch) and its gradients
    against autograd through the plain version on the same card tensors:
    forward within the kernel tolerance; every gradient (the backward
    recomputes the plain version, whose cuDNN sums are not bit-reproducible)
    within 1e-4 of the largest in float32, and, where it is bf16 (the
    gradient of a bf16 input), within the bf16 tolerance."""
    outs = []
    cot = None
    for f in (fn, plain):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        y = f(*leaves)
        if cot is None:  # one cotangent for both: the gradients then differ only by summation order
            g = torch.Generator().manual_seed(1)
            cot = (torch.rand(tuple(y.shape), generator=g) * 2 - 1).to(y.device, y.dtype)
        y.backward(cot)
        outs.append((y.detach(), [t.grad for t in leaves]))
    (y, grads), (y_want, grads_want) = outs
    torch.cuda.synchronize()
    assert float((y.float() - y_want.float()).abs().max()) <= _tol(y_want, dtype)
    for i, (g, gw) in enumerate(zip(grads, grads_want)):
        tol = _tol(gw, gw.dtype) if gw.dtype == torch.bfloat16 else 1e-4 * float(gw.abs().max()) + 1e-6
        assert float((g.float() - gw.float()).abs().max()) <= tol, i


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [8, 16, 24, 32, 64])
def test_wdsr_block_fn_gradients_on_card(cuda, dtype, c):
    """FusedWdsrBlockFn (B3 forward with per-call packed weights) on the card:
    one launch per forward, forward and gradients against the plain version,
    at the residual-unit widths the SISR models train at."""
    _, e, m, k = block_shape(c)
    g = torch.Generator().manual_seed(c)

    def r(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(cuda)

    x = r(2, 21, 19, c).to(dtype)
    ws = [r(c, e, scale=c ** -0.5), r(e, scale=0.2), r(e, m, scale=e ** -0.5), r(m, scale=0.2),
          r(k, k, m, c, scale=(9 * m) ** -0.5), r(c, scale=0.2)]
    ws = [w.to(dtype).float() for w in ws]  # as a model in dtype rounds them
    before = fused_wdsr_block.launches
    _fn_against_plain(FusedWdsrBlockFn.apply, fused_wdsr_block_plain, [x, *ws], dtype)
    assert fused_wdsr_block.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("cin", [18, 24, 32])
def test_tail_skip_fn_gradients_on_card(cuda, dtype, scale, cin):
    """FusedTailSkipFn (B4 forward with per-call packed weights) on the card:
    one launch per forward, forward and gradients against the plain version,
    at every scale and at the WDSR-B and searched nets' body widths."""
    cc = 3 * scale * scale
    g = torch.Generator().manual_seed(cin * scale)

    def r(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(cuda)

    inputs = [r(2, 13, 17, cin).to(dtype), r(3, 3, cin, cc, scale=(9 * cin) ** -0.5).to(dtype), r(cc, scale=0.5),
              r(2, 13, 17, 3, scale=0.5).to(dtype), r(5, 5, 3, cc, scale=75 ** -0.5).to(dtype)]
    before = fused_conv_pixel_shuffle_skip.launches
    _fn_against_plain(lambda *a: FusedTailSkipFn.apply(*a, scale),
                      lambda x, kb, b, xs, ks: fused_conv_pixel_shuffle_skip_plain(x, kb, b, scale, xs, ks),
                      inputs, dtype)
    assert fused_conv_pixel_shuffle_skip.launches == before + 1


@pytest.mark.parametrize("kind", ["basic", "result_net"])
def test_tiny_training_steps_match_cpu(cuda, kind):
    """Three SISR training steps of a tiny float32 model on the card (B3 and
    B4 through their Functions) against the same steps on the CPU: per-step
    losses within 1e-4, and every parameter's gradient of the first step (the
    same weights on both sides; Adam then amplifies summation-order noise in
    the weights whose gradients are near zero) within 1e-4 of its largest."""
    from mobilesuperresolution_tpu_torch.models import BasicModel, ResultNet
    from mobilesuperresolution_tpu_torch.train.checkpoint import (
        jax_named_parameters,
        load_params_npz,
        random_jax_params,
    )
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

    g = torch.Generator().manual_seed(9)
    batches = [(torch.rand((2, 12, 14, 3), generator=g), torch.rand((2, 24, 28, 3), generator=g)) for _ in range(3)]
    runs = []
    for dev in ("cpu", cuda):
        m = BasicModel(2, 24, 2) if kind == "basic" else ResultNet(2, ((18, 14, 7), (18, 18, 3)))
        m.to(dev)
        load_params_npz(m, random_jax_params(m, seed=5))
        m.train()
        named = jax_named_parameters(m)
        step = make_sisr_step(m, multistep_adam(named, 1e-3, 3, 1))
        losses = []
        for i, (lr, hr) in enumerate(batches):
            losses.append(float(step((lr.to(dev), hr.to(dev)))["loss"]))
            if i == 0:
                grads = {k: p.grad.cpu() for k, p in named.items()}
        runs.append((losses, grads))
    (l0, g0), (l1, g1) = runs
    for i in range(3):
        assert abs(l1[i] - l0[i]) <= 1e-4 * max(1.0, abs(l0[i])), (i, l1[i], l0[i])
    for k in g0:
        top = float(g0[k].abs().max())
        assert float((g1[k] - g0[k]).abs().max()) <= 1e-4 * max(top, 1e-3), k


# B2 at the VSR zoo's shapes: 'single''s sub-pixel tail (the 5x5 stride-4
# transpose as a 2x2 conv over 32 channels to 48, cropped) and 'multi''s
# decode (3x3 SAME, 18 channels to 48: an 18-channel bf16 pixel is 36 bytes,
# not a whole number of 16-byte chunks), on ragged maps
ZOO_TAILS = {
    "single_tail": (3, 13, 21, 32, 2, 4, ((1, 2), (1, 2)), (4 * 13 + 1, 4 * 21 + 1)),
    "multi_decode": (3, 13, 21, 18, 3, 4, ((1, 1), (1, 1)), None),
}
# BasicVSROrigin's upconvs: 3x3 SAME, s 2, 64 -> 128 and 256 conv channels,
# the leaky ReLU fused
UPCONVS = {"upconv_cc128": 128, "upconv_cc256": 256}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["vsr_train_tail", "ragged", "single_tail", "multi_decode", *UPCONVS])
def test_conv_pixel_shuffle_fn_gradients_on_card(cuda, dtype, case):
    """FusedConvPixelShuffleFn (B2 forward) on the card: one launch per
    forward, forward and gradients against autograd through the plain
    version, at the VSR training step's tail (2 clips x 10 frames of 64x64,
    2x2 over 48 channels, s 4, cropped to 257x257), a ragged 3x3 s2 map, the
    'single' and 'multi' tails (``ZOO_TAILS``) and BasicVSROrigin's upconvs
    with the fused leaky ReLU (``UPCONVS``, ragged 3 x 13x21 maps)."""
    lrelu = case in UPCONVS
    if case == "vsr_train_tail":
        n, h, w, cin, k, s, pad, crop = 20, 64, 64, 48, 2, 4, ((1, 2), (1, 2)), (257, 257)
    elif case == "ragged":
        n, h, w, cin, k, s, pad, crop = 3, 37, 53, 16, 3, 2, ((1, 1), (1, 1)), (73, 105)
    elif lrelu:
        n, h, w, cin, k, s, pad, crop = 3, 13, 21, 64, 3, 2, ((1, 1), (1, 1)), None
    else:
        n, h, w, cin, k, s, pad, crop = ZOO_TAILS[case]
    cc = UPCONVS[case] if lrelu else 3 * s * s
    g = torch.Generator().manual_seed(n)
    inputs = [((torch.rand((n, h, w, cin), generator=g) * 2 - 1)).to(cuda, dtype),
              ((torch.rand((k, k, cin, cc), generator=g) * 2 - 1) / (k * cin ** 0.5)).to(cuda),
              (torch.rand(cc, generator=g) * 0.2 - 0.1).to(cuda)]
    before = fused_conv_pixel_shuffle.launches
    _fn_against_plain(lambda *a: FusedConvPixelShuffleFn.apply(*a, s, pad, crop, lrelu),
                      lambda *a: fused_conv_pixel_shuffle_plain(*a, s, pad, crop, lrelu), inputs, dtype)
    assert fused_conv_pixel_shuffle.launches == before + 1


def test_tiny_vsr_training_steps_match_cpu(cuda):
    """Three VSR training steps of a tiny float32 BasicVSR (nf 8, 1 block,
    x4; B1 and B2 on the card) against the CPU: per-step losses within 1e-4,
    the first step's gradients within 1e-4 of each one's largest, no
    gradient for the frozen SpyNet, one B2 launch per step."""
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
    from mobilesuperresolution_tpu_torch.train.checkpoint import (
        jax_named_parameters,
        load_params_npz,
        random_jax_params,
    )
    from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

    g = torch.Generator().manual_seed(11)
    batches = [(torch.rand((1, 3, 32, 32, 3), generator=g), torch.rand((1, 3, 128, 128, 3), generator=g))
               for _ in range(3)]
    runs = []
    for dev in ("cpu", cuda):
        m = BasicVSR(num_feat=8, num_block=1, scale=4).to(dev)
        load_params_npz(m, random_jax_params(m, seed=6))
        m.train()
        named = jax_named_parameters(m)
        step = make_vsr_step(m, vsr_multistep_adam(named, 1e-3, 3, 1, spynet_frozen_mask(named)), (128, 128))
        before = fused_conv_pixel_shuffle.launches
        losses = []
        for i, (lr, hr) in enumerate(batches):
            losses.append(float(step((lr.to(dev), hr.to(dev)))["loss"]))
            if i == 0:
                grads = {k: p.grad.cpu() for k, p in named.items() if p.grad is not None}
        if dev != "cpu":
            assert fused_conv_pixel_shuffle.launches == before + 3
        runs.append((losses, grads))
    (l0, g0), (l1, g1) = runs
    assert set(g0) == set(g1) and not any(k.startswith("spynet/") for k in g0)
    for i in range(3):
        assert abs(l1[i] - l0[i]) <= 1e-4 * max(1.0, abs(l0[i])), (i, l1[i], l0[i])
    for k in g0:
        assert float((g1[k] - g0[k]).abs().max()) <= 1e-4 * max(float(g0[k].abs().max()), 1e-3), k


def test_pretrain_resume_on_card(cuda, tmp_path):
    """cli.pretrain on the card (2 blocks, 8 units; B3 and B4 through their
    Functions) stopped by --max_steps_per_run mid-epoch and resumed with
    --resume ends on the uninterrupted run's weights: bit-equal with cuDNN
    deterministic (the kernels are)."""
    import numpy as np

    from mobilesuperresolution_tpu_torch.cli import pretrain

    def run(job, *extra):
        return pretrain.main(["--job_dir", str(job), "--dataset", "synthetic_isr", "--eval_datasets",
                              "--num_blocks", "2", "--num_residual_units", "8", "--epochs", "2",
                              "--train_batch_size", "8", "--lr_patch_size", "16", "--num_patches", "2", *extra])

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        run(tmp_path / "ref")
        assert run(tmp_path / "job", "--max_steps_per_run", "3")["preempted"] == {"epoch": 2, "batch": 1}
        assert run(tmp_path / "job", "--resume")["resumed"] == {"epoch": 2, "batch": 1}
    finally:
        torch.backends.cudnn.deterministic = saved
    za, zb = (np.load(str(tmp_path / d / "weights" / "models.npz")) for d in ("ref", "job"))
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


# kernel launches per forward of each tiny zoo model: (B1, B2, B4)
ZOO_LAUNCHES = {"single": (0, 1, 0), "multi": (30, 1, 0), "basic_mv": (0, 1, 0), "multi_v1": (30, 0, 1),
                "basic_origin": (30, 2, 0)}


@pytest.mark.parametrize("kind", list(ZOO_LAUNCHES))
def test_tiny_zoo_models_match_cpu(cuda, kind):
    """A tiny float32 'single' (8 channels, 2 blocks), 'multi' and 'multi_v1'
    (the artifact [[8, 8, 3], [8, 6, 5]]), 'basic_mv' and 'basic_origin' (nf
    8, 1 block; basic_origin's upconv2 at 256 conv channels), x4 on 3 frames
    of 64x64 (basic_mv with motion vectors of a few pixels), on the card
    against the CPU: the eval forward within 1e-4 of the largest output,
    with B1, B2 and B4 launched per forward as ``ZOO_LAUNCHES`` says (B1 30
    times: SpyNet's six even levels); then three training steps with
    per-step losses within 1e-4, the first step's gradients within 1e-4 of
    each one's largest and no gradient for the frozen flow network."""
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSROrigin
    from mobilesuperresolution_tpu_torch.models.mvvsr import MotionVectorVSR
    from mobilesuperresolution_tpu_torch.models.naive_multi import NaiveMultiModel
    from mobilesuperresolution_tpu_torch.models.naive_multi_v1 import NaiveMultiModelV1
    from mobilesuperresolution_tpu_torch.models.single_image import SingleImageModel
    from mobilesuperresolution_tpu_torch.train.checkpoint import (
        jax_named_parameters,
        load_params_npz,
        random_jax_params,
    )
    from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

    def make():
        return {"single": lambda: SingleImageModel(scale=4, channel=8, blocks=2, kernel=3),
                "multi": lambda: NaiveMultiModel(4, ((8, 8, 3), (8, 6, 5))),
                "multi_v1": lambda: NaiveMultiModelV1(4, ((8, 8, 3), (8, 6, 5))),
                "basic_mv": lambda: MotionVectorVSR(num_feat=8, num_block=1, scale=4),
                "basic_origin": lambda: BasicVSROrigin(num_feat=8, num_block=1, scale=4)}[kind]()

    def clip(shape):
        x = torch.rand(shape, generator=g)
        if kind != "basic_mv":
            return x
        return torch.cat([x, torch.randn(shape, generator=g)[..., :2] * 1.5], dim=-1)

    flat = random_jax_params(make(), seed=3)
    g = torch.Generator().manual_seed(12)
    x = clip((1, 3, 64, 64, 3))
    batches = [(clip((1, 3, 64, 64, 3)), torch.rand((1, 3, 256, 256, 3), generator=g)) for _ in range(3)]
    outs, runs = [], []
    for dev in ("cpu", cuda):
        m = load_params_npz(make().to(dev), flat).eval()
        counters = (conv5x5_same, fused_conv_pixel_shuffle, fused_conv_pixel_shuffle_skip)
        before = [c.launches for c in counters]
        with torch.inference_mode():
            outs.append(m(x.to(dev), 256, 256).cpu())
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tuple(c.launches - b for c, b in zip(counters, before)) == ZOO_LAUNCHES[kind]
        m.train()
        named = jax_named_parameters(m)
        step = make_vsr_step(m, vsr_multistep_adam(named, 1e-3, 3, 1, spynet_frozen_mask(named)), (256, 256))
        losses = []
        for i, (lr, hr) in enumerate(batches):
            losses.append(float(step((lr.to(dev), hr.to(dev)))["loss"]))
            if i == 0:
                grads = {k: p.grad.cpu() for k, p in named.items() if p.grad is not None}
        runs.append((losses, grads))
    assert float((outs[1] - outs[0]).abs().max()) <= 1e-4 * float(outs[0].abs().max())
    (l0, g0), (l1, g1) = runs
    assert set(g0) == set(g1) and not any(k.startswith(("flownet/", "spynet/")) for k in g0)
    for i in range(3):
        assert abs(l1[i] - l0[i]) <= 1e-4 * max(1.0, abs(l0[i])), (i, l1[i], l0[i])
    for k in g0:
        assert float((g1[k] - g0[k]).abs().max()) <= 1e-4 * max(float(g0[k].abs().max()), 1e-3), k


def test_timing_harness_launches_b5_and_matches_plain(cuda):
    """kernels/timing.py's split block on the card: one B5 launch per call,
    within f32 tolerance of the plain block; time_fn_loop launches it once
    per chained call."""
    from mobilesuperresolution_tpu_torch.kernels import timing

    fwd, zero = timing._split_block_forward(32, 24, 5, (48, 64), device=cuda)
    assert zero.device.type == "cuda" and zero.shape == (1, 48, 64, 32)
    x = (torch.rand((1, 48, 64, 32), generator=torch.Generator().manual_seed(3)) * 2 - 1).to(cuda)
    weights = timing.split_block_weights(24, 5, device=cuda)
    before = fused_convsep.launches
    with torch.inference_mode():
        got = fwd(x)
        want = timing.split_block(x, 24, weights, branch=fused_convsep_plain)
    torch.cuda.synchronize()
    assert fused_convsep.launches == before + 1
    assert float((got - want).abs().max()) <= _tol(want, torch.float32)
    before = fused_convsep.launches
    ms = timing.time_fn_loop(fwd, zero, iters=4, reps=3, warmup=1)
    assert fused_convsep.launches - before == timing.loop_calls(iters=4, reps=3, warmup=1) and ms > 0


def test_timing_harness_raises_where_b5_refuses(cuda, monkeypatch):
    """A width B5 does not take (65 channels) raises on the card, and the
    plain version never runs in its place."""
    from mobilesuperresolution_tpu_torch.kernels import fused_convsep as b5
    from mobilesuperresolution_tpu_torch.kernels import timing

    def no_plain(*a):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(b5, "fused_convsep_plain", no_plain)
    fwd, zero = timing._split_block_forward(65, 65, 3, (8, 8), device=cuda)
    before = fused_convsep.launches
    with pytest.raises(ValueError, match="not taken"):
        with torch.inference_mode():
            fwd(zero)
    assert fused_convsep.launches == before


def test_pth_loaded_basic_mv_equals_npz_loaded_on_card(cuda, tmp_path):
    """A 'basic_mv' loaded from a reference-layout .pth (train/torch_convert)
    gives bit-equal output to the same weights loaded from an npz."""
    from mobilesuperresolution_tpu_torch.cli.common_cli import load_vsr_eval_params
    from mobilesuperresolution_tpu_torch.models import get_vsr_model
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import reference_state_dict

    flat = random_jax_params(get_vsr_model("basic_mv", device="cpu"), seed=8)
    torch.save(reference_state_dict("basic_mv", flat), tmp_path / "mv.pth")
    np.savez(tmp_path / "mv.npz", **flat)
    by_pth = load_vsr_eval_params(str(tmp_path / "mv.pth"), "basic_mv", get_vsr_model("basic_mv", device=cuda))
    by_npz = load_vsr_eval_params(str(tmp_path / "mv.npz"), "basic_mv", get_vsr_model("basic_mv", device=cuda))
    x = torch.rand((1, 3, 32, 48, 5), generator=torch.Generator().manual_seed(9)).to(cuda)
    with torch.inference_mode():
        assert torch.equal(by_pth(x, 128, 192), by_npz(x, 128, 192))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 24, 40, 54, 48, 3, False), (1, 24, 40, 48, 48, 3, False),
                                   (2, 16, 28, 32, 128, 5, False), (2, 16, 28, 256, 128, 5, False),
                                   (2, 9, 17, 8, 2, 7, False), (1, 21, 33, 3, 12, 5, False),
                                   (2, 19, 37, 40, 144, 3, False), (2, 20, 30, 80, 96, 5, True)])
def test_qconv_int8_kernel_matches_plain(cuda, shape, dtype, bias):
    """Q1s and Q1 equal their plain versions bit for bit on float inputs at
    the dual trunk's and SpyNet's channel counts (tensor cores), the odd 8->2
    direct 7x7 and the 3->12 skip (CUDA cores), a ragged shape (H, W past
    the tile, Ci 40 past a 32-channel k-step, Co 144 in three N tiles) and a
    row window of a taller tensor (a view, as height sharding passes; in
    bf16 64-channel chunks, Ci 80 and Co 96 ragged in them), f32 and bf16,
    with and without bias; and at the int32 edge, inputs of exactly -127 xs
    against weights of 127."""
    from mobilesuperresolution_tpu_torch.kernels.qconv_int8 import (
        act_scale,
        act_scale_plain,
        k_chunk,
        pack_weights,
        qconv_int8,
        qconv_int8_plain,
    )

    n, h, w, ci, co, k, view = shape
    g = torch.Generator().manual_seed(ci + co)
    full = ((torch.rand((n, h + 6 * view, w, ci), generator=g) * 2 - 1) * 3).to(cuda, dtype)
    x = full[:, 3:3 + h] if view else full
    assert x.is_contiguous() != view
    wq = torch.randint(-127, 128, (co, ci, k, k), generator=g, dtype=torch.int8).to(cuda)
    ks = (torch.rand(co, generator=g) * 1e-2).to(cuda)
    b = (torch.rand(co, generator=g) - 0.5).to(cuda) if bias else None
    q1, q1s = qconv_int8.launches, act_scale.launches
    xs = act_scale(x)
    assert torch.equal(xs, act_scale_plain(x))
    got = qconv_int8(x, xs, wq, ks, b, packed=pack_weights(wq, k_chunk(dtype, ci, co, k)))
    assert got.dtype == dtype and torch.equal(got, qconv_int8_plain(x, xs, wq, ks, b))
    assert torch.equal(qconv_int8(x, None, wq, ks, b), got)  # Q1s then Q1 from one call
    edge = torch.full_like(x, -63.5)  # -127 x 0.5, exact in bf16 too
    edge_w = torch.full_like(wq, 127)
    xs_edge = act_scale(edge)
    assert torch.equal(xs_edge, torch.full((n,), 0.5, device=cuda))
    assert torch.equal(qconv_int8(edge, xs_edge, edge_w, ks, b), qconv_int8_plain(edge, xs_edge, edge_w, ks, b))
    assert (qconv_int8.launches - q1, act_scale.launches - q1s) == (3, 3)


def test_quantized_tiny_basic_matches_cpu(cuda):
    """A quantized tiny BasicVSR on the card (Q1 and Q1s for SpyNet's 30
    convs and the trunks' 3 per step, B2 once, B1 never) against the same
    model on the CPU: within 1e-2 of the largest output, mean 1e-3 (float32
    convs in other orders upstream can flip a round-half activation by one
    step)."""
    from mobilesuperresolution_tpu_torch.kernels.qconv_int8 import act_scale, qconv_int8
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    x = torch.rand((1, 3, 32, 48, 3), generator=torch.Generator().manual_seed(3))
    outs = []
    for d in ("cpu", cuda):
        m = BasicVSR(num_feat=8, num_block=1, scale=4, quantized=True).to(d)
        load_params_npz(m, random_jax_params(m, seed=3))
        counts = (qconv_int8.launches, act_scale.launches, conv5x5_same.launches, fused_conv_pixel_shuffle.launches)
        with torch.inference_mode():
            outs.append(m(x.to(d), 128, 192).cpu())
        counts = tuple(a - b for a, b in zip((qconv_int8.launches, act_scale.launches, conv5x5_same.launches,
                                              fused_conv_pixel_shuffle.launches), counts))
    assert counts == (30 + 3 * 3, 30 + 3 * 3, 0, 1)
    top = float(outs[0].abs().max())
    diff = (outs[1] - outs[0]).abs()
    assert float(diff.max()) <= 1e-2 * top and float(diff.mean()) <= 1e-3 * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatially_sharded_wdsr_matches_full_frame_on_card(cuda, dtype):
    """Height-sharded WDSR-B (4 blocks, 24 units: radius 6) at S = 2 and 3 on
    the card against its full-frame forward: 4 B3 + 1 B4 per window."""
    from mobilesuperresolution_tpu_torch.models.wdsr_basic import BasicModel
    from mobilesuperresolution_tpu_torch.parallel.halo import receptive_radius_wdsr, spatially_sharded_apply
    from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    m = BasicModel(num_blocks=4, num_residual_units=24, scale=2, compute_dtype=dtype).to(cuda)
    load_params_npz(m, random_jax_params(m, 3))
    m.eval()
    x = torch.rand((1, 48, 40, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    with torch.inference_mode():
        want = m(x)
        for n in (2, 3):
            b3, b4 = fused_wdsr_block.launches, fused_conv_pixel_shuffle_skip.launches
            got = spatially_sharded_apply(m, x, Mesh(n, cuda), receptive_radius_wdsr(4), scale=2)
            assert (fused_wdsr_block.launches - b3, fused_conv_pixel_shuffle_skip.launches - b4) == (4 * n, n)
            assert float((got.float() - want.float()).abs().max()) <= _tol(want, dtype)


@pytest.mark.parametrize("kind", ["basic", "basic_origin"])
def test_spatial_basicvsr_matches_full_frame_on_card(cuda, kind):
    """Height-sharded BasicVSR / BasicVSROrigin (nf 8, 1 block) at S = 2 and
    4 on the card against the plain forward: B1 30 and B2 once (twice for
    basic_origin) per forward."""
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR, BasicVSROrigin
    from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh
    from mobilesuperresolution_tpu_torch.parallel.vsr_spatial import spatial_basicvsr_forward
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    m = (BasicVSR if kind == "basic" else BasicVSROrigin)(num_feat=8, num_block=1).to(cuda)
    load_params_npz(m, random_jax_params(m, 2))
    m.eval()
    x = torch.rand((1, 3, 64, 64, 3), generator=torch.Generator().manual_seed(2)).to(cuda)
    with torch.inference_mode():
        want = m(x, 256, 256)
        for n in (2, 4):
            b1, b2 = conv5x5_same.launches, fused_conv_pixel_shuffle.launches
            got = spatial_basicvsr_forward(m, x, 256, 256, Mesh(n, cuda), max_disp=8)
            assert conv5x5_same.launches - b1 == 30
            assert fused_conv_pixel_shuffle.launches - b2 == (1 if kind == "basic" else 2)
            assert float((got - want).abs().max()) <= _tol(want, torch.float32)


@pytest.mark.parametrize("kind", ["sisr", "vsr"])
def test_spatial_training_step_matches_plain_on_card(cuda, kind):
    """One height-sharded training step (S = 2; on a machine with several
    cards, shard 1 runs on the next card through a differentiable copy of
    the parameters, and its gradients flow back across cards) against the
    plain step: the loss within 1e-5 relative, and every parameter's
    gradient, read after the step, within 1e-5 of that gradient's largest
    magnitude in the plain step (f32, TF32 off: only summation order
    differs)."""
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
    from mobilesuperresolution_tpu_torch.models.wdsr_basic import BasicModel
    from mobilesuperresolution_tpu_torch.parallel.halo import receptive_radius_wdsr
    from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh
    from mobilesuperresolution_tpu_torch.parallel.spatial_train import make_spatial_sisr_step
    from mobilesuperresolution_tpu_torch.parallel.vsr_spatial import make_spatial_vsr_step
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters, load_params_npz
    from mobilesuperresolution_tpu_torch.train.checkpoint import random_jax_params
    from mobilesuperresolution_tpu_torch.train.state import multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step, make_vsr_step

    g = torch.Generator().manual_seed(4)
    if kind == "sisr":
        batch = (torch.rand((2, 48, 40, 3), generator=g), torch.rand((2, 96, 80, 3), generator=g))
    else:
        batch = (torch.rand((1, 3, 64, 64, 3), generator=g), torch.rand((1, 3, 256, 256, 3), generator=g))
    batch = tuple(t.to(cuda) for t in batch)
    runs = []
    for sharded in (False, True):
        m = BasicModel(num_blocks=4, num_residual_units=24, scale=2) if kind == "sisr" else BasicVSR(8, 1, 4)
        m = m.to(cuda)
        load_params_npz(m, random_jax_params(m, 5))
        m.train()
        opt = multistep_adam(jax_named_parameters(m), 1e-3, 10, 1)
        mesh = Mesh(2, cuda)
        if kind == "sisr":
            step = (make_spatial_sisr_step(m, opt, mesh, receptive_radius_wdsr(4), 2) if sharded
                    else make_sisr_step(m, opt))
        else:
            step = make_spatial_vsr_step(m, opt, mesh, (256, 256)) if sharded else make_vsr_step(m, opt, (256, 256))
        loss = float(step(batch)["loss"])
        runs.append((loss, {k: p.grad.clone() for k, p in m.named_parameters() if p.grad is not None}))
    assert abs(runs[1][0] - runs[0][0]) <= 1e-5 * abs(runs[0][0])
    assert runs[0][1] and runs[1][1].keys() == runs[0][1].keys()
    for k, want in runs[0][1].items():
        assert float((runs[1][1][k] - want).abs().max()) <= 1e-5 * float(want.abs().max()), k


def test_data_axis_places_windows_and_patches_on_two_cards(cuda):
    """The in-process data axis over the visible cards: a tiny BasicVSR's
    windows (``chunked_vsr_apply(mesh=)``, 10 frames in 5 windows) and patch
    batches (``evaluate_by_patch(mesh=)``) run with group member i on card
    i, through the model's eval copies (``cli.train_vsr.replica_forward``),
    each output on its input's card; the results, back on card 0, against
    the plain path on card 0 within 1e-5 of the largest output (f32, TF32
    off), the patch statistics within 1e-4. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from mobilesuperresolution_tpu_torch.cli.test_vsr_by_patch import evaluate_by_patch
    from mobilesuperresolution_tpu_torch.cli.train_vsr import replica_forward
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
    from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh
    from mobilesuperresolution_tpu_torch.parallel.temporal import chunked_vsr_apply
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    home = torch.device("cuda", 0)
    model = BasicVSR(num_feat=8, num_block=1, scale=4).to(home)
    load_params_npz(model, random_jax_params(model, seed=3))
    model.eval()
    mesh = Mesh(1, home)
    assert mesh.data_devices[:2] == [home, torch.device("cuda", 1)]
    data_fwd, plain_fwd = replica_forward(model, mesh), replica_forward(model)
    seen = []

    def fwd(x, oh, ow):
        y = data_fwd(x, oh, ow)
        assert y.device == x.device
        seen.append(y.device)
        return y

    lr = torch.from_numpy(np.random.default_rng(3).random((1, 10, 32, 48, 3), dtype=np.float32)).to(home)
    got = chunked_vsr_apply(fwd, lr, 128, 192, chunk=2, overlap=1, mesh=mesh)
    want = chunked_vsr_apply(plain_fwd, lr, 128, 192, chunk=2, overlap=1)
    assert got.device == home and torch.device("cuda", 1) in seen and home in seen
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    seen.clear()
    hr = torch.rand(1, 3, 4 * 32, 4 * 48, 3, device=home)
    clips = [("c", lr[:, :3], hr)]
    got = evaluate_by_patch(fwd, iter(clips), 4, (16, 16), (4, 0), mesh=mesh)
    want = evaluate_by_patch(plain_fwd, iter(clips), 4, (16, 16), (4, 0), len(mesh.data_devices))
    assert torch.device("cuda", 1) in seen and home in seen
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_data_groups_serve_on_four_cards(cuda):
    """Serving's data groups across cards: on four cards a one-process mesh
    of S = 2 has D = 2 groups, group 1's shards on cards 2 and 3. A tiny
    BasicVSR (f32, TF32 off) serves four lockstep streams through
    cli.serve's stream, plain and flow-cached: group g's windows run on its
    own cards (SpyNet, the sharded trunk, the reconstruction), and the
    result on card 0 equals one group serving each half of the streams bit
    for bit, and one group serving all four within 1e-5 of the largest
    output (cuDNN may pick another algorithm for twice the batch). Needs
    four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    from mobilesuperresolution_tpu_torch.cli import serve
    from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
    from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh
    from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

    home = torch.device("cuda", 0)
    model = BasicVSR(num_feat=8, num_block=1, scale=4).to(home)
    load_params_npz(model, random_jax_params(model, seed=3))
    model.eval()
    mesh = Mesh(2, home)
    assert [g.devices for g in mesh.groups] == [[torch.device("cuda", i) for i in pair] for pair in ((0, 1), (2, 3))]
    one = Mesh(2, home)
    one.groups = [one]  # a single group over the same cards
    clip = np.random.default_rng(3).random((4, 7, 64, 48, 3), dtype=np.float32)
    seen = []
    orig = serve.spatial_basicvsr_forward

    def spying(m, x, *a, **kw):
        seen.append(x.device)
        return orig(m, x, *a, **kw)

    def run(mesh, streams, flow_cache):
        stream = serve.make_stream(model, mesh, 256, 192, 2, 1, len(streams), home, flow_cache=flow_cache)
        out = []
        for i in range(clip.shape[1]):
            out.extend(stream.push(clip[streams, i]))
        out.extend(stream.flush())
        return np.stack(out, 1)

    serve.spatial_basicvsr_forward = spying
    try:
        for flow_cache in (False, True):
            got = run(mesh, [0, 1, 2, 3], flow_cache)
            halves = np.concatenate([run(one, [0, 1], flow_cache), run(one, [2, 3], flow_cache)])
            whole = run(one, [0, 1, 2, 3], flow_cache)
            assert np.array_equal(got, halves), flow_cache
            assert float(np.abs(got - whole).max()) <= 1e-5 * float(np.abs(whole).max()), flow_cache
    finally:
        serve.spatial_basicvsr_forward = orig
    assert torch.device("cuda", 2) in seen and home in seen


def test_two_nccl_ranks_match_one_process(cuda, tmp_path):
    """Two NCCL ranks on cards 0 and 1 (tests/helpers/torch_parallel_worker.py:
    tcp:// for cli.pretrain, then env:// with torchrun's variables for
    cli.train_vsr and cli.search) against one process with the global batch
    on card 0: the pretrain losses within 1e-5 relative and the weights
    within 1e-5; the group-mean gradients of one step on half batches within
    1e-5 of each gradient's largest magnitude (f32, TF32 off); the chief
    alone evaluates and writes; a rank-1 NaN batch skips the update on both;
    a SIGTERM on rank 0 stops both at the same step with one checkpoint; the
    VSR and search losses within 1e-5 relative. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    import json

    from mobilesuperresolution_tpu_torch.cli import pretrain, search, train_vsr
    from mobilesuperresolution_tpu_torch.kernels import _build
    from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers"))
    import torch_parallel_worker as worker

    _build.build()  # before the ranks start, so that neither builds
    jobs, wait = worker.start(str(tmp_path), device="cuda", timeout=600)
    try:
        one = pretrain.main(["--job_dir", str(tmp_path / "one"), "--num_patches", "2", "--learning_rate", "1e-3"]
                            + worker.sisr_args("cuda:0", batch=4))
        m, opt = worker.tiny_sisr_model(cuda)
        make_sisr_step(m, opt)(tuple(torch.from_numpy(a).to(cuda) for a in worker.global_batch()))
        want_grads = {k: p.grad.cpu().numpy() for k, p in m.named_parameters()}
        vsr = train_vsr.main(["--job_dir", str(tmp_path / "vsr"), "--device", "cuda:0", "--dataset",
                              "synthetic_vsr", "--eval_datasets", "synthetic_vsr", "--epochs", "1",
                              "--synthetic_frames", "2", "--image_batch", "2", "--train_batch_size", "2",
                              "--lr_patch_size", "12"])
        nas = search.main(["--job_dir", str(tmp_path / "search"), "--device", "cuda:0", "--dataset",
                           "synthetic_isr", "--eval_datasets", "synthetic_isr", "--num_blocks", "2",
                           "--num_residual_units", "8", "--width_epochs", "1", "--epochs", "0", "--kernel_epochs",
                           "0", "--lr_patch_size", "8", "--train_batch_size", "4", "--num_patches", "1"])
    finally:
        outs = wait()
    sisr = [r["sisr"] for r in outs]
    assert [r["world"] for r in sisr] == [2, 2] and [r["device"] for r in sisr] == ["cuda:0", "cuda:1"]
    want = [s["loss"] for s in one["steps"]]
    for r in sisr:
        np.testing.assert_allclose(r["losses"], want, rtol=1e-5)
        assert r["nan_step"] == {"skipped": 1.0, "steps": 1, "unchanged": True}
        assert r["stop"] == {"preempted": {"epoch": 1, "batch": 16}, "steps": 16, "ckpt": ["1.pt", "run_meta.json"]}
    assert sisr[0]["eval"] and not sisr[1]["eval"]
    for r in range(2):
        got = np.load(os.path.join(jobs, f"grads{r}.npz"))
        assert set(got.files) == set(want_grads)
        for k, g in want_grads.items():
            assert float(np.abs(got[k] - g).max()) <= 1e-5 * float(np.abs(g).max()), (r, k)
    a = np.load(tmp_path / "one" / "weights" / "models.npz")
    b = np.load(os.path.join(jobs, "train", "weights", "models.npz"))
    for key in a:
        np.testing.assert_allclose(b[key], a[key], atol=1e-5, err_msg=key)
    tags = [json.loads(ln)["tag"] for ln in open(os.path.join(jobs, "train", "metrics.jsonl"))]
    assert tags.count("training_loss_smooth") == 1
    assert sorted(os.listdir(os.path.join(jobs, "train", "ckpt"))) == ["1.pt", "run_meta.json"]
    for r in (o["vsr"] for o in outs):
        assert r["world"] == 2
        np.testing.assert_allclose(r["vsr_losses"], [s["loss"] for s in vsr["steps"]], rtol=1e-5)
        np.testing.assert_allclose(r["search_losses"], [s["loss"] for s in nas["steps"]], rtol=1e-5)
    assert outs[0]["vsr"]["vsr_eval"] and not outs[1]["vsr"]["vsr_eval"]
