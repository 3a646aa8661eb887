"""The hand kernels on the card against their plain versions. Needs an
NVIDIA GPU and skips without one. This file imports no JAX, so on a machine
without it run it with the repository's conftest (which imports JAX) turned
off:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same, conv5x5_same_plain
from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
    fused_conv_pixel_shuffle,
    fused_conv_pixel_shuffle_plain,
    fused_conv_pixel_shuffle_skip,
    fused_conv_pixel_shuffle_skip_plain,
)
from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import fused_wdsr_block, fused_wdsr_block_plain

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


def _rand(g, shape, scale, dev, dtype=torch.float32):
    return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 37, 53), (1, 5, 3)], ids=["tiles", "ragged", "tiny"])
def test_fused_wdsr_block_kernel_matches_plain(cuda, dtype, shape):
    """Whole tiles, ragged tiles (H, W not multiples of 16) and a map smaller
    than the halo: h2 must be zero outside the image on every border."""
    n, h, w = shape
    g = torch.Generator().manual_seed(0)
    x = _rand(g, (n, h, w, 24), 1.0, cuda, dtype)
    w1, b1 = _rand(g, (24, 144), 24 ** -0.5, cuda), _rand(g, (144,), 0.2, cuda)
    w2, b2 = _rand(g, (144, 20), 144 ** -0.5, cuda), _rand(g, (20,), 0.2, cuda)
    w3, b3 = _rand(g, (3, 3, 20, 24), 180 ** -0.5, cuda), _rand(g, (24,), 0.2, cuda)
    if dtype == torch.bfloat16:
        w1, b1, w2, b2, w3, b3 = (t.to(dtype).float() for t in (w1, b1, w2, b2, w3, b3))
    before = fused_wdsr_block.launches
    got = fused_wdsr_block(x, w1, b1, w2, b2, w3, b3)
    want = fused_wdsr_block_plain(x, w1, b1, w2, b2, w3, b3)
    torch.cuda.synchronize()
    assert fused_wdsr_block.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - want.float()).abs().max()) <= _tol(want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin", [24, 18])
def test_fused_tail_skip_kernel_matches_plain(cuda, dtype, cin):
    """B4: tail 3x3 (WDSR 24 or ResultNet 18 channels) + skip 5x5 from 3
    channels, s = 2, on a ragged 21x35 map."""
    g = torch.Generator().manual_seed(1)
    x = _rand(g, (2, 21, 35, cin), 1.0, cuda, dtype)
    xs = _rand(g, (2, 21, 35, 3), 0.5, cuda, dtype)
    kern = _rand(g, (3, 3, cin, 12), (9 * cin) ** -0.5, cuda)
    ks = _rand(g, (5, 5, 3, 12), 75 ** -0.5, cuda)
    b = _rand(g, (12,), 0.5, cuda)
    before = (fused_conv_pixel_shuffle.launches, fused_conv_pixel_shuffle_skip.launches)
    got = fused_conv_pixel_shuffle_skip(x, kern, b, 2, xs, ks)
    want = fused_conv_pixel_shuffle_skip_plain(x, kern, b, 2, xs, ks)
    torch.cuda.synchronize()
    assert (fused_conv_pixel_shuffle.launches, fused_conv_pixel_shuffle_skip.launches) == (before[0], before[1] + 1)
    assert got.dtype == dtype and got.shape == (2, 42, 70, 3)
    assert float((got.float() - want.float()).abs().max()) <= _tol(want, dtype)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        conv5x5_same(x, torch.zeros(5, 5, 4, 4, device=cuda, dtype=torch.float16), torch.zeros(4, device=cuda))
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        conv5x5_same(x[:, :, ::2], torch.zeros(5, 5, 4, 4, device=cuda), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):
        fused_conv_pixel_shuffle(x, torch.zeros(3, 3, 4, 80, device=cuda), torch.zeros(80, device=cuda), 2)
    with pytest.raises(ValueError, match="not instantiated"):
        z = torch.zeros
        fused_wdsr_block(z(1, 8, 8, 16, device=cuda), z(16, 96, device=cuda), z(96, device=cuda),
                         z(96, 13, device=cuda), z(13, device=cuda), z(3, 3, 13, 16, device=cuda), z(16, device=cuda))
    with pytest.raises(ValueError):
        fused_conv_pixel_shuffle_skip(x, torch.zeros(3, 3, 4, 12, device=cuda), torch.zeros(12, device=cuda), 2,
                                      torch.zeros(1, 8, 9, 3, device=cuda), torch.zeros(5, 5, 3, 12, device=cuda))
