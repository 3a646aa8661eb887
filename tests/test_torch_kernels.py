"""Port parity for the hand kernels' plain versions (the path a CPU tensor
takes) against the JAX package's Pallas kernels in interpret mode, as
tests/test_kernels.py runs them, and against the JAX layers they stand for.
float32 on the CPU; 1e-4 absolute, as tests/test_kernels.py holds the Pallas
kernels to lax.conv (sums of up to 25·Cin terms in another order).

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.kernels.conv5x5 import conv5x5_same as j_conv5x5
from mobilesuperresolution_tpu.kernels.fused_tail import fused_conv_pixel_shuffle as j_tail
from mobilesuperresolution_tpu.ops.layers import SubpixelConvTranspose as JSubpixel
from mobilesuperresolution_tpu_torch.kernels import _build
from mobilesuperresolution_tpu_torch.kernels.conv5x5 import conv5x5_same, conv5x5_same_plain
from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
    fused_conv_pixel_shuffle,
    fused_conv_pixel_shuffle_plain,
)
from mobilesuperresolution_tpu_torch.ops.layers import subpixel_transpose_kernel

torch.set_num_threads(2)
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _lax_conv(x, w, b, relu):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
    ) + jnp.asarray(b)
    return np.asarray(jnp.maximum(y, 0) if relu else y)


@pytest.mark.parametrize("cin,cout,relu", [(32, 16, True), (8, 8, False)])
def test_conv5x5_matches_pallas_interpret(rng, cin, cout, relu):
    """H divisible by 8: the Pallas entry needs a row tile dividing H."""
    x = (rng.standard_normal((2, 16, 20, cin)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((5, 5, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    want = np.asarray(j_conv5x5(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu, interpret=True))
    got = conv5x5_same(_t(x), _t(w), _t(b), relu=relu)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(), conv5x5_same_plain(_t(x), _t(w), _t(b), relu).numpy())


@pytest.mark.parametrize("shape", [(18, 4, 7, 32, 128), (3, 5, 9, 64, 8), (1, 1, 1, 4, 3)])
def test_conv5x5_odd_small_shapes_match_lax(rng, shape):
    """The shapes the Pallas entry refuses (level-0 4x7 s2d map, Cout=8)."""
    n, h, w, cin, cout = shape
    x = (rng.standard_normal((n, h, w, cin)) * 0.1).astype(np.float32)
    wt = (rng.standard_normal((5, 5, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    got = conv5x5_same(_t(x), _t(wt), _t(b), relu=True).numpy()
    np.testing.assert_allclose(got, _lax_conv(x, wt, b, True), atol=ATOL)


@pytest.mark.parametrize("scale", [2, 4])
def test_fused_tail_3x3_matches_pallas_interpret(rng, scale):
    b_, h, w, c = 2, 16, 20, 8
    c_out = scale * scale * 3
    x = rng.standard_normal((b_, h, w, c)).astype(np.float32)
    kern = (rng.standard_normal((3, 3, c, c_out)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    want = np.asarray(j_tail(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias), scale, tile=8, interpret=True))
    got = fused_conv_pixel_shuffle(_t(x), _t(kern), _t(bias), scale)
    assert got.shape == (b_, h * scale, w * scale, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("hw", [(6, 7), (5, 9)])
def test_fused_tail_main_path_form_matches_subpixel_transpose(rng, hw):
    """2x2 conv, pad ((1,2),(1,2)), s=4, crop to (4h+1, 4w+1): JAX
    SubpixelConvTranspose(out_hw=None) with the bias added after the crop."""
    h, w = hw
    x = rng.standard_normal((2, h, w, 12)).astype(np.float32)
    jm = JSubpixel(3, kernel_size=5, stride=4)
    p = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    p = {"kernel": p["kernel"], "bias": jnp.asarray(rng.standard_normal(3).astype(np.float32))}
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    k2 = subpixel_transpose_kernel(_t(p["kernel"]), 4)
    got = fused_conv_pixel_shuffle(
        _t(x), k2, _t(p["bias"]).repeat_interleave(16), 4, padding=((1, 2), (1, 2)), crop=(4 * h + 1, 4 * w + 1)
    )
    assert got.shape == want.shape == (2, 4 * h + 1, 4 * w + 1, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_fused_tail_rejects_crop_outside_output(rng):
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        fused_conv_pixel_shuffle_plain(x, torch.zeros(3, 3, 8, 12), torch.zeros(12), 2, crop=(9, 8))


def test_wrappers_take_plain_path_only_on_cpu():
    """A tensor that is on neither the CPU nor CUDA is refused, never
    silently computed by the plain version."""
    x = torch.empty(1, 8, 8, 4, device="meta")
    with pytest.raises(ValueError):
        conv5x5_same(x, torch.empty(5, 5, 4, 4, device="meta"), torch.empty(4, device="meta"))
    with pytest.raises(ValueError):
        fused_conv_pixel_shuffle(x, torch.empty(3, 3, 4, 12, device="meta"), torch.empty(12, device="meta"), 2)
    launches = (conv5x5_same.launches, fused_conv_pixel_shuffle.launches)
    conv5x5_same(torch.zeros(1, 8, 8, 4), torch.zeros(5, 5, 4, 4), torch.zeros(4))
    assert (conv5x5_same.launches, fused_conv_pixel_shuffle.launches) == launches


def test_build_is_lazy():
    """Importing the kernel modules compiles and loads nothing."""
    assert _build._libs == {}
    assert set(_build.SOURCES) == {"conv5x5", "fused_tail", "fused_wdsr_block"}
