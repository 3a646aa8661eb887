"""Port parity: mobilesuperresolution_tpu_torch.ops against the JAX package's
ops on the same numpy inputs, float32 on the CPU.

Tolerances: 1e-5 absolute where both sides do the same float32 arithmetic in
another order (convs, resizes over a few dozen terms); exact where the op only
moves data.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.ops import layers as jl
from mobilesuperresolution_tpu.ops import resize as jr
from mobilesuperresolution_tpu.ops import s2d_conv as js
from mobilesuperresolution_tpu.ops.quant import conv2d_maybe_quantized as j_conv
from mobilesuperresolution_tpu.ops.warp import flow_warp as j_warp
from mobilesuperresolution_tpu_torch.ops import layers as tl
from mobilesuperresolution_tpu_torch.ops import resize as tr
from mobilesuperresolution_tpu_torch.ops import s2d_conv as ts
from mobilesuperresolution_tpu_torch.ops.quant import conv2d_maybe_quantized as t_conv
from mobilesuperresolution_tpu_torch.ops.warp import flow_warp as t_warp

torch.set_num_threads(2)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("r", [2, 4])
def test_depth_space_roundtrip_matches_jax(rng, r):
    x = rng.standard_normal((2, 3, 5, 3 * r * r)).astype(np.float32)
    d2s = tl.depth_to_space(_t(x), r)
    np.testing.assert_array_equal(d2s.numpy(), np.asarray(jl.depth_to_space(jnp.asarray(x), r)))
    np.testing.assert_array_equal(tl.space_to_depth(d2s, r).numpy(), x)
    np.testing.assert_array_equal(
        d2s.numpy(), torch.nn.functional.pixel_shuffle(_t(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1).numpy()
    )


@pytest.mark.parametrize("k", [1, 3])
def test_plain_conv_matches_jax(rng, k):
    x = rng.standard_normal((2, 8, 10, 6)).astype(np.float32)
    jm = jl.PlainConv(5, k)
    p = jm.init(jax.random.key(0), jnp.asarray(x))["params"]["Conv_0"]
    tm = tl.PlainConv(6, 5, k)
    with torch.no_grad():
        tm.kernel.copy_(_t(p["kernel"]))
        tm.bias.copy_(_t(p["bias"]))
    tm.prepare(torch.float32)
    want = np.asarray(jm.apply({"params": {"Conv_0": p}}, jnp.asarray(x)))
    np.testing.assert_allclose(tm(_t(x)).numpy(), want, atol=ATOL)


@pytest.mark.parametrize("k,s", [(5, 4), (3, 2), (4, 2)])
def test_subpixel_transpose_kernel_matches_jax(rng, k, s):
    w = rng.standard_normal((k, k, 3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.subpixel_transpose_kernel(_t(w), s).numpy(),
        np.asarray(jl.subpixel_transpose_kernel(jnp.asarray(w), s)),
    )


@pytest.mark.parametrize("out_hw", [None, (37, 45)])
def test_subpixel_conv_transpose_matches_jax(rng, out_hw):
    """out_hw=(oh, ow): the port adds the bias before the resize, JAX after;
    equal up to rounding since each resize row sums to 1."""
    x = rng.standard_normal((2, 6, 7, 8)).astype(np.float32)
    jm = jl.SubpixelConvTranspose(3, kernel_size=5, stride=4)
    p = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    p = {"kernel": p["kernel"], "bias": jnp.asarray(rng.standard_normal(3).astype(np.float32))}
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), out_hw=out_hw))
    tm = tl.SubpixelConvTranspose(8, 3, kernel_size=5, stride=4)
    with torch.no_grad():
        tm.kernel.copy_(_t(p["kernel"]))
        tm.bias.copy_(_t(p["bias"]))
    tm.prepare(torch.float32)
    got = tm(_t(x), out_hw=out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize(
    "n_in,n_out,ac", [(5, 1, False), (5, 1, True), (4, 9, False), (9, 4, False), (4, 8, True), (1, 3, True)]
)
def test_linear_resize_matrix_matches_jax(n_in, n_out, ac):
    np.testing.assert_array_equal(
        tr.linear_resize_matrix(n_in, n_out, ac), jr.linear_resize_matrix(n_in, n_out, ac)
    )


@pytest.mark.parametrize(
    "out_hw,ac", [((20, 30), False), ((20, 30), True), ((5, 7), False), ((1, 1), False), ((1, 1), True), ((8, 12), False)]
)
def test_resize_bilinear_matches_jax(rng, out_hw, ac):
    x = rng.standard_normal((2, 3, 8, 12, 4)).astype(np.float32)
    want = np.asarray(jr.resize_bilinear(jnp.asarray(x), out_hw, align_corners=ac))
    got = tr.resize_bilinear(_t(x), out_hw, align_corners=ac).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the explicit matrix form is the same map
    m_h = tr.linear_resize_matrix(8, out_hw[0], ac)
    m_w = tr.linear_resize_matrix(12, out_hw[1], ac)
    np.testing.assert_allclose(np.einsum("oh,pw,...hwc->...opc", m_h, m_w, x), want, atol=ATOL)


def test_avg_pool_and_replicate_pad_match_jax(rng):
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tr.avg_pool_2x2(_t(x)).numpy(), np.asarray(jr.avg_pool_2x2(jnp.asarray(x))), atol=1e-6
    )
    np.testing.assert_array_equal(
        tr.replicate_pad_hw(_t(x), 2, 1).numpy(), np.asarray(jr.replicate_pad_hw(jnp.asarray(x), 2, 1))
    )


@pytest.mark.parametrize("k,f", [(7, 2), (7, 4), (5, 2)])
def test_s2d_transform_matches_jax(rng, k, f):
    assert ts.transformed_kernel_size(k, f) == js.transformed_kernel_size(k, f)
    np.testing.assert_array_equal(ts._scatter_tensor(k, f), js._scatter_tensor(k, f))
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        ts.s2d_transform_weights(_t(w), f).numpy(),
        np.asarray(js.s2d_transform_weights(jnp.asarray(w), f)),
        atol=1e-6,
    )


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_flow_warp_matches_jax(rng, mode):
    """Flows up to ±1.5 frame widths so samples fall outside on every side."""
    n, h, w, c = 2, 9, 13, 5
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 2)) * np.array([w, h]) * 0.5).astype(np.float32)
    flow[0, :3] = 0.0  # integer sample points too
    want = np.asarray(j_warp(jnp.asarray(x), jnp.asarray(flow), padding_mode=mode))
    got = t_warp(_t(x), _t(flow), padding_mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and grid_sample's semantics, which the JAX op reproduces
    gx = (np.arange(w) + flow[..., 0]) * 2 / (w - 1) - 1
    gy = (np.arange(h)[:, None] + flow[..., 1]) * 2 / (h - 1) - 1
    grid = torch.from_numpy(np.stack([gx, gy], -1).astype(np.float32))
    gs = torch.nn.functional.grid_sample(
        _t(x).permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode=mode, align_corners=True
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, gs.numpy(), atol=1e-4)


def test_flow_warp_rejects_unknown_padding():
    with pytest.raises(ValueError):
        t_warp(torch.zeros(1, 2, 2, 1), torch.zeros(1, 2, 2, 2), padding_mode="reflection")


@pytest.mark.parametrize("k", [3, 7])
def test_conv2d_exact_branch_matches_jax(rng, k):
    x = rng.standard_normal((2, 9, 11, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 6)).astype(np.float32) * 0.1
    b = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = t_conv(_t(x), _t(w).permute(3, 2, 0, 1).contiguous(), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the int8 branch equals JAX's bit for bit (tests/test_torch_quant.py has the rest)
    want_q = np.asarray(j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), quantized=True))
    got_q = t_conv(_t(x), _t(w).permute(3, 2, 0, 1), _t(b), quantized=True).numpy()
    np.testing.assert_array_equal(got_q, want_q)
