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
from mobilesuperresolution_tpu_torch.kernels.conv5x5 import (
    conv5x5_same,
    conv5x5_same_plain,
    f32_packed_shape,
    pack_weights,
    pack_weights_f32,
    tf32_split,
)
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
    assert set(_build.SOURCES) == {"conv5x5", "fused_tail", "fused_wdsr_block", "fused_convsep", "qconv_int8"}


def test_stale_follows_included_headers(tmp_path, monkeypatch):
    """A built library is rebuilt when its source or any csrc/ header the
    source includes is newer than it, and reused otherwise."""
    import os

    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\nint f();\n')
    (csrc / "shared.cuh").write_text("#pragma once\n")
    (csrc / "other.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    assert _build._stale("k")  # never built
    (build / "libk.so").write_text("")
    os.utime(csrc / "k.cu", (100, 100))
    os.utime(csrc / "shared.cuh", (100, 100))
    os.utime(csrc / "other.cuh", (300, 300))
    os.utime(build / "libk.so", (200, 200))
    assert _build._deps("k") == [str(csrc / "k.cu"), str(csrc / "shared.cuh")]
    assert not _build._stale("k")  # a header it does not include is newer: reused
    os.utime(csrc / "shared.cuh", (250, 250))
    assert _build._stale("k")  # an included header is newer
    os.utime(csrc / "shared.cuh", (100, 100))
    os.utime(csrc / "k.cu", (250, 250))
    assert _build._stale("k")  # the source is newer


def test_every_source_include_resolves():
    """Each quoted include of the kernel sources names a header in csrc/."""
    import os

    for name in _build.SOURCES:
        for dep in _build._deps(name):
            assert os.path.exists(dep), dep
    assert any(d.endswith("hopper.cuh") for d in _build._deps("conv5x5"))
    assert any(d.endswith("hopper.cuh") for d in _build._deps("fused_tail"))


@pytest.mark.parametrize("cin,cout", [(16, 128), (40, 192)])
def test_pack_weights_is_an_exact_permutation(cin, cout):
    """The packed weights the bf16 kernel copies in bulk hold every HWIO
    value once, in swizzled 8 x 64 atoms, and unpack back to HWIO."""
    w = torch.arange(5 * 5 * cin * cout, dtype=torch.float32).reshape(5, 5, cin, cout)
    p = pack_weights(w)
    assert p.shape == (25, cin // 8, cout // 64, 8, 64) and p.is_contiguous()
    assert torch.equal(p.flatten().sort().values, w.flatten())
    r = torch.arange(8)
    unswizzled = p.reshape(25, cin // 8, cout // 64, 8, 8, 8)[:, :, :, r[:, None], r[None, :] ^ r[:, None]]
    assert torch.equal(unswizzled.permute(0, 1, 3, 2, 4, 5).reshape(5, 5, cin, cout), w)
    # tap (1, 2), input channel 8 + 3, output channels 64 + 8 * (5 ^ 3) .. + 7 in chunk 5 of row 3
    assert torch.equal(p[7, 1, 1, 3, 40:48], w[1, 2, 11, 64 + 8 * (5 ^ 3):64 + 8 * (5 ^ 3) + 8])


@pytest.mark.parametrize("cin,cout", [(20, 96), (32, 128), (8, 64), (13, 5), (3, 130), (64, 8), (128, 256)])
def test_pack_weights_f32_is_an_exact_split_and_permutation(cin, cout):
    """The f32 wgmma route's weights: hi the nearest tf32 of w (its low 13
    mantissa bits zero, ties away from zero), hi + lo == w bit for bit, and
    the packing, its 32-byte swizzle undone, every HWIO hi and lo value at
    its (tile, chunk, tap, row, k) with zeros past Cin and Cout."""
    g = torch.Generator().manual_seed(cin)
    w = torch.randn((5, 5, cin, cout), generator=g) * torch.logspace(-3, 3, cout)
    hi, lo = tf32_split(w)
    assert torch.equal(hi + lo, w)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert float(((w - hi).abs() / w.abs().clamp_min(1e-30)).max()) <= 2.0 ** -11
    assert torch.equal(tf32_split(torch.tensor([1 + 2.0 ** -11]))[0], torch.tensor([1 + 2.0 ** -10]))  # a tie, away
    p = pack_weights_f32(w)
    assert p.shape == f32_packed_shape(cin, cout) and p.is_contiguous()
    r, pos = torch.arange(64), torch.arange(2)
    un = torch.empty_like(p)
    un[:, :, :, :, r[:, None], pos[None, :] ^ ((r[:, None] >> 2) & 1)] = p
    tiles, chunks = p.shape[:2]
    back = un.permute(3, 2, 1, 5, 6, 0, 4).reshape(2, 5, 5, chunks * 8, tiles * 64)  # hl, ky, kx, c, n
    assert torch.equal(back[0, :, :, :cin, :cout], hi) and torch.equal(back[1, :, :, :cin, :cout], lo)
    assert not back[:, :, :, cin:].any() and not back[:, :, :, :, cout:].any()


def _unfragment(words, kdim, ndim, dtype):
    """Invert kernels/fused_wdsr_block.py::_fragments: float32 words of a
    (kdim, ndim) B operand in mma fragment order -> (hi, lo) for float32
    (the TF32 split) or (w, None) for bf16, each (kdim, ndim)."""
    if dtype == torch.float32:
        v = words.reshape(kdim // 8, ndim // 8, 8, 4, 2, 2)  # s, j, g, t, (hi, lo), e
        back = [v[..., i, :].permute(0, 3, 4, 1, 2).reshape(kdim, ndim) for i in (0, 1)]
        return back[0], back[1]
    v = words.contiguous().view(torch.bfloat16).reshape(kdim // 16, ndim // 8, 8, 4, 2, 2)  # s, j, g, t, h, e
    return v.permute(0, 4, 3, 5, 1, 2).reshape(kdim, ndim), None


@pytest.mark.parametrize("c,dtype", [(24, torch.float32), (13, torch.bfloat16)])
def test_wdsr_block_pack_weights_is_an_exact_pad_and_permutation(c, dtype):
    """B3's packed weights hold W1, W2, the nine W3 taps and the biases in mma
    fragment order, zero-padded to the kernel's widths: in float32 as a TF32
    split whose hi keeps no mantissa bit past TF32's and whose hi + lo is the
    weight exactly; in bf16 as the weights rounded to bf16."""
    from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import _widths, block_shape, pack_weights, packed_size

    c, e, m, k = block_shape(c)
    g = torch.Generator().manual_seed(c)
    w1, b1, w2, b2, w3, b3 = (torch.randn(s, generator=g) for s in ((c, e), (e,), (e, m), (m,), (k, k, m, c), (c,)))
    p = pack_weights(w1, b1, w2, b2, w3, b3, dtype)
    assert p.dtype == torch.float32 and p.is_contiguous() and p.numel() == packed_size(c, e, dtype)
    cw, kc, mk, ep = _widths(c, e, dtype)
    per = 2 if dtype == torch.float32 else 0.5  # words per weight
    mats = [(w1, kc, ep), (w2, ep, mk)] + [(w3.reshape(k * k, m, c)[i], mk, cw) for i in range(k * k)]
    at = 0
    for w, kdim, ndim in mats:
        n = int(kdim * ndim * per)
        hi, lo = _unfragment(p[at:at + n], kdim, ndim, dtype)
        at += n
        want = torch.zeros(kdim, ndim)
        want[: w.shape[0], : w.shape[1]] = w
        if dtype == torch.float32:
            assert torch.equal(hi.contiguous().view(torch.int32) & 0x1FFF, torch.zeros_like(hi, dtype=torch.int32))
            assert torch.equal(hi + lo, want)
            assert float((lo / want.abs().clamp_min(1e-30)).abs().max()) <= 2.0 ** -11
        else:
            assert torch.equal(hi, want.to(torch.bfloat16))
    for b, n in ((b1, ep), (b2, mk), (b3, cw)):
        assert torch.equal(p[at:at + n], torch.cat([b, torch.zeros(n - b.numel())]))
        at += n
    assert at == p.numel()


@pytest.mark.parametrize("cin,scale,dtype", [(24, 2, torch.float32), (13, 3, torch.bfloat16), (18, 4, torch.float32)])
def test_tail_skip_pack_weights_is_an_exact_pad_and_permutation(cin, scale, dtype):
    """B4's packed weights hold the body kernel as three row-contiguous K
    runs (row ky * run + kx * cp + c) over a halo of pixel stride cp, the
    skip kernel as five runs over a stride of 3 (float32) or 4 (bf16), and
    the bias, each zero
    past its values, in mma fragment order: in float32 as a TF32 split whose
    hi + lo is the weight exactly, in bf16 as the weights rounded to bf16.
    Read as the kernel reads them (each position's K run a contiguous slice
    of one halo row), they compute the plain version's tail."""
    from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
        _skip_plan,
        fused_conv_pixel_shuffle_skip_plain,
        pack_weights as pack_b4,
        packed_size,
    )

    cc = 3 * scale * scale
    g = torch.Generator().manual_seed(cin)
    kt, ks = torch.randn((3, 3, cin, cc), generator=g), torch.randn((5, 5, 3, cc), generator=g)
    b = torch.randn(cc, generator=g)
    p = pack_b4(kt, ks, b, dtype)
    assert p.dtype == torch.float32 and p.is_contiguous() and p.numel() == packed_size(cin, cc, dtype)
    cp, run, cp2, run2, npad = _skip_plan(cin, cc, dtype)
    assert cp >= cin and cp % 2 == 0 and cp2 >= 3 and npad % 16 == 0 and npad >= cc
    per = 2 if dtype == torch.float32 else 0.5  # words per weight
    mats = []
    at = 0
    for w, stride, r in ((kt, cp, run), (ks, cp2, run2)):
        k, c = w.shape[0], w.shape[2]
        n = int(k * r * npad * per)
        hi, lo = _unfragment(p[at:at + n], k * r, npad, dtype)
        at += n
        want = torch.zeros(k * r, npad)
        for ky in range(k):
            for kx in range(k):
                want[ky * r + kx * stride: ky * r + kx * stride + c, :cc] = w[ky, kx].to(dtype).float()
        if dtype == torch.float32:
            assert torch.equal(hi.contiguous().view(torch.int32) & 0x1FFF, torch.zeros_like(hi, dtype=torch.int32))
            assert torch.equal(hi + lo, want)
            mats.append(hi + lo)
        else:
            assert torch.equal(hi, want.to(torch.bfloat16))
            mats.append(hi.float())
    bias = b.to(dtype).float()
    assert torch.equal(p[at:], torch.cat([bias, torch.zeros(npad - cc)]))

    x = torch.randn((2, 5, 7, cin), generator=g).to(dtype)
    xs = torch.randn((2, 5, 7, 3), generator=g).to(dtype)
    acc = bias.new_zeros(2, 5, 7, npad) + torch.cat([bias, torch.zeros(npad - cc)])
    for inp, c, stride, r, k, mat in ((x, cin, cp, run, 3, mats[0]), (xs, 3, cp2, run2, 5, mats[1])):
        # the halo: pad k // 2, channels zero to the stride, and columns past
        # the image for the last position's run overshoot
        halo = torch.zeros(2, 5 + k - 1, 7 + k - 1 + -(-r // stride), stride)
        halo[:, k // 2: k // 2 + 5, k // 2: k // 2 + 7, :c] = inp.float()
        rows = halo.reshape(2, 5 + k - 1, -1)
        for ky in range(k):
            a = torch.stack([rows[:, ky: ky + 5, px * stride: px * stride + r] for px in range(7)], dim=2)
            acc += a @ mat[ky * r: (ky + 1) * r]
    y = torch.nn.functional.pixel_shuffle(acc[..., :cc].permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1)
    want = fused_conv_pixel_shuffle_skip_plain(x, kt, b, scale, xs, ks).float()
    assert float((y - want).abs().max()) <= (1e-4 if dtype == torch.float32 else 2.0 ** -6 * float(want.abs().max()))
