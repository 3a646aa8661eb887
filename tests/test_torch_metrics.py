"""Port parity for the SISR slice's host side: metrics (psnr, psnr_y, ssim,
ssim_np) against the JAX package and the independent goldens in
tests/golden/metric_goldens.npz, the MATLAB-exact imresize against
tests/golden/imresize_golden.npz, the eval harness (image and video
branches) against the JAX ``evaluate``, and the SISR datasets against the
JAX package's items.

Tolerances: the goldens' own (tests/test_metrics.py holds the JAX metrics to
3e-5 SSIM and 2e-3 dB); 1e-4 between the two float32 metric paths (means
over thousands of pixels, reduced in another order); imresize and the
dataset items exact (same float64 / uint8 arithmetic).

The JAX metrics run jitted here (one compile per shape instead of one per
primitive and shape when run eagerly: four times faster on the CPU), in
the eval harness too; the values are the same functions'.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu import metrics as j_metrics
from mobilesuperresolution_tpu.data import synthetic as jsyn
from mobilesuperresolution_tpu.train import evaluate as j_evaluate_module
from mobilesuperresolution_tpu.train.evaluate import evaluate as j_evaluate
from mobilesuperresolution_tpu_torch import metrics as tm
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data import synthetic as tsyn
from mobilesuperresolution_tpu_torch.data.imresize import convert_double_to_byte, imresize_np
from mobilesuperresolution_tpu_torch.data.isr import batch_iterator
from mobilesuperresolution_tpu_torch.train.evaluate import evaluate as t_evaluate
from mobilesuperresolution_tpu_torch.train.losses import charbonnier_loss

torch.set_num_threads(2)
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
jm = SimpleNamespace(**{n: jax.jit(getattr(j_metrics, n), static_argnames="shave")
                        for n in ("psnr", "psnr_y", "ssim")})


@pytest.fixture(scope="module")
def golden_pairs():
    sys.path.insert(0, GOLDEN_DIR)
    try:
        from make_metric_goldens import make_pairs
    finally:
        sys.path.pop(0)
    return make_pairs(), dict(np.load(os.path.join(GOLDEN_DIR, "metric_goldens.npz")))


@pytest.mark.parametrize("shave", [4, 8])
def test_metrics_match_goldens_and_jax(golden_pairs, shave):
    pairs, goldens = golden_pairs
    for name, (sr, hr) in pairs.items():
        s, h = torch.from_numpy(np.asarray(sr, np.float32)), torch.from_numpy(np.asarray(hr, np.float32))
        got = {
            "psnr": float(tm.psnr(s[None], h[None], shave=shave)),
            "psnr_y": float(tm.psnr_y(s[None], h[None], shave=shave)),
            "ssim": float(tm.ssim(s, h, shave=shave)),
        }
        for key, tol in (("psnr", 2e-3), ("psnr_y", 2e-3), ("ssim", 3e-5)):
            assert abs(got[key] - float(goldens[f"{name}_{key}_s{shave}"])) < tol, (name, key)
        js, jh = jnp.asarray(s.numpy()), jnp.asarray(h.numpy())
        want = {
            "psnr": float(jm.psnr(js[None], jh[None], shave=shave)),
            "psnr_y": float(jm.psnr_y(js[None], jh[None], shave=shave)),
            "ssim": float(jm.ssim(js, jh, shave=shave)),
        }
        for key in got:
            assert abs(got[key] - want[key]) < 1e-4, (name, key, got[key], want[key])
        assert abs(tm.ssim_np(sr, hr, shave) - float(goldens[f"{name}_ssim_s{shave}"])) < 1e-9


def test_batched_metrics_and_loss_match_jax(rng):
    """Leading axes (batch, batch x time) return per-image sums; the SSIM
    stays <= 1 on a near-identical pair (the centered float32 form)."""
    hr = rng.random((2, 3, 40, 36, 3)).astype(np.float32)
    sr = np.clip(hr + 0.02 * rng.standard_normal(hr.shape), 0, 1).astype(np.float32)
    t_sr, t_hr = torch.from_numpy(sr), torch.from_numpy(hr)
    for fn_t, fn_j in ((tm.psnr, jm.psnr), (tm.psnr_y, jm.psnr_y), (tm.ssim, jm.ssim)):
        for a, b in ((t_sr, t_hr), (t_sr[0], t_hr[0])):
            want = float(fn_j(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
            assert abs(float(fn_t(a, b)) - want) < 1e-4 * max(1.0, abs(want))
    from mobilesuperresolution_tpu.train.losses import charbonnier_loss as j_charb

    np.testing.assert_allclose(float(charbonnier_loss(t_sr, t_hr)), float(j_charb(jnp.asarray(sr), jnp.asarray(hr))), rtol=1e-6)
    near = np.clip(hr[0, 0] + 1e-3 * rng.standard_normal(hr[0, 0].shape), 0, 1).astype(np.float32)
    assert float(tm.ssim(torch.from_numpy(near), t_hr[0, 0])) <= 1.0 + 1e-6
    on_grid = np.round(hr[0] * 255) / 255
    assert tm.ssim_np(on_grid, on_grid) == pytest.approx(3.0, abs=1e-9)


def test_imresize_matches_goldens():
    g = np.load(os.path.join(GOLDEN_DIR, "imresize_golden.npz"))
    for s in (2, 3, 4):
        np.testing.assert_array_equal(imresize_np(g["img_u8"], scalar_scale=1 / s), g[f"u8_down_x{s}"])
    np.testing.assert_allclose(imresize_np(g["img_f"], scalar_scale=0.5), g["f_down_x2"], atol=1e-12)
    np.testing.assert_allclose(imresize_np(g["img_f"], scalar_scale=2.0), g["f_up_x2"], atol=1e-12)
    np.testing.assert_array_equal(imresize_np(g["img_g"], output_shape=(23, 37)), g["u8_gray_shape"])
    np.testing.assert_array_equal(imresize_np(g["img_e"], scalar_scale=0.25), g["u8_even_x4"])
    assert convert_double_to_byte(np.array([-0.1, 0.5, 1.2])).tolist() == [0, 128, 255]


@pytest.mark.parametrize("scale", [2, 3])
def test_synthetic_isr_items_match_jax(scale):
    """Same names, LR and HR arrays as the JAX dataset's eval batches (whose
    degradation is the native core, bit-identical to the numpy path); odd
    sizes, so the HR crop to a multiple of the scale counts."""
    p = SimpleNamespace(scale=scale, seed=0)
    tds = tsyn.SyntheticISRDataset(modes.EVAL, p, num_images=2, hw=(31, 35))
    jds = jsyn.SyntheticISRDataset(modes.EVAL, p, num_images=2, hw=(31, 35))
    assert len(tds) == len(jds)
    from mobilesuperresolution_tpu.data.isr import batch_iterator as j_batches

    got = list(batch_iterator(tds))
    want = list(j_batches(jds, 1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[0][2].shape == (1, 31 - 31 % scale, 35 - 35 % scale, 3)
    np.testing.assert_array_equal(tsyn.synthetic_natural_image(5, (20, 24)), jsyn.synthetic_natural_image(5, (20, 24)))
    # the TRAIN half (tests/test_torch_nas.py holds its items to JAX's)
    p.num_patches = 3
    assert len(tsyn.SyntheticISRDataset(modes.TRAIN, p, num_images=2, hw=(31, 35))) == 6


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
def test_evaluate_matches_jax(rng, video, tmp_path, monkeypatch):
    for name in ("psnr", "psnr_y", "ssim"):
        monkeypatch.setattr(j_evaluate_module, name, getattr(jm, name))
    monkeypatch.setattr(j_evaluate_module, "charbonnier_loss", jax.jit(j_evaluate_module.charbonnier_loss))
    monkeypatch.setattr(j_evaluate_module, "resize_bilinear",
                        jax.jit(j_evaluate_module.resize_bilinear, static_argnames=("out_hw", "align_corners")))
    scale = 2
    lead = (1, 3) if video else (1,)
    batches = []
    for i in range(2):
        hr = rng.random(lead + (28 + 2 * i, 32, 3)).astype(np.float32)
        lr = hr[..., ::scale, ::scale, :].copy()
        batches.append((f"item{i}", lr, hr))
    srs = [np.clip(b[2] + 0.05 * rng.standard_normal(b[2].shape), 0, 1).astype(np.float32) for b in batches]
    got = t_evaluate(lambda lr, oh, ow, it=iter(srs): torch.from_numpy(next(it)), iter(batches), scale,
                     job_dir=str(tmp_path), save=True).as_dict()
    want = j_evaluate(lambda lr, oh, ow, it=iter(srs): jnp.asarray(next(it)), iter(batches), scale).as_dict()
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])
    host = t_evaluate(lambda lr, oh, ow, it=iter(srs): torch.from_numpy(next(it)), iter(batches), scale,
                      ssim_on_host=True).as_dict()
    assert abs(host["SSIM"] - got["SSIM"]) < 1e-4
    saved = sorted(os.listdir(os.path.join(tmp_path, "eval", "eval")))
    assert saved == ([f"item{i}{t:03d}.png" for i in range(2) for t in range(3)] if video else ["item0.png", "item1.png"])
