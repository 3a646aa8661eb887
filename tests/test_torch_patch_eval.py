"""Port parity for patch-tiled VSR eval (cli/test_vsr_by_patch.py) and its
analysis (analysis/patch_stats.py) against the JAX package's.

Both ``evaluate_by_patch``s take a forward function: both get the same cheap
one (a bilinear x4 upscale with a seeded per-channel gain), so no model is
compiled; the JAX side's metric, resize and variation statistics run under
jax.jit, compiled once per module and shape. float32 on the CPU.

Tolerances: the variation statistics 1e-5 relative (float32 sums in another
order), the PSNRs 1e-4 dB; patch order, padding and counts exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.analysis import patch_stats as j_patch_stats
from mobilesuperresolution_tpu.cli import test_vsr_by_patch as j_patch
from mobilesuperresolution_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from mobilesuperresolution_tpu_torch.analysis import patch_stats
from mobilesuperresolution_tpu_torch.cli import test_vsr_by_patch
from mobilesuperresolution_tpu_torch.ops.resize import resize_bilinear

torch.set_num_threads(2)
S = 4
GAIN = np.asarray([0.97, 1.02, 0.99], np.float32)


_J_TV = {"total_variation": jax.jit(j_patch.total_variation), "time_variation": jax.jit(j_patch.time_variation)}


@pytest.fixture(scope="module")
def jax_jitted():
    """The JAX module's metric, resize and variation statistics under
    jax.jit (eagerly, each op would compile on its own)."""
    names = ("psnr", "resize_bilinear", *_J_TV)
    saved = {n: getattr(j_patch, n) for n in names}
    j_patch.psnr = jax.jit(j_patch.psnr, static_argnames="shave")
    j_patch.resize_bilinear = jax.jit(j_patch.resize_bilinear, static_argnames=("out_hw", "align_corners"))
    for n, f in _J_TV.items():
        setattr(j_patch, n, f)
    yield
    for n, f in saved.items():
        setattr(j_patch, n, f)


def _clips(seed, n, t, h, w):
    rng = np.random.default_rng(seed)
    return [(f"clip{i}", rng.random((1, t, h, w, 3), np.float32), rng.random((1, t, S * h, S * w, 3), np.float32))
            for i in range(n)]


def _t_forward(x, oh, ow):
    return resize_bilinear(x, (oh, ow)) * torch.from_numpy(GAIN)


@jax.jit
def _j_up(x):
    n, t, h, w, c = x.shape
    return j_resize_bilinear(x, (S * h, S * w), align_corners=False) * jnp.asarray(GAIN)


def _j_forward(x, oh, ow):
    return _j_up(x)


@pytest.mark.parametrize("t", [1, 3])
def test_variation_statistics_match_jax(t):
    """total_variation (replicate pad) and time_variation (differences on
    both frames, doubled at the clip's edges) per (clip, frame)."""
    clip = np.random.default_rng(t).random((2, t, 9, 11, 3), np.float32)
    for ours, theirs in ((test_vsr_by_patch.total_variation, _J_TV["total_variation"]),
                         (test_vsr_by_patch.time_variation, _J_TV["time_variation"])):
        got = ours(torch.from_numpy(clip)).numpy()
        want = np.asarray(theirs(jnp.asarray(clip)))
        assert got.shape == want.shape == (2 * t,)
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("patch_batch,overlap", [(None, (4, 0)), (3, (4, 0)), (4, (2, 3))])
def test_evaluate_by_patch_matches_jax(jax_jitted, patch_batch, overlap):
    """The 4xN array of two clips of 3 frames of 40x44 LR, 16x16 patches:
    the same patches in the same raster order (a short last chunk padded by
    its last patch), TV rows within 1e-5, PSNRs within 1e-4 dB."""
    batches = _clips(0, 2, 3, 40, 44)
    got = test_vsr_by_patch.evaluate_by_patch(_t_forward, iter(batches), S, (16, 16), overlap, patch_batch)
    want = j_patch.evaluate_by_patch(_j_forward, iter(batches), S, (16, 16), overlap, patch_batch=patch_batch)
    positions = test_vsr_by_patch.patch_positions(40, 44, (16, 16), overlap)
    assert got.shape == want.shape == (4, 2 * len(positions) * 3)
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    np.testing.assert_allclose(got[2:], want[2:], rtol=0, atol=1e-4)
    assert np.isfinite(got).all() and (got[2] != got[3]).any()


def test_evaluate_by_patch_forward_calls():
    """One forward per chunk of patch_batch patches, each of exactly
    patch_batch patches (the last padded), and the output size of a patch."""
    calls = []

    def fwd(x, oh, ow):
        calls.append((tuple(x.shape), oh, ow))
        return _t_forward(x, oh, ow)

    test_vsr_by_patch.evaluate_by_patch(fwd, iter(_clips(1, 1, 2, 40, 44)), S, (16, 16), (4, 0), 4)
    n = len(test_vsr_by_patch.patch_positions(40, 44, (16, 16), (4, 0)))
    assert n == 6 and calls == [((4, 2, 16, 16, 3), 64, 64)] * 2


def test_patch_stats_match_jax(tmp_path):
    """load / summarize of a saved 4xN array equal the JAX package's, and a
    malformed array is refused."""
    rng = np.random.default_rng(3)
    arr = np.stack([rng.random(50) * 100, rng.random(50) * 10, 25 + rng.random(50) * 5, 24 + rng.random(50) * 5])
    np.save(tmp_path / "a.npy", arr)
    got = patch_stats.load_patch_stats(str(tmp_path / "a.npy"))
    want = j_patch_stats.load_patch_stats(str(tmp_path / "a.npy"))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    s_got, s_want = patch_stats.summarize_patch_stats(got, bins=5), j_patch_stats.summarize_patch_stats(want, bins=5)
    for key in ("space_var", "time_var"):
        for part in ("bin_edges", "mean_gain"):
            np.testing.assert_array_equal(s_got[key][part], s_want[key][part])
    for key in ("mean_psnr", "mean_bilinear_psnr", "mean_gain"):
        assert s_got[key] == s_want[key]
    np.save(tmp_path / "b.npy", arr[:3])
    with pytest.raises(ValueError, match="4, N"):
        patch_stats.load_patch_stats(str(tmp_path / "b.npy"))


def test_patch_eval_cli_refusals(tmp_path):
    """--chunk_frames raises ValueError as the JAX CLI does; --data_parallel
    names queue A8."""
    base = ["--job_dir", str(tmp_path), "--device", "cpu", "--dataset", "synthetic_vsr", "--eval_datasets",
            "synthetic_vsr"]
    with pytest.raises(ValueError, match="chunk_frames"):
        test_vsr_by_patch.main(base + ["--chunk_frames", "2"])
    with pytest.raises(NotImplementedError, match="A8"):
        test_vsr_by_patch.main(base + ["--data_parallel"])
