"""Port parity for SISR training: the autograd Functions of kernels B2, B3 and B4,
the SISR step in lockstep with the JAX package's make_sisr_step +
multistep_adam (BasicModel and ResultNet), and the two training entry points
(cli/pretrain.py, cli/retrain_searched.py). float32 on the CPU; both sides get
the same seeded weights through the checkpoint bridge (no JAX init).

Tolerances: bit-equal where both sides run the same PyTorch arithmetic (the
Functions against autograd through the plain versions on the CPU, the eval
of a model against a fresh copy of it); 2e-4 relative per-step loss over the
lockstep (Adam carries the summation-order noise of one step into the next,
so final weights are not compared: ROADMAP.md §C); 1e-6 relative for the
PSNR of one model evaluated twice.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.models.result_net import ResultNet as JResultNet
from mobilesuperresolution_tpu.models.wdsr_basic import BasicModel as JBasicModel
from mobilesuperresolution_tpu.train.state import TrainState
from mobilesuperresolution_tpu.train.state import multistep_adam as j_multistep_adam
from mobilesuperresolution_tpu.train.steps import make_sisr_step as j_make_sisr_step
from mobilesuperresolution_tpu_torch.cli import pretrain, retrain_searched
from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
    FusedConvPixelShuffleFn,
    FusedTailSkipFn,
    fused_conv_pixel_shuffle_plain,
    fused_conv_pixel_shuffle_skip_plain,
)
from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import FusedWdsrBlockFn, fused_wdsr_block_plain
from mobilesuperresolution_tpu_torch.models import BasicModel, ResultNet
from mobilesuperresolution_tpu_torch.nas.artifact import read_block_index
from mobilesuperresolution_tpu_torch.train.checkpoint import (
    jax_named_parameters,
    load_params_npz,
    random_jax_params,
)
from mobilesuperresolution_tpu_torch.train.state import multistep_adam
from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_INDEX = os.path.join(REPO, "artifacts", "search_depth_tpu", "block_index.txt")
RESULT_IDX = ((8, 6, 3), (8, 8, 5))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(flat):
    out = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        d = out
        for s in scope:
            d = d.setdefault(s, {})
        d[leaf] = jnp.asarray(v)
    return out


def _jax_shapes(jm, x):
    """{flat key: shape} of the JAX model's params, without compiling its init."""
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))["params"]
    return {"/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _models(kind):
    if kind == "basic":
        return JBasicModel(num_blocks=2, num_residual_units=8, scale=2), BasicModel(2, 8, 2)
    return JResultNet(scale=2, idx=RESULT_IDX), ResultNet(2, RESULT_IDX)


def _grads(fn, inputs, need):
    """The output and the gradients of sum(fn(*inputs) * cot) for the inputs
    flagged in ``need``."""
    leaves = [t.clone().requires_grad_(n) for t, n in zip(inputs, need)]
    y = fn(*leaves)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(y.shape)).astype(np.float32))
    y.backward(cot)
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("which", ["b2", "b3", "b4"])
def test_autograd_functions_match_plain_gradients(rng, which):
    """Each Function's forward and gradients equal autograd through its plain
    version; an input that needs no gradient gets none. B2 at BasicVSR's
    tail form (2x2, pad ((1, 2), (1, 2)), s 4, cropped)."""
    if which == "b2":
        c, s = 8, 4
        cc = 3 * s * s
        inputs = [rng.standard_normal((2, 5, 6, c)), rng.standard_normal((2, 2, c, cc)) / np.sqrt(4 * c),
                  rng.standard_normal(cc) * 0.1]
        geometry = (s, ((1, 2), (1, 2)), (21, 25))
        fn = lambda *a: FusedConvPixelShuffleFn.apply(*a, *geometry)  # noqa: E731
        plain = lambda *a: fused_conv_pixel_shuffle_plain(*a, *geometry)  # noqa: E731
    elif which == "b3":
        c, e, m = 8, 48, 6
        inputs = [rng.standard_normal((2, 7, 9, c)), rng.standard_normal((c, e)) / np.sqrt(c),
                  rng.standard_normal(e) * 0.1, rng.standard_normal((e, m)) / np.sqrt(e),
                  rng.standard_normal(m) * 0.1, rng.standard_normal((3, 3, m, c)) / np.sqrt(9 * m),
                  rng.standard_normal(c) * 0.1]
        fn, plain = FusedWdsrBlockFn.apply, fused_wdsr_block_plain
    else:
        c, s = 8, 3
        cc = 3 * s * s
        inputs = [rng.standard_normal((2, 5, 6, c)), rng.standard_normal((3, 3, c, cc)) / np.sqrt(9 * c),
                  rng.standard_normal(cc) * 0.1, rng.standard_normal((2, 5, 6, 3)),
                  rng.standard_normal((5, 5, 3, cc)) / np.sqrt(75)]
        fn = lambda *a: FusedTailSkipFn.apply(*a, s)  # noqa: E731
        plain = lambda x, k, b, xs, ks: fused_conv_pixel_shuffle_skip_plain(x, k, b, s, xs, ks)  # noqa: E731
    inputs = [_t(a.astype(np.float32)) for a in inputs]
    for need in ([True] * len(inputs), [i % 2 == 1 for i in range(len(inputs))]):
        y, g = _grads(fn, inputs, need)
        y_want, g_want = _grads(plain, inputs, need)
        torch.testing.assert_close(y, y_want, rtol=0, atol=0)
        for i, (got, want) in enumerate(zip(g, g_want)):
            assert (got is None) == (not need[i]), i
            if got is not None:
                torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["basic", "result_net"])
def test_sisr_lockstep_matches_jax(kind):
    """Six SISR steps against the JAX step with multistep_adam, crossing both
    LR milestones; the fourth batch holds a NaN, which both sides skip (no
    parameter, moment or schedule count moves). Per-step losses agree."""
    bs, hw = 3, 10
    spe, epochs, lr = 2, 3, 1e-2  # milestones [1, 2] epochs: boundaries at counts 2 and 4
    jm, m = _models(kind)
    flat = random_jax_params(m, seed=4)
    bias = np.random.default_rng(4)
    for k in flat:  # non-zero biases, so their gradients count
        if k.endswith("/b"):
            flat[k] = (bias.standard_normal(flat[k].shape) * 0.05).astype(np.float32)
    load_params_npz(m, flat)
    m.train()
    params = _tree(flat)
    tx = j_multistep_adam(lr, spe, epochs)
    state = TrainState(step=0, params=params, opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
    jstep = j_make_sisr_step(state)
    opt = multistep_adam(jax_named_parameters(m), lr, spe, epochs)
    tstep = make_sisr_step(m, opt)

    data = np.random.default_rng(7)
    for i in range(6):
        lr_img = data.random((bs, hw, hw, 3), np.float32)
        hr_img = data.random((bs, 2 * hw, 2 * hw, 3), np.float32)
        if i == 3:
            lr_img[1, 2, 3, 0] = np.nan
        state, jmet = jstep(state, (jnp.asarray(lr_img), jnp.asarray(hr_img)))
        tmet = tstep((_t(lr_img), _t(hr_img)))
        assert float(tmet["skipped"]) == float(jmet["skipped"]) == float(i == 3)
        if i == 3:
            continue
        for key in ("loss", "l1"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=2e-4, err_msg=f"step {i} {key}")
    assert opt.applied == 5 and int(state.step) == 6


@pytest.mark.parametrize("cli", ["pretrain", "retrain_searched"])
def test_training_cli_on_cpu(tmp_path, cli):
    """One tiny epoch of each training entry point on synthetic_isr: finite
    losses, a metrics.jsonl, and weights/models.npz with the JAX model's keys
    and shapes. The epoch's eval ran on the trained weights (prepare() after
    the optimizer steps): a fresh model loaded from the npz scores the same
    PSNR through ``--eval_only --eval_model``, and the initial weights
    another."""
    argv = ["--job_dir", str(tmp_path), "--device", "cpu", "--dataset", "synthetic_isr", "--eval_datasets",
            "synthetic_isr", "--epochs", "1", "--lr_patch_size", "8", "--train_batch_size", "4",
            "--num_patches", "1", "--learning_rate", "1e-2"]
    if cli == "pretrain":
        argv += ["--num_blocks", "2", "--num_residual_units", "8"]
        out = pretrain.main(argv)
        jm = JBasicModel(num_blocks=2, num_residual_units=8, scale=2)
    else:
        argv += ["--block_index", BLOCK_INDEX]
        out = retrain_searched.main(argv)
        jm = JResultNet(scale=2, idx=tuple(map(tuple, read_block_index(BLOCK_INDEX)[1])))
    assert (out["train_forwards"], out["eval_images"]) == (2, 8)
    assert all(np.isfinite(s["loss"]) and s["skipped"] == 0 for s in out["steps"])
    assert os.path.exists(os.path.join(tmp_path, "metrics.jsonl"))
    npz = np.load(os.path.join(tmp_path, "weights", "models.npz"))
    assert {k: npz[k].shape for k in npz.files} == _jax_shapes(jm, np.zeros((1, 8, 8, 3), np.float32))

    main = pretrain.main if cli == "pretrain" else retrain_searched.main
    initial = main(argv + ["--eval_only"])["synthetic_isr"]["PSNR"]  # the same seeded weights
    path = os.path.join(tmp_path, "weights", "models.npz")
    trained = main(argv + ["--eval_only", "--eval_model", path])["synthetic_isr"]["PSNR"]
    np.testing.assert_allclose(out["eval"][-1]["synthetic_isr"]["PSNR"], trained, rtol=1e-6)
    assert abs(trained - initial) > 1e-4


@pytest.mark.parametrize("compress", [1, 0])
def test_div2k_reads_through_the_cache_as_jax(tmp_path, compress):
    """DIV2K training reads its files through the decoded-image cache under
    --cache_dir (``div2k_train``, deflated or raw by --cache_compress): the
    batches equal the JAX package's through its own cache, and each
    package's cache reads the entries the other wrote."""
    from types import SimpleNamespace

    from PIL import Image

    from mobilesuperresolution_tpu.data import div2k as jdiv2k
    from mobilesuperresolution_tpu.data import isr as jisr
    from mobilesuperresolution_tpu.data.io_cache import ArrayCache as JArrayCache
    from mobilesuperresolution_tpu_torch.core import modes
    from mobilesuperresolution_tpu_torch.data import get_dataset_module
    from mobilesuperresolution_tpu_torch.data import isr as tisr
    from mobilesuperresolution_tpu_torch.data.io_cache import ArrayCache
    from mobilesuperresolution_tpu_torch.data.synthetic import synthetic_image

    d = tmp_path / "DIV2K" / "DIV2K_train_HR"
    d.mkdir(parents=True)
    imgs = [synthetic_image(40 + i, (30, 34)) for i in range(2)]
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(d / f"{i:04d}.png")

    def params(cache):
        return SimpleNamespace(scale=2, lr_patch_size=6, ignored_boundary_size=2, num_patches=3, seed=0,
                               data_dir=str(tmp_path), cache_dir=str(tmp_path / cache), cache_compress=compress)

    tds = get_dataset_module("div2k").get_dataset(modes.TRAIN, params("port"))
    jds = jdiv2k.get_dataset(modes.TRAIN, params("jax"))
    ext = ".npz" if compress else ".npy"
    assert sorted(os.listdir(tmp_path / "port" / "div2k_train")) == [f"000{i}.png{ext}" for i in range(2)]
    for g, w in zip(tisr.batch_iterator(tds, 4, shuffle=True, seed=2), jisr._batches(jds, 4, True, 2, False)):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    for i, img in enumerate(imgs):
        key = f"000{i}.png"
        np.testing.assert_array_equal(JArrayCache(str(tmp_path / "port" / "div2k_train")).get(key), img)
        np.testing.assert_array_equal(ArrayCache(str(tmp_path / "jax" / "div2k_train")).get(key), img)
