"""Port parity for the SISR slice: WNConv, the plain versions of kernels B3
(fused WDSR-B block) and B4 (WDSR tail with its 5x5 skip), BasicModel at
x2 and x4, ResultNet, the shipped wdsr_b_x2 / result_net_x2 weights through
the port's evaluate, and the eval CLI. float32 on the CPU, the same weights
on both sides: the bridge's seeded ones, whose keys and shapes are checked
against the JAX ``model.init``'s (no JAX init is compiled).

Tolerances: 1e-5 absolute for single layers (the same float32 arithmetic
summed in another order, at most a few hundred terms); 1e-5 of the output
range for whole models (16-block residual chains grow the range past 1);
1e-4 against the Pallas kernel in interpret mode, as tests/test_kernels.py
holds that kernel to XLA; 0.05 dB for the shipped weights' PSNR, as
tests/test_convergence_artifacts.py holds the JAX package.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.kernels.fused_wdsr_block import fused_wdsr_block as j_block_kernel
from mobilesuperresolution_tpu.models.result_net import ResultNet as JResultNet
from mobilesuperresolution_tpu.models.wdsr_basic import BasicBlock as JBasicBlock
from mobilesuperresolution_tpu.models.wdsr_basic import BasicModel as JBasicModel
from mobilesuperresolution_tpu.ops import layers as jl
from mobilesuperresolution_tpu_torch.cli import pretrain
from mobilesuperresolution_tpu_torch.kernels.fused_tail import (
    fused_conv_pixel_shuffle_skip,
    fused_conv_pixel_shuffle_skip_plain,
)
from mobilesuperresolution_tpu_torch.kernels.fused_wdsr_block import fused_wdsr_block, fused_wdsr_block_plain
from mobilesuperresolution_tpu_torch.models import BasicModel, ResultNet, get_model
from mobilesuperresolution_tpu_torch.models import wdsr_basic as tw
from mobilesuperresolution_tpu_torch.ops import layers as tl
from mobilesuperresolution_tpu_torch.train.checkpoint import jax_param_shapes, load_params_npz, random_jax_params

torch.set_num_threads(2)
ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONV = os.path.join(REPO, "artifacts", "convergence")


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(params, leaf_fn=np.asarray):
    """The JAX package's flat-npz layout (train/checkpoint.py::save_params_npz)."""
    return {
        "/".join(str(getattr(p, "key", p)) for p in path): leaf_fn(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _init(module, twin, x):
    """Params for the JAX ``module``: the bridge's seeded weights of its port
    ``twin`` (the JAX initializers' families), after checking their keys and
    shapes against ``module.init``'s (``jax.eval_shape``: traced, not
    compiled)."""
    flat = random_jax_params(twin, seed=0)
    shapes = _flat(jax.eval_shape(module.init, jax.random.key(0), jnp.asarray(x))["params"], lambda a: tuple(a.shape))
    assert {k: v.shape for k, v in flat.items()} == shapes
    out = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        d = out
        for sc in scope:
            d = d.setdefault(sc, {})
        d[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("g_init", [2.0, None])
def test_wnconv_matches_jax(rng, k, g_init):
    x = rng.standard_normal((2, 9, 7, 6)).astype(np.float32)
    jm = jl.WNConv(5, k, g_init=g_init)
    tm = tl.WNConv(6, 5, k, g_init=g_init)
    p = _init(jm, tm, x)
    # a non-trivial g and bias, so the weight norm and the bias both count
    p = {"v": p["v"], "g": p["g"] * 1.5 + 0.1, "b": jnp.asarray(rng.standard_normal(5), jnp.float32)}
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    load_params_npz(tm, _flat(p))
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(x)).numpy(), want, atol=ATOL)
    # the bridge's random init follows the JAX init rule for g
    rnd = random_jax_params(tm, seed=3)
    v = rnd["v"].astype(np.float64)
    want_g = np.sqrt((v * v).sum(axis=(0, 1, 2))) if g_init is None else np.full(5, g_init)
    np.testing.assert_allclose(rnd["g"], want_g, rtol=1e-6)
    assert rnd["b"].max() == 0 and 0 < np.abs(v).max() <= 1 / np.sqrt(k * k * 6)


def _block_weights(rng, c, e, m, k=3):
    def u(shape, fan):
        return (rng.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)

    return (u((c, e), c), u((e,), 4), u((e, m), e), u((m,), 4), u((k, k, m, c), k * k * m), u((c,), 4))


def test_fused_wdsr_block_plain_matches_pallas_interpret(rng):
    """H a multiple of the Pallas row tile (4); biases non-zero, so the
    border ring checks that h2 is zero-padded after the 1x1 chain."""
    x = rng.standard_normal((2, 8, 6, 8)).astype(np.float32)
    ws = _block_weights(rng, 8, 48, 6)
    want = np.asarray(j_block_kernel(jnp.asarray(x), *map(jnp.asarray, ws), tile=4, interpret=True))
    got = fused_wdsr_block(_t(x), *map(_t, ws))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), fused_wdsr_block_plain(_t(x), *map(_t, ws)).numpy())


def test_basic_block_matches_jax(rng):
    """The port's BasicBlock (B3 with weight-normed weights) against the JAX
    BasicBlock (three XLA WNConvs) at 24 residual units, on a ragged 7x5 map;
    1e-5 of the output range (~20 here)."""
    x = rng.standard_normal((1, 7, 5, 24)).astype(np.float32)
    jm = JBasicBlock(24, 3, 0.25)
    tm = tw.BasicBlock(24, 3, 0.25)
    p = _init(jm, tm, x)
    p = jax.tree_util.tree_map(lambda a: a + 0.05, p)  # non-zero biases
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    load_params_npz(tm, _flat(p))
    assert [tuple(w.shape) for w in tm._weights] == [(24, 144), (144,), (144, 20), (20,), (3, 3, 20, 24), (24,)]
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(x)).numpy(), want, atol=ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("cin,scale", [(24, 2), (18, 3), (32, 4)])
def test_fused_tail_skip_plain_matches_jax_tail(rng, cin, scale):
    """B4 against the JAX models' tail math: depth_to_space(conv3x3(y) +
    conv5x5(x) + biases)."""
    cc = 3 * scale * scale
    y = rng.standard_normal((2, 6, 9, cin)).astype(np.float32)
    x = rng.standard_normal((2, 6, 9, 3)).astype(np.float32)
    kt = (rng.standard_normal((3, 3, cin, cc)) * 0.1).astype(np.float32)
    ks = (rng.standard_normal((5, 5, 3, cc)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cc).astype(np.float32)

    def conv(a, w):
        return jax.lax.conv_general_dilated(
            jnp.asarray(a), jnp.asarray(w), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
        )

    want = np.asarray(jl.depth_to_space(conv(y, kt) + conv(x, ks) + b, scale))
    got = fused_conv_pixel_shuffle_skip(_t(y), _t(kt), _t(b), scale, _t(x), _t(ks))
    assert got.shape == (2, 6 * scale, 9 * scale, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(), fused_conv_pixel_shuffle_skip_plain(_t(y), _t(kt), _t(b), scale, _t(x), _t(ks)).numpy())


def _model_pair(jm, tm, x, seed):
    """Load seeded random JAX-layout weights (non-zero biases) into both."""
    flat = random_jax_params(tm, seed=seed)
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("/b"):
            flat[k] = (rng.standard_normal(flat[k].shape) * 0.05).astype(np.float32)
    load_params_npz(tm, flat)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))["params"]
    assert jax_param_shapes(tm) == _flat(shapes, lambda leaf: tuple(leaf.shape))
    tree = {}
    for key, arr in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = jnp.asarray(arr)
    want = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a))(tree, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm(_t(x)).numpy()
    return got, want


@pytest.mark.parametrize("scale", [2, 4])
def test_basic_model_matches_jax(rng, scale):
    x = rng.random((1, 10, 13, 3)).astype(np.float32)
    got, want = _model_pair(JBasicModel(num_blocks=3, num_residual_units=24, scale=scale),
                            BasicModel(3, 24, scale), x, seed=scale)
    assert got.shape == (1, 10 * scale, 13 * scale, 3)
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())))


def test_result_net_matches_jax(rng):
    idx = ((18, 16, 5), (18, 18, 3), (18, 15, 7))
    x = rng.random((2, 9, 11, 3)).astype(np.float32)
    got, want = _model_pair(JResultNet(scale=2, idx=idx), ResultNet(2, idx), x, seed=7)
    assert got.shape == (2, 18, 22, 3)
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())))


def _held_out_batches():
    """The convergence artifacts' held-out set (tests/test_convergence_artifacts.py
    recipe) made by the port's own data helpers."""
    from mobilesuperresolution_tpu_torch.data.imresize import imresize_np
    from mobilesuperresolution_tpu_torch.data.synthetic import synthetic_natural_image

    for s in range(50, 54):
        u8 = synthetic_natural_image(s, (96, 96))
        yield f"eval{s}", (imresize_np(u8, scalar_scale=0.5).astype(np.float32) / 255.0)[None], \
            (u8.astype(np.float32) / 255.0)[None]


@pytest.mark.parametrize("run", ["wdsr_b_x2", "result_net_x2"])
def test_shipped_sisr_weights_reproduce_psnr(run):
    from mobilesuperresolution_tpu_torch.train.evaluate import evaluate

    d = os.path.join(CONV, run)
    with open(os.path.join(d, "report.json")) as f:
        report = json.load(f)
    cfg = report["config"]
    if run == "wdsr_b_x2":
        model = BasicModel(cfg["num_blocks"], cfg["num_residual_units"], cfg["scale"])
    else:
        model = ResultNet(cfg["scale"], cfg["idx"])
    load_params_npz(model, os.path.join(d, "weights", "models.npz"))
    with torch.inference_mode():
        res = evaluate(lambda lr, oh, ow: model(lr), _held_out_batches(), scale=cfg["scale"]).as_dict()
    np.testing.assert_allclose(res["PSNR"], {"wdsr_b_x2": 30.2841, "result_net_x2": 30.1743}[run], atol=0.05)
    np.testing.assert_allclose(res["PSNR"], report["eval"]["PSNR"], atol=0.05)
    np.testing.assert_allclose(res["SSIM"], report["eval"]["SSIM"], atol=0.005)


def test_pretrain_eval_only_on_cpu(tmp_path):
    """The entry point end to end: 8-block WDSR-B x2 from the shipped npz over
    synthetic_isr, finite metrics above the bilinear baseline's floor; the
    caller's TF32 flags are as they were after the call."""
    argv = ["--job_dir", str(tmp_path), "--eval_only", "--device", "cpu", "--dataset", "synthetic_isr",
            "--eval_datasets", "synthetic_isr", "--num_blocks", "8",
            "--eval_model", os.path.join(CONV, "wdsr_b_x2", "weights", "models.npz")]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    res = pretrain.main(argv)["synthetic_isr"]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == tf32
    assert all(np.isfinite(v) for v in res.values())
    assert res["PSNR"] > res["bilinear_PSNR"] and 0 < res["SSIM"] <= 1


def test_pretrain_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Training and resuming run (tests/test_torch_train.py,
    tests/test_torch_resume.py); the sharding and multi-process flags are
    not parsed, the supernet does not pretrain, and int8 raises without
    --eval_only and for the supernet, with the JAX package's messages
    (--eval_tile runs: tests/test_torch_export.py)."""
    base = ["--job_dir", str(tmp_path), "--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr",
            "--num_blocks", "1"]
    for flag in (["--spatial_shards", "2"], ["--distributed"]):
        with pytest.raises(SystemExit):
            pretrain.main(base + ["--device", "cpu"] + flag)
    with pytest.raises(ValueError, match="BASIC_MODEL only"):
        pretrain.main(base + ["--device", "cpu", "--model_type", "NAS_MODEL"])
    with pytest.raises(SystemExit, match="--quantize is inference-only: add --eval_only"):
        pretrain.main(base + ["--device", "cpu", "--quantize", "int8"])
    with pytest.raises(KeyError, match="unknown SISR model_type"):
        get_model(SimpleNamespace(model_type="WDSR_A"), device="cpu")
    with pytest.raises(ValueError, match="the NAS supernet trains and must stay float"):
        get_model(SimpleNamespace(model_type="NAS_MODEL", quantize="int8"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.main(base + ["--eval_only"])
    params = SimpleNamespace(model_type="BASIC_MODEL", num_blocks=2, num_residual_units=24, scale=2, bf16=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(params)
    model = get_model(params, device="cpu")
    assert model.BasicBlock_1._weights[0].dtype == torch.float32
    assert model.WNConv_0._w.dtype == torch.bfloat16
