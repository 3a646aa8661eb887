"""Port parity for SpyNet and BasicVSR (float32 on the CPU, seeded random
weights in the JAX layout fed to both through the port's checkpoint bridge,
and the JAX init's layout checked against the bridge's), the
shipped basicvsr_x4 weights' PSNR through the port, and the port's guards:
no JAX import, CUDA by default.

Tolerance: 1e-4 absolute for whole models (the target for the port): the
float32 arithmetic is the same, summed in another order, and SpyNet's flows
feed bilinear warps, which pass small flow differences on.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.models import basicvsr as jb
from mobilesuperresolution_tpu.models import spynet as js
from mobilesuperresolution_tpu_torch.models import basicvsr as tb
from mobilesuperresolution_tpu_torch.models import get_vsr_model
from mobilesuperresolution_tpu_torch.models import spynet as ts
from mobilesuperresolution_tpu_torch.train.checkpoint import (
    jax_param_shapes,
    load_params_npz,
    random_jax_params,
)

torch.set_num_threads(2)
ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mobilesuperresolution_tpu_torch")


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(params):
    """The JAX package's flat-npz layout (train/checkpoint.py::save_params_npz)."""
    return {
        "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _tree(flat):
    """The flat layout back to a JAX params tree."""
    tree = {}
    for key, arr in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = jnp.asarray(arr)
    return tree


@pytest.mark.parametrize("hw", [(16, 24), (7, 9)], ids=["s2d", "odd_fallback"])
def test_spynet_basic_module_matches_jax(rng, hw):
    x = rng.standard_normal((2, *hw, 8)).astype(np.float32)
    jm = js.SpyNetBasicModule()
    tm = ts.SpyNetBasicModule()
    flat = random_jax_params(tm, seed=0)
    load_params_npz(tm, flat)
    want = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a))(_tree(flat), x))
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_spynet_matches_jax(rng):
    """70x90: not a multiple of 32, so the /32 resize and the flow rescale
    run; 96x96 pyramid levels are all even (s2d path)."""
    ref = rng.random((2, 70, 90, 3)).astype(np.float32)
    supp = np.roll(ref, (2, -3), axis=(1, 2)) * 0.9 + 0.05
    jm = js.SpyNet()
    tm = ts.SpyNet()
    flat = random_jax_params(tm, seed=3)
    load_params_npz(tm, flat)
    want = np.asarray(jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(_tree(flat), ref, supp))
    with torch.no_grad():
        got = tm(_t(ref), _t(supp)).numpy()
    assert got.shape == (2, 70, 90, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_flow_resize_helpers_match_jax(rng):
    x = rng.random((1, 2, 12, 20, 3)).astype(np.float32)
    assert ts.flow_downscale_hw(12, 20, 2) == js.flow_downscale_hw(12, 20, 2) == (6, 10)
    assert ts.flow_downscale_hw(12, 20, 1) == (12, 20)
    np.testing.assert_allclose(
        ts.downscale_frames(_t(x), 6, 10).numpy(), np.asarray(js.downscale_frames(jnp.asarray(x), 6, 10)), atol=1e-6
    )
    flow = rng.standard_normal((3, 6, 10, 2)).astype(np.float32)
    np.testing.assert_allclose(
        ts.upsample_flow(_t(flow), 12, 20).numpy(), np.asarray(js.upsample_flow(jnp.asarray(flow), 12, 20)), atol=1e-5
    )


def test_stack_directions_matches_jax(rng):
    x = rng.random((2, 3, 4, 5, 3)).astype(np.float32)
    ff = rng.random((2, 2, 4, 5, 2)).astype(np.float32)
    fb = rng.random((2, 2, 4, 5, 2)).astype(np.float32)
    for got, want in zip(
        tb.stack_directions(_t(x), _t(ff), _t(fb)),
        jb.stack_directions(jnp.asarray(x), jnp.asarray(ff), jnp.asarray(fb)),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def tiny_pair():
    """JAX BasicVSR nf=8, 1 block, x4, and the port, both on the same seeded
    random weights in the JAX layout (the bridge's, not a jitted JAX init:
    the same comparison without its compile)."""
    jm = jb.BasicVSR(num_feat=8, num_block=1, scale=4)
    x = np.random.default_rng(5).random((1, 3, 64, 96, 3)).astype(np.float32)
    tm = tb.BasicVSR(num_feat=8, num_block=1, scale=4)
    flat = random_jax_params(tm, seed=1)
    load_params_npz(tm, flat)
    return jm, _tree(flat), tm, x


def test_basicvsr_matches_jax(tiny_pair):
    jm, params, tm, x = tiny_pair
    want = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a, 256, 384))(params, x))
    with torch.inference_mode():
        got = tm(_t(x), 256, 384).numpy()
    assert got.shape == (1, 3, 256, 384, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_compute_flows_matches_jax(tiny_pair):
    jm, params, tm, x = tiny_pair
    spy = js.SpyNet()
    jf = jax.jit(lambda p, a: jb.compute_flows(lambda r, s: spy.apply({"params": p}, r, s), a))(
        params["spynet"], x
    )
    with torch.no_grad():
        tf = tb.compute_flows(tm.spynet, _t(x))
    for got, want in zip(tf, jf):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_shipped_basicvsr_weights_reproduce_psnr():
    """artifacts/convergence/basicvsr_x4 through the port, by the recipe of
    tests/test_convergence_artifacts.py (the JAX package's data and metric
    helpers make the eval set and score it)."""
    import json

    from mobilesuperresolution_tpu.data.imresize import imresize_np
    from mobilesuperresolution_tpu.data.synthetic import synthetic_video
    from mobilesuperresolution_tpu.metrics import psnr

    d = os.path.join(REPO, "artifacts", "convergence", "basicvsr_x4")
    with open(os.path.join(d, "report.json")) as f:
        report = json.load(f)
    cfg = report["config"]
    t, s, hw = cfg["t"], cfg["scale"], cfg["hw"]
    model = tb.BasicVSR(num_feat=cfg["num_feat"], num_block=cfg["num_block"], scale=s)
    load_params_npz(model, os.path.join(d, "weights", "models.npz"))
    hr = synthetic_video(300, t=t, hw=(hw * s, hw * s), step=cfg["step"], natural=True).astype(np.float32) / 255.0
    lr = np.stack([
        imresize_np(np.clip(f * 255.0, 0, 255).astype(np.uint8), scalar_scale=1.0 / s).astype(np.float32) / 255.0
        for f in hr
    ])
    with torch.inference_mode():
        sr = model(_t(lr[None]), hw * s, hw * s).numpy()
    p_sr = float(psnr(jnp.asarray(sr), jnp.asarray(hr[None]), shave=4)) / t
    np.testing.assert_allclose(p_sr, 25.2107, atol=0.05)
    np.testing.assert_allclose(p_sr, report["eval"]["PSNR"], atol=0.05)


def test_checkpoint_layout_matches_jax_full_width():
    """The full-width port model loads exactly the JAX model's keys and
    shapes, and random_jax_params fills every one of them."""
    jm = jb.BasicVSR(num_feat=24, num_block=8, scale=4)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, 256, 256), jax.random.key(0), jnp.zeros((1, 2, 64, 64, 3)))["params"]
    want = {k: tuple(v.shape) for k, v in _flat_shapes(shapes).items()}
    model = get_vsr_model("basic", device="cpu")
    assert jax_param_shapes(model) == want
    rnd = random_jax_params(model, seed=0)
    assert {k: v.shape for k, v in rnd.items()} == want
    assert rnd["conv_last/bias"].max() == 0 and 0 < np.abs(rnd["fusion/Conv_0/kernel"]).max() <= 1 / np.sqrt(48)


def _flat_shapes(tree):
    return {
        "/".join(str(getattr(p, "key", p)) for p in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_checkpoint_bridge_rejects_mismatch(tiny_pair):
    _, params, _, _ = tiny_pair
    flat = _flat(params)
    model = tb.BasicVSR(num_feat=8, num_block=1, scale=4)
    with pytest.raises(KeyError):
        load_params_npz(model, {k: v for k, v in flat.items() if k != "fusion/Conv_0/bias"})
    with pytest.raises(KeyError):
        load_params_npz(model, {**flat, "extra/kernel": np.zeros(1)})
    bad = dict(flat)
    bad["conv_last/kernel"] = np.zeros((3, 3, 16, 3), np.float32)
    with pytest.raises(ValueError):
        load_params_npz(model, bad)


def test_get_vsr_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_vsr_model("basic")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_vsr_model("basic", device="cuda")
    for kind in ("basic_origin", "basic_mv"):  # the types ported last default to CUDA too
        with pytest.raises(RuntimeError, match="CUDA"):
            get_vsr_model(kind)
    assert next(get_vsr_model("basic_mv", device="cpu").parameters()).device.type == "cpu"
    model = get_vsr_model("basic", compute_dtype=torch.bfloat16, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert model.spynet.level_0._s2d[0][0].dtype == torch.bfloat16


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "scripts", n) for n in os.listdir(os.path.join(REPO, "scripts"))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    # the NAS search slice's modules, the flow cache's, SISR training's,
    # checkpointing's and VSR training's, the VSR zoo's (all six types),
    # patch eval's and the video datasets' (REDS with motion vectors too),
    # the rest of NAS, the torch checkpoints', logging's and profiling's, and
    # the deployment slice's (int8, Q1, export, tiled eval, the ladder), the
    # parallel layer's and the native data cores' are among those checked
    rel = {os.path.relpath(f, REPO) for f in files}
    for mod in ("ops/ste", "kernels/fused_convsep", "nas/speed_estimator", "nas/speed_loss", "nas/search",
                "nas/artifact", "models/wdsr_nas", "train/state", "train/steps", "core/utils", "cli/search",
                "serve/flow_cache", "kernels/_autograd", "core/meters", "core/metrics_writer", "data/io_cache",
                "cli/pretrain", "cli/retrain_searched", "train/checkpoint", "train/preemption", "data/vsr",
                "data/reds", "data/synthetic", "cli/train_vsr", "cli/test_vsr", "cli/common_cli",
                "cli/test_vsr_by_patch", "analysis/patch_stats", "models/single_image", "models/naive_multi",
                "data/vimeo", "data/nemo", "data/yuv", "data/frame_utils", "models/mvvsr", "models/naive_multi_v1",
                "data/reds_with_mv", "core/msgpack_io", "nas/speed_model", "kernels/timing", "train/torch_convert",
                "core/logging_tool", "core/profiling", "cli/prepare_dataset", "ops/quant", "kernels/qconv_int8",
                "export/export", "cli/export", "train/eval_tiling", "analysis/approx_ladder", "core/maths",
                "parallel/halo", "parallel/mesh", "parallel/temporal", "core/native_path", "data/native_loader",
                "data/native_imresize"):
        assert os.path.join("mobilesuperresolution_tpu_torch", mod + ".py") in rel, mod
    for script in ("torch_search_profile.py", "torch_bench.py", "torch_train_h100_predictor.py",
                   "torch_repeat_first_phases.py"):
        assert os.path.join("scripts", script) in rel
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "msgpack", "mobilesuperresolution_tpu"), (path, mod)
