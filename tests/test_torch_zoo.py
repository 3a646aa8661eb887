"""Port parity for the VSR zoo's 'single' (models/single_image.py) and 'multi'
(models/naive_multi.py): the forward and a 3-step training lockstep against
the JAX package's models and make_vsr_step, the checkpoint bridge against
the JAX init's parameter tree, the registry's refusals, and the entry points
(cli.train_vsr, cli.test_vsr, cli.test_vsr_by_patch, cli.serve) end to end
on the CPU.

Both sides get the same seeded weights through the bridge
(``random_jax_params``), so no JAX init is compiled; the JAX tree is checked
with ``jax.eval_shape``, which only traces. JAX compiles one forward and one
training step per model type, at a tiny size ('single' 8 channels and 2
blocks, 'multi' the artifact [[8, 8, 3], [8, 6, 5]]; 3 frames of 16x16, x4).

Tolerances: the f32 forward within 1e-5 of the largest output; per-step
losses 2e-4 relative (Adam carries one step's summation-order noise into the
next), the final trainable weights within the Adam drift bound, the frozen
flownet bit-equal on both sides.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.cli.train_vsr import spynet_frozen_mask as j_spynet_frozen_mask
from mobilesuperresolution_tpu.models import get_vsr_model as j_get_vsr_model
from mobilesuperresolution_tpu.models.naive_multi import NaiveMultiModel as JNaiveMultiModel
from mobilesuperresolution_tpu.models.single_image import SingleImageModel as JSingleImageModel
from mobilesuperresolution_tpu.train.state import TrainState
from mobilesuperresolution_tpu.train.state import vsr_multistep_adam as j_vsr_multistep_adam
from mobilesuperresolution_tpu.train.steps import make_vsr_step as j_make_vsr_step
from mobilesuperresolution_tpu_torch.cli import serve, test_vsr, test_vsr_by_patch, train_vsr
from mobilesuperresolution_tpu_torch.models import get_vsr_model
from mobilesuperresolution_tpu_torch.models.naive_multi import NaiveMultiModel
from mobilesuperresolution_tpu_torch.models.single_image import SingleImageModel
from mobilesuperresolution_tpu_torch.serve import make_flow_sr_fns
from mobilesuperresolution_tpu_torch.train.checkpoint import (
    jax_named_parameters,
    jax_param_shapes,
    load_params_npz,
    random_jax_params,
)
from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

torch.set_num_threads(2)
T, HW, S = 3, 16, 4
OUT = S * HW
IDX = ((8, 8, 3), (8, 6, 5))
ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "search_depth_tpu", "block_index.txt")
KINDS = ["single", "multi"]


def _tree(flat):
    out = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        d = out
        for s in scope:
            d = d.setdefault(s, {})
        d[leaf] = jnp.asarray(v)
    return out


def _flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=KINDS)
def tiny(request):
    """(kind, port model factory, seeded weights in the JAX layout with
    non-zero biases, the JAX model) of one tiny model type."""
    kind = request.param
    if kind == "single":
        def make():
            return SingleImageModel(scale=S, channel=8, blocks=2, kernel=3)
        jm = JSingleImageModel(scale=S, channel=8, blocks=2, kernel=3)
    else:
        def make():
            return NaiveMultiModel(S, IDX)
        # SpyNet frozen in training: the JAX CLI's stop_flow_grad (the
        # forward is the same either way)
        jm = JNaiveMultiModel(scale=S, idx=IDX, stop_flow_grad=True)
    flat = random_jax_params(make(), seed=4)
    rng = np.random.default_rng(4)
    for k in flat:  # non-zero biases, so their gradients count
        if k.endswith(("bias", "/b")) and not k.startswith("flownet/"):
            flat[k] = (rng.standard_normal(flat[k].shape) * 0.05).astype(np.float32)
    return kind, make, flat, jm


def test_zoo_forward_matches_jax(tiny):
    """The f32 forward of the port equals the JAX model's within 1e-5 of the
    largest output, on the same weights."""
    kind, make, flat, jm = tiny
    m = load_params_npz(make(), flat).eval()
    x = np.random.default_rng(1).random((1, T, HW, HW, 3), np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x, OUT, OUT))(_tree(flat), jnp.asarray(x)))
    with torch.inference_mode():
        got = m(_t(x), OUT, OUT).numpy()
    assert got.shape == want.shape == (1, T, OUT, OUT, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_zoo_bridge_matches_jax_tree(kind):
    """The canonical models' bridge keys and shapes equal the JAX init's tree
    (jax.eval_shape, traced only); random_jax_params fills every key with
    its shape, and a WNConv built with g_init=None gets g = ||v||."""
    jm = j_get_vsr_model(kind, scale=S, block_index_path=ARTIFACT)
    x = jnp.zeros((1, T, HW, HW, 3))
    tree = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, OUT, OUT))["params"]
    want = {"/".join(str(p.key) for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    m = get_vsr_model(kind, scale=S, device="cpu", block_index_path=ARTIFACT)
    assert jax_param_shapes(m) == want
    flat = random_jax_params(m, seed=1)
    assert {k: v.shape for k, v in flat.items()} == want
    wn = [k[: -len("/v")] for k in flat if k.endswith("/v")]
    assert len(wn) == (18 if kind == "single" else 2)
    for stem in wn:
        v = flat[stem + "/v"].astype(np.float64)
        np.testing.assert_allclose(flat[stem + "/g"], np.sqrt((v * v).sum(axis=(0, 1, 2))), rtol=1e-6)
    if kind == "multi":
        assert m.channels == 18 and [b[2] for b in m.idx] == [7]
        assert want["block_0/PlainConv_0/Conv_0/kernel"] == (7, 7, 2 * 18 + 2, 18)
        assert want["decode/v"] == (3, 3, 18, 48)


def _adam_drift(lrs, b1=0.9, b2=0.99):
    return 2 * (1 - b1) / np.sqrt(1 - b2) / np.sqrt(1 - b1 * b1 / b2) * sum(lrs)


def test_zoo_lockstep_matches_jax(tiny):
    """Three VSR steps of the port's make_vsr_step + vsr_multistep_adam with
    the frozen-SpyNet mask against the JAX package's, crossing both
    milestones (one step per epoch, 3 epochs): per-step losses agree, the
    trainable weights agree within the Adam drift bound and all moved, and
    'multi''s flownet never moves on either side."""
    kind, make, flat, jm = tiny
    lr_rate, spe, epochs = 1e-3, 1, 3
    m = load_params_npz(make(), flat).train()
    params = _tree(flat)
    tx = j_vsr_multistep_adam(lr_rate, spe, epochs, trainable_mask=j_spynet_frozen_mask(params))
    state = TrainState(step=0, params=params, opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
    jstep = j_make_vsr_step(state, (OUT, OUT))
    named = jax_named_parameters(m)
    mask = spynet_frozen_mask(named)
    assert {k for k, v in mask.items() if not v} == {k for k in named if k.startswith("flownet/")}
    opt = vsr_multistep_adam(named, lr_rate, spe, epochs, mask)
    tstep = make_vsr_step(m, opt, (OUT, OUT))
    data = np.random.default_rng(8)
    for i in range(3):
        lr_clip = data.random((1, T, HW, HW, 3), np.float32)
        hr_clip = data.random((1, T, OUT, OUT, 3), np.float32)
        state, jmet = jstep(state, (jnp.asarray(lr_clip), jnp.asarray(hr_clip)))
        tmet = tstep((_t(lr_clip), _t(hr_clip)))
        assert float(tmet["skipped"]) == float(jmet["skipped"]) == 0.0
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=2e-4, err_msg=f"step {i}")
    jflat = _flat(state.params)
    tol = _adam_drift([opt.schedule(c) for c in range(3)])
    for k, p in named.items():
        got = p.detach().numpy()
        if k.startswith("flownet/"):
            np.testing.assert_array_equal(got, flat[k], err_msg=k)
            np.testing.assert_array_equal(jflat[k], flat[k], err_msg=k)
            continue
        assert np.abs(got - jflat[k]).max() <= tol, k
        assert not np.array_equal(got, flat[k]), k


def test_zoo_refusals(tmp_path):
    """The JAX registry's refusals (flow_downscale for 'single', remat for
    both, 'multi' without an artifact), an unknown type, the flow cache and
    --spynet_weights on models without SpyNet. (The other three types'
    refusals: tests/test_torch_zoo_rest.py.)"""
    for kw, err in ((dict(model_type="single", flow_downscale=2), ValueError),
                    (dict(model_type="single", remat=True), ValueError),
                    (dict(model_type="multi", remat=True, block_index_path=ARTIFACT), ValueError),
                    (dict(model_type="multi"), ValueError)):
        with pytest.raises(err):
            get_vsr_model(device="cpu", **kw)
        with pytest.raises(err):
            j_get_vsr_model(**{k: v for k, v in kw.items() if k != "device"})
    with pytest.raises(KeyError):
        get_vsr_model("nope", device="cpu")
    m = get_vsr_model("multi", device="cpu", block_index_path=ARTIFACT, flow_downscale=2)
    assert m.flow_downscale == 2
    with pytest.raises(ValueError, match="SpyNet"):
        make_flow_sr_fns(m, OUT, OUT)
    base = ["--job_dir", str(tmp_path), "--device", "cpu", "--dataset", "synthetic_vsr", "--eval_datasets"]
    np.savez(tmp_path / "spy.npz", **random_jax_params(m.flownet, 0))
    with pytest.raises(ValueError, match="no flow network"):
        train_vsr.main(base + ["--model_type", "single", "--spynet_weights", str(tmp_path / "spy.npz")])


def _serve(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("kind", KINDS)
def test_zoo_entry_points_on_cpu(kind, tmp_path):
    """At full width on tiny clips (synthetic_vsr, 2 clips of 3 24x24 LR
    frames): cli.train_vsr trains one epoch (1 step) with an eval, finite,
    into a weights npz in the JAX layout ('multi': its flownet equal to the
    --spynet_weights npz); cli.test_vsr on that npz gives the run's last eval
    whole-clip, and runs in 2-frame windows ('multi' refuses --flow_cache, as
    the JAX package does); cli.test_vsr_by_patch writes a finite 4xN array;
    cli.serve streams 4 frames."""
    from PIL import Image

    model = ["--model_type", kind] + (["--model_path", ARTIFACT] if kind == "multi" else [])
    data = ["--device", "cpu", "--dataset", "synthetic_vsr", "--synthetic_frames", "3", "--eval_datasets",
            "synthetic_vsr"] + model
    argv = ["--job_dir", str(tmp_path / "a"), "--epochs", "1", "--learning_rate", "1e-3", "--num_patches", "1"] + data
    if kind == "multi":
        spy = random_jax_params(get_vsr_model(kind, device="cpu", block_index_path=ARTIFACT).flownet, seed=9)
        np.savez(tmp_path / "spynet.npz", **spy)
        argv += ["--spynet_weights", str(tmp_path / "spynet.npz")]
    out = train_vsr.main(argv)
    assert (out["train_forwards"], out["eval_clips"]) == (1, 2)
    assert all(np.isfinite(s["loss"]) and s["skipped"] == 0 for s in out["steps"])
    npz = str(tmp_path / "a" / "weights" / "models.npz")
    z = np.load(npz)
    assert {k: z[k].shape for k in z.files} == jax_param_shapes(
        get_vsr_model(kind, device="cpu", block_index_path=ARTIFACT))
    if kind == "multi":
        for k, v in spy.items():
            np.testing.assert_array_equal(z["flownet/" + k], v)

    ev = ["--job_dir", str(tmp_path / "e"), "--eval_model", npz] + data
    assert test_vsr.main(ev)["synthetic_vsr"] == out["eval"][-1]["synthetic_vsr"]
    windows = ["--chunk_frames", "2", "--chunk_overlap", "0"]  # windows of 2 frames
    assert np.isfinite(test_vsr.main(ev + windows)["synthetic_vsr"]["PSNR"])
    if kind == "multi":
        with pytest.raises(ValueError, match="SpyNet"):
            test_vsr.main(ev + windows + ["--flow_cache"])

    res = test_vsr_by_patch.main(["--job_dir", str(tmp_path / "p"), "--eval_model", npz, "--patch_h", "16",
                                  "--patch_w", "16", "--overlap_h", "8", "--patch_batch", "2"] + data)
    arr = np.load(tmp_path / "p" / "run" / f"{kind}_16_16_2.npy")
    # 24x24 LR: rows at 0 and 8, one column; 2 clips x 2 patches x 3 frames
    assert arr.shape == (4, 12) and np.isfinite(arr).all()
    np.testing.assert_array_equal(res["synthetic_vsr"], arr)

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.random((16, 16, 3)) * 255).astype(np.uint8)).save(frames / f"{i:04d}.png")
    stats = _serve(["--job_dir", str(tmp_path / "s"), "--input_dir", str(frames), "--chunk_frames", "2",
                    "--chunk_overlap", "1", "--eval_model", npz, "--device", "cpu"] + model)
    assert stats["frames"] == 4 and len(os.listdir(tmp_path / "s" / "serve")) == 4
    assert np.asarray(Image.open(tmp_path / "s" / "serve" / "00000000.png")).shape == (64, 64, 3)
