"""Port parity for the rest of the VSR zoo: 'basic_mv' (models/mvvsr.py, on
data/reds_with_mv.py), 'multi_v1' (models/naive_multi_v1.py) and
'basic_origin' (models/basicvsr.py::BasicVSROrigin): the forward and a
3-step training lockstep against the JAX package's models and
make_vsr_step, the checkpoint bridge against the JAX init's parameter tree,
REDS-with-MV items against the JAX reader, the registry's refusals, and the
entry points (cli.train_vsr, cli.test_vsr, cli.test_vsr_by_patch, cli.serve)
end to end on the CPU.

Both sides get the same seeded weights through the bridge
(``random_jax_params``), so no JAX init is compiled; the JAX tree is checked
with ``jax.eval_shape``, which only traces. JAX compiles one forward and one
training step per model type, at a tiny size: 'basic_mv' nf 8 and 1 block,
'multi_v1' the artifact [[8, 8, 3], [8, 6, 5]], 'basic_origin' nf 8 and 1
block (its upconv2 still has 256 conv channels); x4, 16x16 LR, 3 frames for
the forward and 2 for the steps.

Tolerances: the f32 forward within 1e-5 of the largest output; per-step
losses 2e-4 relative (Adam carries one step's summation-order noise into the
next), the final trainable weights within the Adam drift bound, the frozen
flow network bit-equal on both sides. Dataset items are bit-equal.
"""

import contextlib
import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.cli.train_vsr import spynet_frozen_mask as j_spynet_frozen_mask
from mobilesuperresolution_tpu.core import modes as jmodes
from mobilesuperresolution_tpu.data import isr as jisr
from mobilesuperresolution_tpu.data import reds_with_mv as jreds_with_mv
from mobilesuperresolution_tpu.models import get_vsr_model as j_get_vsr_model
from mobilesuperresolution_tpu.models.basicvsr import BasicVSROrigin as JBasicVSROrigin
from mobilesuperresolution_tpu.models.mvvsr import MotionVectorVSR as JMotionVectorVSR
from mobilesuperresolution_tpu.models.naive_multi_v1 import NaiveMultiModelV1 as JNaiveMultiModelV1
from mobilesuperresolution_tpu.train.state import TrainState
from mobilesuperresolution_tpu.train.state import vsr_multistep_adam as j_vsr_multistep_adam
from mobilesuperresolution_tpu.train.steps import make_vsr_step as j_make_vsr_step
from mobilesuperresolution_tpu_torch.cli import serve, test_vsr, test_vsr_by_patch, train_vsr
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data import get_dataset_module, reds_with_mv
from mobilesuperresolution_tpu_torch.data.isr import batch_iterator
from mobilesuperresolution_tpu_torch.models import get_vsr_model
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSROrigin
from mobilesuperresolution_tpu_torch.models.mvvsr import MotionVectorVSR
from mobilesuperresolution_tpu_torch.models.naive_multi_v1 import NaiveMultiModelV1
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
KINDS = ["basic_mv", "multi_v1", "basic_origin"]
# the forward's output size: basic_origin's final resize away from 4x
OUT_HW = {"basic_mv": (OUT, OUT), "multi_v1": (OUT, OUT), "basic_origin": (60, 72)}
FLOW_NET = {"multi_v1": "flownet/", "basic_origin": "spynet/"}


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


def _clip(rng, kind, t, hw=HW):
    """(1, t, hw, hw, C) in [0, 1); basic_mv's channels 3-4 are motion
    vectors of a few pixels."""
    x = rng.random((1, t, hw, hw, 3), np.float32)
    if kind != "basic_mv":
        return x
    return np.concatenate([x, rng.normal(0.0, 1.5, (1, t, hw, hw, 2)).astype(np.float32)], axis=-1)


@pytest.fixture(scope="module", params=KINDS)
def tiny(request):
    """(kind, port model factory, seeded weights in the JAX layout with
    non-zero biases, the JAX model) of one tiny model type."""
    kind = request.param
    if kind == "basic_mv":
        def make():
            return MotionVectorVSR(num_feat=8, num_block=1, scale=S)
        jm = JMotionVectorVSR(num_feat=8, num_block=1, scale=S)
    elif kind == "multi_v1":
        def make():
            return NaiveMultiModelV1(S, IDX)
        jm = JNaiveMultiModelV1(scale=S, idx=IDX)
    else:
        def make():
            return BasicVSROrigin(num_feat=8, num_block=1, scale=S)
        # SpyNet frozen in training: the JAX CLI's stop_flow_grad (the
        # forward is the same either way)
        jm = JBasicVSROrigin(num_feat=8, num_block=1, scale=S, stop_flow_grad=True)
    flat = random_jax_params(make(), seed=4)
    rng = np.random.default_rng(4)
    for k in flat:  # non-zero biases, so their gradients count
        if k.endswith(("bias", "/b")) and not k.startswith(("flownet/", "spynet/")):
            flat[k] = (rng.standard_normal(flat[k].shape) * 0.05).astype(np.float32)
    return kind, make, flat, jm


def test_zoo_rest_forward_matches_jax(tiny):
    """The f32 forward of the port equals the JAX model's within 1e-5 of the
    largest output, on the same weights."""
    kind, make, flat, jm = tiny
    m = load_params_npz(make(), flat).eval()
    x = _clip(np.random.default_rng(1), kind, T)
    oh, ow = OUT_HW[kind]
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x, oh, ow))(_tree(flat), jnp.asarray(x)))
    with torch.inference_mode():
        got = m(_t(x), oh, ow).numpy()
    assert got.shape == want.shape == (1, T, oh, ow, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_zoo_rest_bridge_matches_jax_tree(kind):
    """The canonical models' bridge keys and shapes equal the JAX init's tree
    (jax.eval_shape, traced only): 'basic_mv' without any SpyNet key,
    'basic_origin' at nf 64 and 30 blocks, 'multi_v1' on the artifact's last
    line; random_jax_params fills every key with its shape."""
    jm = j_get_vsr_model(kind, scale=S, block_index_path=ARTIFACT)
    x = jnp.zeros((1, 2, HW, HW, 5 if kind == "basic_mv" else 3))
    tree = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, OUT, OUT))["params"]
    want = {"/".join(str(p.key) for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    m = get_vsr_model(kind, scale=S, device="cpu", block_index_path=ARTIFACT)
    assert jax_param_shapes(m) == want
    assert {k: v.shape for k, v in random_jax_params(m, seed=1).items()} == want
    if kind == "basic_mv":
        assert not hasattr(m, "spynet") and not any(k.startswith("spynet/") for k in want)
    elif kind == "basic_origin":
        assert want["upconv2/Conv_0/kernel"] == (3, 3, 64, 256)
        assert want["propagation/trunks/forward_block29_conv2_kernel"] == (3, 3, 64, 64)
    else:
        assert want["frame_step/decode/v"] == (3, 3, 18, 48) and want["frame_step/skip/v"] == (5, 5, 3, 48)


def _adam_drift(lrs, b1=0.9, b2=0.99):
    return 2 * (1 - b1) / np.sqrt(1 - b2) / np.sqrt(1 - b1 * b1 / b2) * sum(lrs)


def test_zoo_rest_lockstep_matches_jax(tiny):
    """Three VSR steps of the port's make_vsr_step + vsr_multistep_adam with
    the frozen-SpyNet mask against the JAX package's, crossing both
    milestones (one step per epoch, 3 epochs), on 2-frame clips: per-step
    losses agree, the trainable weights agree within the Adam drift bound and
    all moved, and the flow network (where there is one) never moves on
    either side."""
    kind, make, flat, jm = tiny
    lr_rate, spe, epochs, t = 1e-3, 1, 3, 2
    m = load_params_npz(make(), flat).train()
    params = _tree(flat)
    tx = j_vsr_multistep_adam(lr_rate, spe, epochs, trainable_mask=j_spynet_frozen_mask(params))
    state = TrainState(step=0, params=params, opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
    forward = None
    if kind == "multi_v1":
        # the JAX model has no stop_flow_grad: stop the frozen flownet's
        # gradient in the forward instead (the same losses and trainable
        # gradients, without differentiating SpyNet)
        def forward(p, lr_clip):
            p = {**p, "flownet": jax.lax.stop_gradient(p["flownet"])}
            return jm.apply({"params": p}, lr_clip, OUT, OUT)
    jstep = j_make_vsr_step(state, (OUT, OUT), forward=forward)
    named = jax_named_parameters(m)
    mask = spynet_frozen_mask(named)
    frozen = FLOW_NET.get(kind, "-")
    assert {k for k, v in mask.items() if not v} == {k for k in named if k.startswith(frozen)}
    opt = vsr_multistep_adam(named, lr_rate, spe, epochs, mask)
    tstep = make_vsr_step(m, opt, (OUT, OUT))
    data = np.random.default_rng(8)
    for i in range(3):
        lr_clip = _clip(data, kind, t)
        hr_clip = data.random((1, t, OUT, OUT, 3), np.float32)
        state, jmet = jstep(state, (jnp.asarray(lr_clip), jnp.asarray(hr_clip)))
        tmet = tstep((_t(lr_clip), _t(hr_clip)))
        assert float(tmet["skipped"]) == float(jmet["skipped"]) == 0.0
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=2e-4, err_msg=f"step {i}")
    jflat = _flat(state.params)
    tol = _adam_drift([opt.schedule(c) for c in range(3)])
    for k, p in named.items():
        got = p.detach().numpy()
        if k.startswith(frozen):
            np.testing.assert_array_equal(got, flat[k], err_msg=k)
            np.testing.assert_array_equal(jflat[k], flat[k], err_msg=k)
            continue
        assert np.abs(got - jflat[k]).max() <= tol, k
        assert not np.array_equal(got, flat[k]), k


def _reds_mv_tree(root, clips=("000", "001", "153"), frames=4, hw=16):
    """A REDS-layout tree of tiny PNG clips with each LR clip's
    hex-me16-ref1/motion.npy: per frame a constant vector (dx, dy) that
    differs by clip and frame. Returns the vectors {clip: (frames, 2)}."""
    from PIL import Image

    from mobilesuperresolution_tpu_torch.data.synthetic import synthetic_image

    vectors = {}
    for split in ("train", "val"):
        for ci, clip in enumerate(clips):
            vec = np.stack([[0.5 + ci + 0.25 * i, -1.0 - 0.5 * i] for i in range(frames)]).astype(np.float32)
            vectors[clip] = vec
            for i in range(frames):
                hr = synthetic_image(10 * ci + i, (S * hw, S * hw))
                for d, img in ((f"{split}_sharp", hr), (f"{split}_sharp_bicubic/X4", hr[::S, ::S])):
                    path = root / "REDS" / split / d / clip
                    path.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(img).save(path / f"{i:08d}.png")
            mv_dir = root / "REDS" / split / f"{split}_sharp_bicubic" / "X4" / clip / "hex-me16-ref1"
            mv_dir.mkdir()
            np.save(mv_dir / "motion.npy", np.broadcast_to(vec[:, None, None], (frames, hw, hw, 2)).copy())
    return vectors


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, str):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)
    return got


def test_reds_with_mv_items_match_jax(tmp_path):
    """A tiny REDS-with-MV tree: the same windows (clip 153 skipped), TRAIN
    batches (crop, flips, motion-vector negation) and EVAL clips as the JAX
    package's reader, bit for bit; the vectors ride unscaled after the RGB
    channels, and a width (height) flip negates dx (dy)."""
    vectors = _reds_mv_tree(tmp_path)
    p = SimpleNamespace(scale=S, lr_patch_size=8, ignored_boundary_size=2, num_patches=3, seed=0,
                        train_sample_patch=True, data_dir=str(tmp_path), cache_dir="", image_batch=3,
                        val_image_batch=4)
    for mode, jmode in ((modes.TRAIN, jmodes.TRAIN), (modes.EVAL, jmodes.EVAL)):
        tds, jds = reds_with_mv.get_dataset(mode, p), jreds_with_mv.get_dataset(jmode, p)
        assert tds.lr_windows == jds.lr_windows and tds.hr_windows == jds.hr_windows
        assert {k.split("/")[0] for w in tds.lr_windows for k, _ in w} == {"000", "001"}
        got = _assert_batches_equal(batch_iterator(tds, 2, shuffle=True, seed=1, drop_last=True),
                                    jisr._batches(jds, 2, True, 1, True))
        if mode == modes.TRAIN:
            lr = np.concatenate([b[0] for b in got])  # (N, 3, 8, 8, 5)
    assert lr.shape[1:] == (3, 8, 8, 5)
    dx = {float(v) for v in np.unique(lr[..., 3])}
    dy = {float(v) for v in np.unique(lr[..., 4])}
    every = np.concatenate(list(vectors.values()))
    assert dx <= {float(s * v) for v in every[:, 0] for s in (1, -1)} and min(dx) < 0 < max(dx)
    assert dy <= {float(s * v) for v in every[:, 1] for s in (1, -1)} and min(dy) < 0 < max(dy)
    _, lr_eval, _ = reds_with_mv.get_dataset(modes.EVAL, p)[0]
    np.testing.assert_array_equal(lr_eval[..., 3:], np.broadcast_to(vectors["000"][:, None, None], (4, 16, 16, 2)))
    assert get_dataset_module("reds_with_mv") is reds_with_mv


def test_zoo_rest_refusals(tmp_path):
    """The JAX registry's refusals for the three types (basic_origin at a
    scale other than 4, multi_v1 without an artifact or with remat or
    flow_downscale, basic_mv with flow_downscale), then the flow cache, the
    --spynet_weights flag and cli.serve on basic_mv, which has no SpyNet."""
    for kw in (dict(model_type="basic_origin", scale=2), dict(model_type="multi_v1"),
               dict(model_type="multi_v1", remat=True, block_index_path=ARTIFACT),
               dict(model_type="multi_v1", flow_downscale=2, block_index_path=ARTIFACT),
               dict(model_type="basic_mv", flow_downscale=2)):
        with pytest.raises(ValueError):
            get_vsr_model(device="cpu", **kw)
        with pytest.raises(ValueError):
            j_get_vsr_model(**kw)
    m = get_vsr_model("basic_mv", device="cpu", remat=True)
    assert m.remat and not hasattr(m, "spynet")
    with pytest.raises(ValueError, match="SpyNet"):
        make_flow_sr_fns(m, OUT, OUT)
    assert get_vsr_model("basic_origin", device="cpu", flow_downscale=2).flow_downscale == 2
    np.savez(tmp_path / "spy.npz", **random_jax_params(get_vsr_model(device="cpu").spynet, 0))
    base = ["--job_dir", str(tmp_path), "--device", "cpu", "--dataset", "synthetic_vsr", "--eval_datasets"]
    with pytest.raises(ValueError, match="bitstream"):
        train_vsr.main(base + ["--model_type", "basic_mv", "--spynet_weights", str(tmp_path / "spy.npz")])
    with pytest.raises(ValueError, match="motion vectors"):
        serve.main(["--job_dir", str(tmp_path), "--input_dir", str(tmp_path), "--model_type", "basic_mv",
                    "--device", "cpu"])


def _serve(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("kind", KINDS)
def test_zoo_rest_entry_points_on_cpu(kind, tmp_path):
    """At full width on tiny clips (3 frames of 16x16 LR: synthetic_vsr, or
    the REDS-with-MV tree for basic_mv): cli.train_vsr trains one epoch (1
    step) with an eval, finite, into a weights npz in the JAX layout (the
    flow network equal to the --spynet_weights npz); cli.test_vsr on that npz
    gives the run's last eval whole-clip, and runs in 2-frame windows
    (basic_origin also flow-cached, equal to the plain windows);
    cli.test_vsr_by_patch writes a finite 4xN array; cli.serve streams 4
    frames (basic_origin also flow-cached; basic_mv is refused there)."""
    from PIL import Image

    model = ["--model_type", kind] + (["--model_path", ARTIFACT] if kind == "multi_v1" else [])
    if kind == "basic_mv":
        _reds_mv_tree(tmp_path / "data", clips=("000",), frames=3)
        data = ["--dataset", "reds_with_mv", "--eval_datasets", "reds_with_mv", "--data_dir", str(tmp_path / "data"),
                "--cache_dir", "", "--image_batch", "3", "--val_image_batch", "3"]
    else:
        data = ["--dataset", "synthetic_vsr", "--eval_datasets", "synthetic_vsr", "--synthetic_frames", "3",
                "--synthetic_clips", "1", "--synthetic_size", str(S * HW)]
    data = ["--device", "cpu"] + data + model
    argv = ["--job_dir", str(tmp_path / "a"), "--epochs", "1", "--learning_rate", "1e-3", "--num_patches", "1",
            "--train_batch_size", "1", "--lr_patch_size", str(HW), "--ignored_boundary_size", "0"] + data
    canonical = get_vsr_model(kind, device="cpu", block_index_path=ARTIFACT)
    if kind in FLOW_NET:
        flow_net = canonical.spynet if kind == "basic_origin" else canonical.flownet
        spy = random_jax_params(flow_net, seed=9)
        np.savez(tmp_path / "spynet.npz", **spy)
        argv += ["--spynet_weights", str(tmp_path / "spynet.npz")]
    out = train_vsr.main(argv)
    set_name = data[data.index("--eval_datasets") + 1]
    assert (out["train_forwards"], out["eval_clips"]) == (1, 1)
    assert all(np.isfinite(s["loss"]) and s["skipped"] == 0 for s in out["steps"])
    npz = str(tmp_path / "a" / "weights" / "models.npz")
    z = np.load(npz)
    assert {k: z[k].shape for k in z.files} == jax_param_shapes(canonical)
    if kind in FLOW_NET:
        for k, v in spy.items():
            np.testing.assert_array_equal(z[FLOW_NET[kind] + k], v)

    ev = ["--job_dir", str(tmp_path / "e"), "--eval_model", npz] + data
    assert test_vsr.main(ev)[set_name] == out["eval"][-1][set_name]
    windows = ["--chunk_frames", "2", "--chunk_overlap", "0"]  # windows of 2 frames
    plain = test_vsr.main(ev + windows)[set_name]
    assert np.isfinite(plain["PSNR"])
    if kind == "basic_origin":
        assert test_vsr.main(ev + windows + ["--flow_cache"])[set_name]["PSNR"] == pytest.approx(plain["PSNR"],
                                                                                                 abs=1e-4)

    res = test_vsr_by_patch.main(["--job_dir", str(tmp_path / "p"), "--eval_model", npz, "--patch_h", "8",
                                  "--patch_w", "8", "--overlap_h", "0", "--patch_batch", "2"] + data)
    arr = np.load(tmp_path / "p" / "run" / f"{kind}_8_8_2.npy")
    # 16x16 LR: 2 x 2 patches of 8x8; one clip x 4 patches x 3 frames
    assert arr.shape == (4, 12) and np.isfinite(arr).all()
    np.testing.assert_array_equal(res[set_name], arr)

    if kind == "basic_mv":
        return  # refused by cli.serve (test_zoo_rest_refusals)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.random((16, 16, 3)) * 255).astype(np.uint8)).save(frames / f"{i:04d}.png")
    serve_argv = ["--input_dir", str(frames), "--chunk_frames", "2", "--chunk_overlap", "1", "--eval_model", npz,
                  "--device", "cpu"] + model
    for cached in ([], ["--flow_cache"]) if kind == "basic_origin" else ([],):
        job = tmp_path / ("s" + "".join(cached))
        stats = _serve(["--job_dir", str(job)] + serve_argv + cached)
        assert stats["frames"] == 4 and len(os.listdir(job / "serve")) == 4
        assert np.asarray(Image.open(job / "serve" / "00000000.png")).shape == (64, 64, 3)
