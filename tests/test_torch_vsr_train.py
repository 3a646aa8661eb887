"""Port parity for VSR data, eval and training: synthetic_vsr and REDS items
against the JAX package's, the VSR optimizer's schedule, the VSR step in
lockstep with the JAX package's make_vsr_step + vsr_multistep_adam, --remat,
live weights in train mode, and the two entry points (cli/train_vsr.py,
cli/test_vsr.py). float32 on the CPU; both sides get the same seeded weights
through the checkpoint bridge (no JAX init). The JAX step and the JAX eval
compile once per module, at a tiny size.

Tolerances: data bit-equal; the schedule exact; per-step losses 2e-4
relative over the lockstep (Adam carries one step's summation-order noise
into the next); the final trainable weights within 1e-5 on all but a few
elements and within the Adam drift bound on every one (``_adam_drift``);
the frozen SpyNet bit-equal; --remat, the train-mode forward against the
eval one, the resumed run and the flow-cached eval bit-equal (the same
arithmetic); the eval PSNR within 1e-4 dB of the JAX package's.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers.jax_compile import unoptimized_xla  # noqa: F401 (a fixture)

from mobilesuperresolution_tpu.cli.train_vsr import run_vsr_evaluation as j_run_vsr_evaluation
from mobilesuperresolution_tpu.cli.train_vsr import spynet_frozen_mask as j_spynet_frozen_mask
from mobilesuperresolution_tpu.core import modes as jmodes
from mobilesuperresolution_tpu.data import isr as jisr
from mobilesuperresolution_tpu.data import reds as jreds
from mobilesuperresolution_tpu.data.synthetic import SyntheticVSRDataset as JSyntheticVSRDataset
from mobilesuperresolution_tpu.models.basicvsr import BasicVSR as JBasicVSR
from mobilesuperresolution_tpu.train.state import TrainState
from mobilesuperresolution_tpu.train.state import multistep_lr as j_multistep_lr
from mobilesuperresolution_tpu.train.state import vsr_multistep_adam as j_vsr_multistep_adam
from mobilesuperresolution_tpu.train.steps import make_vsr_step as j_make_vsr_step
from mobilesuperresolution_tpu_torch.cli import test_vsr, train_vsr
from mobilesuperresolution_tpu_torch.core import modes
from mobilesuperresolution_tpu_torch.data import get_dataset_module
from mobilesuperresolution_tpu_torch.data import reds
from mobilesuperresolution_tpu_torch.data.isr import batch_iterator
from mobilesuperresolution_tpu_torch.data.synthetic import SyntheticVSRDataset
from mobilesuperresolution_tpu_torch.models import get_vsr_model
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
from mobilesuperresolution_tpu_torch.models.spynet import SpyNet
from mobilesuperresolution_tpu_torch.models.wdsr_basic import BasicModel
from mobilesuperresolution_tpu_torch.train.checkpoint import (
    jax_named_parameters,
    jax_param_shapes,
    load_params_npz,
    random_jax_params,
    save_params_npz,
)
from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

torch.set_num_threads(2)
NF, NB, T, HW, S = 8, 1, 2, 16, 4


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


def _tiny(seed=3, **kw):
    m = BasicVSR(num_feat=NF, num_block=NB, scale=S, **kw)
    flat = random_jax_params(m, seed)
    load_params_npz(m, flat)
    return m, flat


def _adam_drift(lrs, b1=0.9, b2=0.99):
    """Two Adam runs whose gradients differ by rounding part by at most twice
    the largest update summed over the steps: a bias-corrected update moves
    an element by at most lr (1 - b1) / sqrt(1 - b2) / sqrt(1 - b1² / b2)."""
    return 2 * (1 - b1) / np.sqrt(1 - b2) / np.sqrt(1 - b1 * b1 / b2) * sum(lrs)


def _vsr_params(**kw):
    p = dict(scale=4, lr_patch_size=12, ignored_boundary_size=2, num_patches=2, seed=0, train_sample_patch=True)
    p.update(kw)
    return SimpleNamespace(**p)


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


def test_synthetic_vsr_items_match_jax():
    """Crops and both flips of every TRAIN item, and the EVAL clips, equal
    the JAX package's for the same seeds; the registry's defaults make the
    JAX package's dataset."""
    p = _vsr_params()
    tds = SyntheticVSRDataset(modes.TRAIN, p, frames=3, hw=(72, 72))
    jds = JSyntheticVSRDataset(jmodes.TRAIN, p, frames=3, hw=(72, 72))
    _assert_batches_equal(batch_iterator(tds, 2, shuffle=True, seed=5, drop_last=True),
                          jisr._batches(jds, 2, True, 5, True))
    _assert_batches_equal(batch_iterator(SyntheticVSRDataset(modes.EVAL, p, frames=3, hw=(72, 72))),
                          jisr._batches(JSyntheticVSRDataset(jmodes.EVAL, p, frames=3, hw=(72, 72)), 1, False, 0,
                                        False))
    ds = get_dataset_module("synthetic_vsr").get_dataset(modes.EVAL, p)
    assert (len(ds), ds[0][1].shape) == (2, (6, 24, 24, 3))


def test_reds_windows_and_items_match_jax(tmp_path):
    """A tiny REDS-layout tree: the same sliding windows, TRAIN batches and
    EVAL clips as the JAX package's reader; a tree missing a frame is
    refused."""
    from PIL import Image

    from mobilesuperresolution_tpu_torch.data.synthetic import synthetic_image

    for split in ("train", "val"):
        for clip in ("000", "001"):
            for i in range(4):
                hr = synthetic_image(10 * int(clip) + i, (64, 64))
                for d, img in ((f"{split}_sharp", hr), (f"{split}_sharp_bicubic/X4", hr[::4, ::4])):
                    path = tmp_path / "REDS" / split / d / clip
                    path.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(img).save(path / f"{i:08d}.png")
    p = _vsr_params(data_dir=str(tmp_path), cache_dir="", image_batch=3, val_image_batch=4)
    for mode, jmode in ((modes.TRAIN, jmodes.TRAIN), (modes.EVAL, jmodes.EVAL)):
        tds, jds = reds.get_dataset(mode, p), jreds.get_dataset(jmode, p)
        assert tds.lr_windows == jds.lr_windows and tds.hr_windows == jds.hr_windows
        _assert_batches_equal(batch_iterator(tds, 2, shuffle=True, seed=1, drop_last=True),
                              jisr._batches(jds, 2, True, 1, True))
    assert len(reds.get_dataset(modes.TRAIN, p).lr_windows) == 4
    os.remove(tmp_path / "REDS" / "val" / "val_sharp" / "001" / "00000003.png")
    with pytest.raises(ValueError, match="disagree"):
        reds.get_dataset(modes.EVAL, p)


@pytest.mark.parametrize("epochs", [3, 5, 10])
def test_vsr_multistep_adam_schedule_matches_jax(epochs):
    """The VSR optimizer's LR at every count equals the JAX package's
    schedule (milestones [E/2, 8E/10], gamma 0.3), with betas (0.9, 0.99)."""
    m, _ = _tiny()
    named = jax_named_parameters(m)
    opt = vsr_multistep_adam(named, 1e-3, 3, epochs, spynet_frozen_mask(named))
    counts = np.arange(3 * epochs + 2)
    want = jax.jit(jax.vmap(j_multistep_lr(1e-3, 3, epochs, milestones=[epochs // 2, epochs * 8 // 10])))(counts)
    assert [opt.schedule(int(i)) for i in counts] == pytest.approx(np.asarray(want).tolist(), rel=1e-7)
    assert opt.opt.param_groups[0]["betas"] == (0.9, 0.99)
    assert {id(p) for p in opt.params} == {id(p) for k, p in named.items() if not k.startswith("spynet/")}


def test_vsr_lockstep_matches_jax(unoptimized_xla):
    """Six VSR steps against the JAX step with vsr_multistep_adam and the
    frozen-SpyNet mask, crossing both milestones (one step per epoch, 5
    epochs: counts 2 and 4); the fourth batch holds a NaN, which both sides
    skip. Per-step losses agree, the final trainable weights agree, SpyNet
    never moves on either side."""
    lr_rate, spe, epochs = 1e-3, 1, 5
    m, flat = _tiny(seed=4)
    bias = np.random.default_rng(4)
    for k in flat:  # non-zero biases, so their gradients count
        if k.endswith("bias") and not k.startswith("spynet/"):
            flat[k] = (bias.standard_normal(flat[k].shape) * 0.05).astype(np.float32)
    load_params_npz(m, flat)
    m.train()
    jm = JBasicVSR(num_feat=NF, num_block=NB, scale=S, stop_flow_grad=True)
    params = _tree(flat)
    tx = j_vsr_multistep_adam(lr_rate, spe, epochs, trainable_mask=j_spynet_frozen_mask(params))
    state = TrainState(step=0, params=params, opt_state=jax.jit(tx.init)(params), tx=tx, apply_fn=jm.apply)
    jstep = j_make_vsr_step(state, (S * HW, S * HW))
    named = jax_named_parameters(m)
    opt = vsr_multistep_adam(named, lr_rate, spe, epochs, spynet_frozen_mask(named))
    tstep = make_vsr_step(m, opt, (S * HW, S * HW))

    data = np.random.default_rng(8)
    for i in range(6):
        lr_clip = data.random((1, T, HW, HW, 3), np.float32)
        hr_clip = data.random((1, T, S * HW, S * HW, 3), np.float32)
        if i == 3:
            lr_clip[0, 1, 2, 3, 0] = np.nan
        state, jmet = jstep(state, (jnp.asarray(lr_clip), jnp.asarray(hr_clip)))
        tmet = tstep((_t(lr_clip), _t(hr_clip)))
        assert float(tmet["skipped"]) == float(jmet["skipped"]) == float(i == 3)
        if i != 3:
            np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=2e-4, err_msg=f"step {i}")
    assert (opt.applied, opt.steps, int(state.step)) == (5, 6, 6)
    jflat = {"/".join(str(p.key) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    tol = _adam_drift([opt.schedule(c) for c in range(5)])
    for k, p in named.items():
        got = p.detach().numpy()
        if k.startswith("spynet/"):
            np.testing.assert_array_equal(got, flat[k], err_msg=k)
            np.testing.assert_array_equal(jflat[k], flat[k], err_msg=k)
            continue
        diff = np.abs(got - jflat[k])
        assert diff.max() <= tol and (diff > 1e-5).sum() <= max(2, diff.size // 1000), (k, diff.max())
        assert not np.array_equal(got, flat[k]), k


def _prepared_tensors(model):
    """Every tensor a module of ``model`` holds outside its parameters and
    buffers (prepare()'s derived weights), in tuples, lists and dicts too."""
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            for u in v:
                walk(u)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)

    for mod in model.modules():
        for name, v in vars(mod).items():
            if name not in ("_parameters", "_buffers", "_modules"):
                walk(v)
    return out


def test_remat_and_live_weights():
    """--remat gives the plain gradients bit for bit; the train-mode forward
    runs on live weights (it changes after an optimizer step, and no
    parameter's gradient is missing but SpyNet's); eval after prepare()
    equals the train-mode forward on the same weights. For BasicVSR, a
    WDSR-B BasicModel and a SpyNet: no prepared tensor shares storage with a
    parameter, so after an in-place update of every parameter the eval
    forward is the old one until prepare() runs, and then the live one's
    (for SpyNet, which has no live path: a fresh SpyNet's on the new
    weights)."""
    x = _t(np.random.default_rng(2).random((1, T, HW, HW, 3), np.float32))
    hr = _t(np.random.default_rng(3).random((1, T, S * HW, S * HW, 3), np.float32))
    grads = []
    for remat in (False, True):
        m, _ = _tiny(remat=remat)
        m.train()
        torch.sqrt((m(x, S * HW, S * HW) - hr) ** 2 + 1e-12).mean().backward()
        named = jax_named_parameters(m)
        assert {k for k, p in named.items() if p.grad is None} == {k for k in named if k.startswith("spynet/")}
        grads.append({k: p.grad for k, p in named.items() if p.grad is not None})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k

    m, _ = _tiny()
    m.train()
    named = jax_named_parameters(m)
    step = make_vsr_step(m, vsr_multistep_adam(named, 1e-2, 1, 1, spynet_frozen_mask(named)), (S * HW, S * HW))
    with torch.no_grad():
        before = m(x, S * HW, S * HW)
    step((x, hr))
    with torch.no_grad():
        after_train = m(x, S * HW, S * HW)
        stale_eval = m.eval()(x, S * HW, S * HW)
        m.prepare()
        fresh_eval = m(x, S * HW, S * HW)
    assert not torch.equal(before, after_train)
    assert torch.equal(stale_eval, before)  # prepare() not run yet: the pre-step weights
    assert torch.equal(fresh_eval, after_train)

    frames = _t(np.random.default_rng(5).random((2, 32, 32, 3), np.float32))
    for m, fwd in ((BasicModel(num_blocks=2, num_residual_units=8, scale=2), lambda m: m(frames)),
                   (SpyNet(), lambda m: m(frames[:1], frames[1:]))):
        load_params_npz(m, random_jax_params(m, seed=7))
        m.eval()
        params = {p.untyped_storage().data_ptr() for p in m.parameters()}
        assert not [t.shape for t in _prepared_tensors(m) if t.untyped_storage().data_ptr() in params]
        with torch.no_grad():
            before = fwd(m)
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
            stale = fwd(m)
            if isinstance(m, SpyNet):
                live = fwd(load_params_npz(SpyNet(), {k: p.numpy() for k, p in jax_named_parameters(m).items()}))
            else:
                live = fwd(m.train())
                m.eval()
            m.prepare()
            fresh = fwd(m)
        assert torch.equal(stale, before), type(m).__name__
        assert not torch.equal(fresh, before) and torch.equal(fresh, live), type(m).__name__


def _jax_eval(job, npz, flat_shapes, monkeypatch):
    """The JAX package's run_vsr_evaluation of a tiny BasicVSR on the npz,
    whole clips of a synthetic_vsr eval set of 2 clips of 3 64x64 frames;
    its eval harness's metrics run under jax.jit (eagerly each op would
    compile on its own)."""
    from mobilesuperresolution_tpu.train import evaluate as j_evaluate_module
    from mobilesuperresolution_tpu.train.checkpoint import load_params_npz as j_load_params_npz

    for name in ("psnr", "psnr_y", "ssim"):
        monkeypatch.setattr(j_evaluate_module, name, jax.jit(getattr(j_evaluate_module, name),
                                                             static_argnames="shave"))
    monkeypatch.setattr(j_evaluate_module, "charbonnier_loss", jax.jit(j_evaluate_module.charbonnier_loss))
    monkeypatch.setattr(j_evaluate_module, "resize_bilinear",
                        jax.jit(j_evaluate_module.resize_bilinear, static_argnames=("out_hw", "align_corners")))

    jm = JBasicVSR(num_feat=NF, num_block=NB, scale=S)
    template = _tree({k: np.zeros(s, np.float32) for k, s in flat_shapes.items()})
    state = SimpleNamespace(params=j_load_params_npz(npz, template))
    params = SimpleNamespace(job_dir=job, scale=S, save_eval_images=False, spatial_shards=1, chunk_frames=0)
    mod = SimpleNamespace(get_dataset=lambda mode, p: JSyntheticVSRDataset(mode, p, frames=3, hw=(64, 64)))
    log = SimpleNamespace(info=lambda *_: None)
    return j_run_vsr_evaluation(params, state, jm, [("synthetic_vsr", mod)], log, 0)["synthetic_vsr"]


def test_vsr_entry_points_on_cpu(tmp_path, monkeypatch, unoptimized_xla):
    """cli.train_vsr on synthetic_vsr (2 clips of 4 frames) on the CPU: one
    epoch (2 steps) with eval, finite losses, a weights npz in the JAX layout
    whose SpyNet equals the --spynet_weights npz, and --max_steps_per_run /
    --resume ending on the uninterrupted run's weights bit for bit.
    cli.test_vsr on that npz gives the run's last eval; windowed, its
    flow-cached eval equals the plain windowed one. A tiny model's eval
    equals the JAX package's run_vsr_evaluation on the same npz."""
    spy = get_vsr_model(device="cpu").spynet
    spy_flat = {k: v for k, v in random_jax_params(spy, seed=9).items()}
    np.savez(tmp_path / "spynet.npz", **spy_flat)
    data = ["--device", "cpu", "--dataset", "synthetic_vsr", "--synthetic_frames", "4"]
    argv = data + ["--epochs", "1", "--learning_rate", "1e-3", "--spynet_weights", str(tmp_path / "spynet.npz")]
    out = train_vsr.main(["--job_dir", str(tmp_path / "a"), "--eval_datasets", "synthetic_vsr"] + argv)
    assert (out["train_forwards"], out["eval_clips"], len(out["eval"])) == (2, 2, 1)
    assert all(np.isfinite(s["loss"]) and s["skipped"] == 0 for s in out["steps"])
    npz = str(tmp_path / "a" / "weights" / "models.npz")
    z = np.load(npz)
    assert {k: z[k].shape for k in z.files} == jax_param_shapes(get_vsr_model(device="cpu"))
    for k, v in spy_flat.items():
        np.testing.assert_array_equal(z["spynet/" + k], v)
    train_vsr.main(["--job_dir", str(tmp_path / "b"), "--max_steps_per_run", "1"] + argv)
    resumed = train_vsr.main(["--job_dir", str(tmp_path / "b"), "--resume"] + argv)
    assert resumed["resumed"] == {"epoch": 1, "batch": 1}
    zb = np.load(str(tmp_path / "b" / "weights" / "models.npz"))
    for k in z.files:
        np.testing.assert_array_equal(z[k], zb[k], err_msg=k)

    ev = ["--job_dir", str(tmp_path / "e"), "--eval_datasets", "synthetic_vsr", "--eval_model", npz] + data
    assert test_vsr.main(ev)["synthetic_vsr"] == out["eval"][-1]["synthetic_vsr"]
    windows = ["--chunk_frames", "1", "--chunk_overlap", "1"]  # windows of 3 frames
    assert test_vsr.main(ev + windows + ["--flow_cache"]) == test_vsr.main(ev + windows)

    m, flat = _tiny(seed=5)
    save_params_npz(str(tmp_path / "tiny"), m)
    params = SimpleNamespace(job_dir=str(tmp_path / "t"), scale=S, save_eval_images=False, chunk_frames=0,
                             flow_cache=False, synthetic_clips=2, synthetic_frames=3, synthetic_size=64)
    got = train_vsr.run_vsr_evaluation(params, m.eval(), [("synthetic_vsr", get_dataset_module("synthetic_vsr"))],
                                       0, "cpu")["synthetic_vsr"]
    want = _jax_eval(str(tmp_path / "j"), str(tmp_path / "tiny" / "weights" / "models.npz"),
                     {k: v.shape for k, v in flat.items()}, monkeypatch)
    for key in ("PSNR", "PSNR_Y", "bilinear_PSNR"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["SSIM"], want["SSIM"], atol=1e-6)


def test_vsr_entry_points_refuse_what_is_not_ported(tmp_path, monkeypatch):
    """--flow_cache with --chunk_data_parallel raises the JAX trainer's
    SystemExit, --quantize its inference-only message and
    --spatial_shards training of a model without the sharded forward with
    the JAX trainer's; an explicit rendezvous needs its size and rank;
    without a card the entry points run only when the CPU is asked for."""
    base = ["--job_dir", str(tmp_path), "--device", "cpu", "--dataset", "synthetic_vsr", "--eval_datasets"]
    with pytest.raises(SystemExit, match="--flow_cache and --chunk_data_parallel are mutually exclusive"):
        train_vsr.main(base + ["--chunk_frames", "2", "--flow_cache", "--chunk_data_parallel"])
    with pytest.raises(SystemExit, match="supports model_type=basic/basic_origin"):
        train_vsr.main(base + ["--spatial_shards", "2", "--model_type", "multi"])
    with pytest.raises(SystemExit, match="--quantize is inference-only"):
        train_vsr.main(base + ["--quantize", "int8"])
    # the trainer initializes from an npz only, as the JAX trainer does
    with pytest.raises(ValueError, match="cli.test_vsr"):
        train_vsr.main(base + ["--eval_model", "model.pth"])
    with pytest.raises(ValueError, match="requires --num_processes and --process_id"):
        train_vsr.main(base + ["--coordinator_address", "localhost:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train_vsr.main, test_vsr.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([a for a in base if a not in ("--device", "cpu")])
