"""Port parity for reference torch checkpoints (train/torch_convert.py and
cli/common_cli.py::load_vsr_eval_params), the entry points that take them,
and the A8 modules every entry point touches: result.log
(core/logging_tool.py), --xla_profile_steps (core/profiling.py) and
cli/prepare_dataset.py.

The reference's .pt files do not ship, so each state dict is written from
a seed with the reference's key names (chip_smoke.reference_state_dict,
the converters' inverse). Tolerances: the converted trees are exact
(transposes and reshapes); the loaded models against an independent
F.conv2d / F.conv_transpose2d forward of the raw state dict within 1e-5
of the largest output (float32 sums in another order); a .pth-loaded
model's metrics equal its npz twin's exactly.
"""

import argparse
import json
import logging
import os
import re
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mobilesuperresolution_tpu.cli import common_cli as jcli
from mobilesuperresolution_tpu.models import basicvsr as jbasicvsr
from mobilesuperresolution_tpu.train import torch_convert as jc
from mobilesuperresolution_tpu_torch.cli import prepare_dataset, pretrain, serve, test_vsr, test_vsr_by_patch, train_vsr
from mobilesuperresolution_tpu_torch.cli.common_cli import load_vsr_eval_params
from mobilesuperresolution_tpu_torch.core.logging_tool import LoggingTool
from mobilesuperresolution_tpu_torch.core.profiling import StepProfiler
from mobilesuperresolution_tpu_torch.models import (
    BasicModel,
    BasicVSROrigin,
    MotionVectorVSR,
    NaiveMultiModel,
    NASModel,
    SingleImageModel,
    SpyNet,
    get_vsr_model,
)
from mobilesuperresolution_tpu_torch.train import torch_convert as tc
from mobilesuperresolution_tpu_torch.train.checkpoint import jax_param_shapes, load_params_npz, random_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import reference_state_dict  # noqa: E402

ARTIFACT = os.path.join(REPO, "artifacts", "search_depth_tpu", "block_index.txt")
MODELS = {
    "wdsr": lambda: BasicModel(num_blocks=2, num_residual_units=8),
    "spynet": SpyNet,
    "basic_origin": lambda: BasicVSROrigin(num_feat=8, num_block=1),
    "basic_mv": lambda: MotionVectorVSR(num_feat=8, num_block=1),
    "single": lambda: SingleImageModel(channel=8, blocks=1),
    "multi": lambda: NaiveMultiModel.from_artifact(ARTIFACT, scale=4),
}
CONVERTERS = {
    "wdsr": "convert_wdsr_basic_state_dict", "spynet": "convert_spynet_state_dict",
    "basic_origin": "convert_basicvsr_origin_state_dict", "basic_mv": "convert_mvvsr_state_dict",
    "single": "convert_single_image_state_dict", "multi": "convert_naive_multi_state_dict",
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        d = out
        for s in scope:
            d = d.setdefault(s, {})
        d[leaf] = v
    return out


def _same(a, b):
    return set(a) == set(b) and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kind", list(MODELS))
def test_converters_match_jax(kind):
    """Each converter's flat tree equals the JAX converter's, flattened, on
    the same seeded reference-layout state dict; it is the weights the dict
    was written from, and it loads into the port's model by key."""
    model = MODELS[kind]()
    flat = random_jax_params(model, seed=1)
    sd = reference_state_dict(kind, flat)
    name = CONVERTERS[kind]
    kw = {"prefix": ""} if kind == "spynet" else {}
    got, want = getattr(tc, name)(sd, **kw), getattr(jc, name)(sd, **kw)
    if kind == "spynet":
        got, want = (got,), (want,)
    assert _same(got[0], _flatten(want[0])) and got[1:] == tuple(want[1:])
    assert _same(got[0], {k: v.astype(np.float32) for k, v in flat.items()})
    load_params_npz(model, got[0])


def test_spynet_prefix_miss_and_wdsr_loader_match_jax(tmp_path):
    sd = reference_state_dict("spynet", random_jax_params(SpyNet(), seed=2))
    with pytest.raises(ValueError) as jerr:
        jc.convert_spynet_state_dict(sd, prefix="module.")
    with pytest.raises(ValueError) as terr:
        tc.convert_spynet_state_dict(sd, prefix="module.")
    assert str(terr.value) == str(jerr.value)
    model = BasicModel(num_blocks=3, num_residual_units=8)
    torch.save(reference_state_dict("wdsr", random_jax_params(model, seed=2)), tmp_path / "w.pt")
    got, want = tc.load_reference_wdsr(str(tmp_path / "w.pt")), jc.load_reference_wdsr(str(tmp_path / "w.pt"))
    assert _same(got[0], _flatten(want[0])) and got[1:] == want[1:] == (3, 8)


def _wn(sd, name):
    v, g = sd[f"{name}.weight_v"], sd[f"{name}.weight_g"]
    return g * v / v.flatten(1).norm(dim=1).reshape(-1, 1, 1, 1), sd[f"{name}.bias"]


def _conv(x, sd, name):
    w, b = _wn(sd, name)
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def test_wdsr_from_a_state_dict_matches_an_independent_forward():
    """The reference WDSR-B's forward written with F.conv2d on the raw state
    dict (weight norm over each output channel, pixel_shuffle) against the
    port's BasicModel loaded through the converter."""
    sd = reference_state_dict("wdsr", random_jax_params(BasicModel(num_blocks=2, num_residual_units=8), seed=3))
    params, blocks = tc.convert_wdsr_basic_state_dict(sd)
    model = load_params_npz(BasicModel(num_blocks=blocks, num_residual_units=8), params).eval()
    x = torch.rand((1, 3, 12, 10), generator=torch.Generator().manual_seed(0))
    xm = x - 0.5
    y = _conv(xm, sd, "head")
    for i in range(blocks):
        h = _conv(F.relu(_conv(y, sd, f"body.{i}.body.0")), sd, f"body.{i}.body.2")
        y = y + _conv(h, sd, f"body.{i}.body.3")
    want = F.pixel_shuffle(_conv(y, sd, "tail"), 2) + F.pixel_shuffle(_conv(xm, sd, "skip.0"), 2) + 0.5
    with torch.no_grad():
        got = model(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_single_from_a_state_dict_matches_an_independent_forward():
    """The reference 'single' forward with F.conv2d and its ConvTranspose2d
    (stride 4, no padding) on the raw state dict against the port's model
    loaded through the converter (the transpose's flipped kernel), at the
    transpose's own output size (no resize)."""
    sd = reference_state_dict("single", random_jax_params(SingleImageModel(channel=8, blocks=2), seed=4))
    params, blocks, ch = tc.convert_single_image_state_dict(sd)
    model = load_params_npz(SingleImageModel(channel=ch, blocks=blocks), params).eval()
    x = torch.rand((2, 3, 6, 7), generator=torch.Generator().manual_seed(1))
    y = _conv(x, sd, "encoder")
    z = y
    for i in range(blocks):
        z = z + _conv(F.relu(_conv(z, sd, f"body.{i}.body.0.body.0")), sd, f"body.{i}.body.0.body.2")
    z = _conv(z, sd, f"body.{blocks}")
    want = F.conv_transpose2d(z + y, sd["shuf.0.weight"], sd["shuf.0.bias"], stride=4)
    with torch.no_grad():
        got = model(x.permute(0, 2, 3, 1)[None], want.shape[2], want.shape[3])[0].permute(0, 3, 1, 2)
    assert got.shape == want.shape == (2, 3, 25, 29)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_load_pretrained_supernet_copies_like_jax(tmp_path):
    """Head, tail and skip (9 tensors) from a WDSR-B of the supernet's width;
    from another width only the skip (its shape depends on the scale
    alone); a NAS-style bare 'skip' too; and
    load_torch_checkpoint falls back to a full unpickle for an mmedit-style
    file with non-tensor entries."""
    nas = random_jax_params(NASModel(num_blocks=2, num_residual_units=8), seed=5)
    for units, n in ((8, 9), (12, 3)):
        sd = reference_state_dict("wdsr", random_jax_params(BasicModel(num_blocks=1, num_residual_units=units), 6))
        got, copied = tc.load_pretrained_supernet(nas, sd)
        want, jcopied = jc.load_pretrained_supernet(_unflatten(nas), {k: v.numpy() for k, v in sd.items()})
        assert copied == jcopied == n and _same(got, _flatten(want))
    sd = {k.replace("skip.0.", "skip."): v for k, v in sd.items()}
    assert tc.load_pretrained_supernet(nas, sd)[1] == jc.load_pretrained_supernet(_unflatten(nas), sd)[1] == 3
    torch.save({"meta": argparse.Namespace(epoch=3), "params": {"w": torch.ones(2)}}, tmp_path / "mm.pth")
    got = tc.load_torch_checkpoint(str(tmp_path / "mm.pth"))
    assert got["meta"].epoch == 3 and torch.equal(got["params"]["w"], torch.ones(2))


def test_load_vsr_eval_params_refuses_like_jax(tmp_path):
    """The block count is checked against the model with JAX's message, the
    mobile 'basic' is refused with JAX's message, and an mmedit
    {"meta", "params"} file is unwrapped."""
    flat = random_jax_params(BasicVSROrigin(num_feat=8, num_block=1), seed=7)
    path = str(tmp_path / "bo.pth")
    torch.save({"meta": {"epoch": 1}, "params": reference_state_dict("basic_origin", flat)}, path)
    model = load_vsr_eval_params(path, "basic_origin", BasicVSROrigin(num_feat=8, num_block=1))
    assert _same({k: p.detach().numpy() for k, p in zip(jax_param_shapes(model), model.parameters())}, flat)
    for kind, port_model, jax_model in (
        ("basic_origin", BasicVSROrigin(num_feat=8, num_block=2), jbasicvsr.BasicVSROrigin(num_feat=8, num_block=2)),
        ("basic", None, None),
    ):
        with pytest.raises(ValueError) as jerr:
            jcli.load_vsr_eval_params(path, kind, jax_model, None)
        with pytest.raises(ValueError) as terr:
            load_vsr_eval_params(path, kind, port_model)
        assert str(terr.value) == str(jerr.value)


def _single_checkpoints(tmp_path):
    """The CLIs' canonical 'single' (32 channels, 8 blocks) as a reference
    .pth and as an npz of the same weights."""
    flat = random_jax_params(get_vsr_model("single", device="cpu"), seed=8)
    torch.save(reference_state_dict("single", flat), tmp_path / "single.pth")
    np.savez(tmp_path / "single.npz", **flat)
    return str(tmp_path / "single.pth"), str(tmp_path / "single.npz")


VSR_DATA = ["--device", "cpu", "--dataset", "synthetic_vsr", "--eval_datasets", "synthetic_vsr", "--model_type",
            "single", "--synthetic_clips", "1", "--synthetic_frames", "2", "--synthetic_size", "32"]


@pytest.mark.parametrize("cli", ["test_vsr", "test_vsr_by_patch", "serve"])
def test_vsr_entry_points_take_a_pth_like_the_npz(tmp_path, cli):
    """--eval_model x.pth through cli.test_vsr, cli.test_vsr_by_patch and
    cli.serve gives exactly what the same weights as an npz give."""
    pth, npz = _single_checkpoints(tmp_path)
    outs = []
    for route, path in (("pth", pth), ("npz", npz)):
        job = str(tmp_path / route)
        if cli == "serve":
            from PIL import Image

            frames = tmp_path / "frames"
            frames.mkdir(exist_ok=True)
            rng = np.random.default_rng(0)
            for i in range(3):
                Image.fromarray((rng.random((8, 8, 3)) * 255).astype(np.uint8)).save(frames / f"{i:02d}.png")
            serve.main(["--job_dir", job, "--input_dir", str(frames), "--model_type", "single", "--device", "cpu",
                        "--eval_model", path, "--chunk_frames", "2", "--chunk_overlap", "1"])
            outs.append(np.stack([np.asarray(Image.open(os.path.join(job, "serve", f)))
                                  for f in sorted(os.listdir(os.path.join(job, "serve")))]))
        elif cli == "test_vsr":
            outs.append(test_vsr.main(["--job_dir", job, *VSR_DATA, "--eval_model", path])["synthetic_vsr"])
        else:
            outs.append(test_vsr_by_patch.main(["--job_dir", job, *VSR_DATA, "--eval_model", path, "--patch_h", "8",
                                                "--patch_w", "8"])["synthetic_vsr"])
        assert os.path.getsize(os.path.join(job, "result.log"))
    if cli == "test_vsr":
        assert outs[0] == outs[1] and np.isfinite(outs[0]["PSNR"])
    else:
        assert np.array_equal(outs[0], outs[1]) and outs[0].size


def test_train_vsr_takes_a_spynet_pth(tmp_path):
    """--spynet_weights x.pth (mmedit's ['params'] with the 'spynet.'
    prefix, or bare keys) loads the same SpyNet as the npz; a prefix that
    matches nothing raises JAX's conversion error."""
    spy = random_jax_params(SpyNet(), seed=9)
    ref = reference_state_dict("spynet", spy)
    torch.save({"params": {f"spynet.{k}": v for k, v in ref.items()}}, tmp_path / "mm.pth")
    torch.save(ref, tmp_path / "bare.pth")
    torch.save({f"module.{k}": v for k, v in ref.items()}, tmp_path / "ddp.pth")
    np.savez(tmp_path / "spy.npz", **spy)
    params = argparse.Namespace(model_type="basic", scale=4, bf16=False, flow_downscale=1, model_path=None, seed=0,
                                eval_model=None)
    loaded = []
    for name in ("mm.pth", "bare.pth", "spy.npz"):
        model = train_vsr.build_vsr_model(params, torch.device("cpu"), str(tmp_path / name))
        loaded.append({k: p.detach().numpy() for k, p in zip(jax_param_shapes(model.spynet),
                                                               model.spynet.parameters())})
    assert _same(loaded[0], loaded[2]) and _same(loaded[1], loaded[2])
    assert _same(loaded[2], {k: v.astype(np.float32) for k, v in spy.items()})
    with pytest.raises(ValueError, match="no SpyNet keys matched prefix ''"):
        train_vsr.build_vsr_model(params, torch.device("cpu"), str(tmp_path / "ddp.pth"))


LOG_LINE = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} (INFO|WARNING|ERROR) ")


def test_result_log_and_profile_trace_on_cpu(tmp_path, monkeypatch):
    """cli.pretrain writes <job_dir>/result.log in the JAX package's line
    format and, with --xla_profile_steps 1, one trace of its first step;
    the profiler's close() is idempotent; a process of RANK 1 writes no
    log."""
    job = tmp_path / "pt"
    pretrain.main(["--job_dir", str(job), "--device", "cpu", "--dataset", "synthetic_isr", "--eval_datasets",
                   "synthetic_isr", "--num_blocks", "1", "--num_residual_units", "8", "--epochs", "1",
                   "--lr_patch_size", "8", "--train_batch_size", "4", "--num_patches", "1", "--xla_profile_steps",
                   "1"])
    lines = open(job / "result.log").read().splitlines()
    assert any("Finish Training" in ln for ln in lines) and LOG_LINE.match(lines[-1])
    traces = [os.path.join(d, f) for d, _, fs in os.walk(job / "profile") for f in fs]
    assert traces == [str(job / "profile" / "train" / "trace.json")]
    events = json.load(open(traces[0]))["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    prof = StepProfiler(str(tmp_path / "p"), 3, name="x")
    prof.step()
    prof.close()
    prof.close()
    assert os.path.exists(tmp_path / "p" / "profile" / "x" / "trace.json")
    monkeypatch.setenv("RANK", "1")
    tool = LoggingTool(str(tmp_path / "rank1"))
    logging.getLogger("msr_torch.test").info("not written")
    assert not tool.is_chief and not os.path.exists(tmp_path / "rank1" / "result.log")
    tool.close()


def test_prepare_dataset_builds_each_split(tmp_path):
    job = tmp_path / "prep"
    counts = prepare_dataset.main(["--job_dir", str(job), "--dataset", "synthetic_vsr", "--synthetic_clips", "2"])
    assert counts == {"train": 4, "eval": 2}  # TRAIN items: 2 clips x 2 patches each
    assert "synthetic_vsr [train]: 4 items cached" in open(job / "result.log").read()
