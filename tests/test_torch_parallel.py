"""The port's parallel layer in one process, held against the JAX package and
against the port's own unsharded paths: the window helpers, the exact
height-sharded SISR forward and step, the height-sharded BasicVSR /
BasicVSROrigin forward and step (one case against JAX's sharded forward on a
2-device mesh with the flow clip active), the trunk's row mask, the
per-process batch split, the mesh, the refusals, and --spatial_shards
through cli.pretrain, cli.train_vsr, cli.test_vsr and cli.serve.
(Two-process runs: tests/test_torch_parallel_multiprocess.py.)

Tolerances: the windows compute every kept output pixel from the same
inputs as the full frame, so a forward, a loss and one Adam step agree to
float summation order (1e-6 at these sizes, 2e-5 through a VSR trunk's
recurrence)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers.meshes import spatial_mesh
from mobilesuperresolution_tpu.cli import common_cli as j_common_cli
from mobilesuperresolution_tpu.data import isr as j_isr
from mobilesuperresolution_tpu.models import basicvsr as jb
from mobilesuperresolution_tpu.parallel import halo as j_halo
from mobilesuperresolution_tpu.parallel.vsr_spatial import spatial_basicvsr_forward as j_spatial_basicvsr_forward
from mobilesuperresolution_tpu_torch.cli import common_cli, pretrain, serve, test_vsr, test_vsr_by_patch, train_vsr
from mobilesuperresolution_tpu_torch.data import isr
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR, BasicVSROrigin
from mobilesuperresolution_tpu_torch.models.wdsr_basic import BasicModel
from mobilesuperresolution_tpu_torch.parallel import halo
from mobilesuperresolution_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from mobilesuperresolution_tpu_torch.parallel.spatial_train import make_spatial_sisr_step
from mobilesuperresolution_tpu_torch.parallel.temporal import chunked_vsr_apply
from mobilesuperresolution_tpu_torch.parallel.vsr_spatial import (
    make_spatial_vsr_step,
    spatial_basicvsr_forward,
    trunk_radius,
)
from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters, load_params_npz, random_jax_params
from mobilesuperresolution_tpu_torch.train.state import multistep_adam, spynet_frozen_mask, vsr_multistep_adam
from mobilesuperresolution_tpu_torch.train.steps import make_sisr_step, make_vsr_step

torch.set_num_threads(2)


def _tree(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = jnp.asarray(arr)
    return tree


@pytest.mark.parametrize("h,n,radius", [(24, 2, 3), (24, 3, 4), (30, 3, 5), (16, 1, 2)])
def test_window_helpers_match_jax(h, n, radius):
    x = np.random.default_rng(h + n).random((2, h, 5, 3)).astype(np.float32)
    assert halo.shard_offsets(h, n, radius) == j_halo.shard_offsets(h, n, radius)
    got = torch.stack(halo.build_windows(torch.from_numpy(x), n, radius))
    want = np.asarray(j_halo.build_windows(jnp.asarray(x), n, radius))
    np.testing.assert_array_equal(got.numpy(), want)
    y = np.repeat(np.repeat(want, 2, axis=2), 2, axis=3)  # a "scale 2" output per window
    np.testing.assert_array_equal(halo.crop_concat(torch.from_numpy(y), h, n, radius, scale=2).numpy(),
                                  np.asarray(j_halo.crop_concat(jnp.asarray(y), h, n, radius, scale=2)))


@pytest.mark.parametrize("h,n,radius,match", [(25, 2, 3, "not divisible"), (24, 4, 4, "must be >= 2")])
def test_check_shardable_refuses_as_jax(h, n, radius, match):
    for check in (halo._check_shardable, j_halo._check_shardable):
        with pytest.raises(ValueError, match=match):
            check(h, n, radius)
    with pytest.raises(ValueError, match=match):
        halo.spatially_sharded_apply(lambda a: a, torch.zeros(1, h, 4, 3), n, radius)


def _wdsr(seed=1):
    m = BasicModel(num_blocks=2, num_residual_units=8, scale=2)
    return load_params_npz(m, random_jax_params(m, seed))


@pytest.mark.parametrize("n", [2, 3])
def test_spatially_sharded_apply_matches_full_frame(n):
    m = _wdsr().eval()
    x = torch.from_numpy(np.random.default_rng(n).random((2, 24, 20, 3)).astype(np.float32))
    radius = halo.receptive_radius_wdsr(2)
    with torch.inference_mode():
        want = m(x)
        got = halo.spatially_sharded_apply(m, x, Mesh(n, "cpu"), radius, scale=2)
        assert torch.equal(halo.spatially_sharded_apply(m, x, 1, radius, scale=2), want)
    assert got.shape == want.shape == (2, 48, 40, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_spatial_sisr_step_matches_plain():
    """A step of the sharded step (S = 2) against the plain one on the same
    batch: the loss and every parameter after it within 1e-6."""
    rng = np.random.default_rng(4)
    batches = [(torch.from_numpy(rng.random((2, 24, 12, 3), np.float32)),
                torch.from_numpy(rng.random((2, 48, 24, 3), np.float32)))]
    runs = []
    for sharded in (False, True):
        m = _wdsr().train()
        opt = multistep_adam(jax_named_parameters(m), 1e-3, 10, 1)
        step = (make_spatial_sisr_step(m, opt, Mesh(2, "cpu"), halo.receptive_radius_wdsr(2), 2) if sharded
                else make_sisr_step(m, opt))
        runs.append(([float(step(b)["loss"]) for b in batches], [p.detach().clone() for p in m.parameters()]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], atol=1e-6)
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


def _vsr(cls, seed=1, dtype=torch.float32):
    m = cls(num_feat=8, num_block=1, compute_dtype=dtype)
    return load_params_npz(m, random_jax_params(m, seed))


@pytest.mark.parametrize("cls,n", [(BasicVSR, 2), (BasicVSR, 4), (BasicVSROrigin, 2), (BasicVSROrigin, 4)])
def test_spatial_vsr_forward_matches_plain(cls, n):
    m = _vsr(cls).eval()
    x = torch.from_numpy(np.random.default_rng(n).random((1, 3, 32, 16, 3)).astype(np.float32))
    with torch.inference_mode():
        want = m(x, 128, 64)
        got = spatial_basicvsr_forward(m, x, 128, 64, Mesh(n, "cpu"), max_disp=4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    mb = _vsr(cls, dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        assert spatial_basicvsr_forward(mb, x, 128, 64, n, max_disp=4).dtype == torch.float32


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_spatial_vsr_forward_matches_jax_with_flow_clip(quantized):
    """The port's sharded forward against JAX's on a 2-device mesh, both fed
    the same precomputed flows whose dy reaches 3x max_disp, so both clip;
    the plain forward on those flows differs. int8: both quantize each
    shard's trunk window with its own per-sample scale (JAX's trunk runs
    inside shard_map), so the reference is JAX's sharded int8 forward, held
    within 1e-2 of the largest output (tests/test_torch_quant.py's
    MODEL_TOL); the sharded int8 forward is held to the port's unsharded
    int8 one, on flows that the clip leaves alone, only within that bound."""
    tm = BasicVSR(num_feat=8, num_block=1, quantized=quantized)
    flat = random_jax_params(tm, 2)
    load_params_npz(tm, flat)
    tm.eval()
    rng = np.random.default_rng(7)
    x = rng.random((1, 3, 32, 16, 3)).astype(np.float32)
    ff, fb = ((rng.random((2, 1, 32, 16, 2)).astype(np.float32) - 0.5) * 24 for _ in range(2))
    jm = jb.BasicVSR(num_feat=8, num_block=1, scale=4, quantized=quantized)
    mesh = spatial_mesh(jax.devices(), 2)
    want = np.asarray(jax.jit(lambda p, a, f, g: j_spatial_basicvsr_forward(
        jm, p, a, 128, 64, mesh, max_disp=4, flows=(f, g)))(_tree(flat), x, ff, fb))
    flows = (torch.from_numpy(ff), torch.from_numpy(fb))
    with torch.inference_mode():
        got = spatial_basicvsr_forward(tm, torch.from_numpy(x), 128, 64, Mesh(2, "cpu"), max_disp=4, flows=flows)
        plain = tm(torch.from_numpy(x), 128, 64, flows=flows)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2 * np.abs(want).max() if quantized else 2e-5)
    assert float((plain - got).abs().max()) > 1e-3
    if quantized:
        assert np.abs(got.numpy() - want).mean() < 1e-3 * np.abs(want).max()  # rounding flips are rare
        small = tuple(f / 12 for f in flows)  # |dy| <= 1 <= max_disp: the clip does nothing
        with torch.inference_mode():
            sharded = spatial_basicvsr_forward(tm, torch.from_numpy(x), 128, 64, Mesh(2, "cpu"), max_disp=4,
                                               flows=small)
            whole = tm(torch.from_numpy(x), 128, 64, flows=small)
        np.testing.assert_allclose(sharded.numpy(), whole.numpy(), atol=1e-2 * float(whole.abs().max()))


def test_spatial_vsr_step_matches_plain():
    """Two sharded VSR steps (S = 2) against the plain ones: the losses
    within 1e-6 and every parameter within 2e-5 (Adam's first steps move
    by lr times the gradient's sign where the gradient is rounding-small)."""
    rng = np.random.default_rng(8)
    batches = [(torch.from_numpy(rng.random((1, 3, 32, 16, 3), np.float32)),
                torch.from_numpy(rng.random((1, 3, 128, 64, 3), np.float32))) for _ in range(2)]
    runs = []
    for sharded in (False, True):
        m = _vsr(BasicVSR).train()
        named = jax_named_parameters(m)
        opt = vsr_multistep_adam(named, 1e-4, 10, 1, trainable_mask=spynet_frozen_mask(named))
        step = (make_spatial_vsr_step(m, opt, Mesh(2, "cpu"), (128, 64), max_disp=8) if sharded
                else make_vsr_step(m, opt, (128, 64)))
        runs.append(([float(step(b)["loss"]) for b in batches], [p.detach().clone() for p in m.parameters()]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], atol=1e-6)
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-5)


def test_row_mask_none_is_the_plain_trunk():
    trunk = _vsr(BasicVSR).propagation.trunks.eval()
    y = torch.from_numpy(np.random.default_rng(9).random((2, 6, 5, 22)).astype(np.float32))
    with torch.inference_mode():
        plain = trunk(y)
        assert torch.equal(trunk(y, row_mask=None), plain)
        assert torch.equal(trunk(y, row_mask=torch.ones(1, 6, 1, 1)), plain)
        masked = trunk(y, row_mask=torch.tensor([0.0, 1, 1, 1, 1, 0]).view(1, 6, 1, 1))
    assert float(masked[:, [0, 5]].abs().max()) == 0.0


@pytest.mark.parametrize("p", [2, 3])
def test_batches_shard_by_process_match_jax(monkeypatch, p):
    """Each process's slice of an epoch against the JAX package's (jax's
    process count and index patched alike): the same seed and shuffle, the
    order wrap-padded to a multiple of the process count; and the steps per
    epoch per process."""

    class DS:
        def __len__(self):
            return 10

        def item(self, i, rng):
            return np.full((1,), i, np.float32), np.full((1,), rng.random(), np.float32)

    per_rank = []
    for r in range(p):
        monkeypatch.setattr(isr, "process_count", lambda: p)
        monkeypatch.setattr(isr, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: p)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        got = list(isr.batch_iterator(DS(), 2, shuffle=True, seed=3, drop_last=True, shard_by_process=True))
        want = list(j_isr._batches(DS(), 2, True, 3, True, shard_by_process=True))
        assert len(got) == len(want) == -(-10 // p) // 2
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        per_rank.append([a.ravel().tolist() for a, _ in got])
        monkeypatch.setattr(common_cli.distributed, "process_count", lambda: p)
        assert common_cli.train_steps_per_epoch(10, 2) == j_common_cli.train_steps_per_epoch(10, 2)
    if p == 2:  # step k's items over the processes are one process's batch k at the global batch size
        monkeypatch.setattr(isr, "process_count", lambda: 1)
        monkeypatch.setattr(isr, "process_index", lambda: 0)
        whole = [a.ravel().tolist() for a, _ in isr.batch_iterator(DS(), 4, shuffle=True, seed=3, drop_last=True)]
        assert [sorted(a + b) for a, b in zip(*per_rank)] == [sorted(w) for w in whole]


def test_mesh_and_refusals(tmp_path):
    mesh = make_mesh(spatial=3, device="cpu")
    assert mesh.shape == {"data": 1, "spatial": 3} and mesh.devices == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(data=2, device="cpu")
    lr, hr = shard_batch(mesh, (np.zeros((1, 2), np.float32), torch.ones(1)))
    assert lr.device.type == hr.device.type == "cpu"
    m = _vsr(BasicVSR).eval()
    with pytest.raises(ValueError, match="not divisible"):
        spatial_basicvsr_forward(m, torch.zeros(1, 2, 30, 8, 3), 120, 32, 4)
    with pytest.raises(ValueError, match="trunk radius \\+ max_disp = 11"):
        spatial_basicvsr_forward(m, torch.zeros(1, 2, 32, 8, 3), 128, 32, 4)
    assert trunk_radius(8) == 17 and trunk_radius(30) == 61
    from mobilesuperresolution_tpu_torch.models import get_vsr_model

    with pytest.raises(TypeError, match="BasicVSR / BasicVSROrigin"):
        spatial_basicvsr_forward(get_vsr_model("basic_mv", device="cpu"), torch.zeros(1, 2, 32, 8, 5), 8, 8, 2)
    base = ["--job_dir", str(tmp_path), "--device", "cpu", "--dataset", "synthetic_vsr", "--eval_datasets"]
    with pytest.raises(SystemExit, match="supports model_type=basic/basic_origin"):
        train_vsr.main(base + ["--spatial_shards", "2", "--model_type", "single"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        test_vsr.main(base + ["--spatial_shards", "2", "--chunk_frames", "2"])
    with pytest.raises(ValueError, match="--spatial_shards applies to full-frame eval"):
        test_vsr_by_patch.main(base + ["--spatial_shards", "2"])
    with pytest.raises(ValueError, match="requires --num_processes and --process_id"):
        pretrain.main(base[:2] + ["--device", "cpu", "--coordinator_address", "localhost:1"])
    clip = torch.from_numpy(np.random.default_rng(0).random((1, 9, 4, 4, 3), np.float32))
    assert mesh.data_devices == [torch.device("cpu")]
    assert torch.equal(chunked_vsr_apply(lambda a, h, w: a * 2, clip, 4, 4, 2, 1, mesh=mesh), clip * 2)
    with pytest.raises(ValueError, match="a group of 2 members on 1 data slots"):
        mesh.map_data(lambda a: a, [clip, clip])


def test_spatial_shards_sisr_entry_point(tmp_path):
    """cli.pretrain --spatial_shards 2 against the unsharded run: the same
    per-step losses and weights within 1e-6."""
    base = ["--device", "cpu", "--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--num_blocks",
            "2", "--num_residual_units", "8", "--epochs", "1", "--lr_patch_size", "16", "--train_batch_size", "4",
            "--num_patches", "1"]
    outs = [pretrain.main(["--job_dir", str(tmp_path / k)] + base + flag)
            for k, flag in (("plain", []), ("sharded", ["--spatial_shards", "2"]))]
    np.testing.assert_allclose([s["loss"] for s in outs[1]["steps"]], [s["loss"] for s in outs[0]["steps"]],
                               atol=1e-6)
    a, b = (np.load(tmp_path / k / "weights" / "models.npz") for k in ("plain", "sharded"))
    for key in a:
        np.testing.assert_allclose(b[key], a[key], atol=1e-6, err_msg=key)
    small = [a if a != "16" else "8" for a in base]
    with pytest.raises(ValueError, match="shard height 4 must be >= 2\\*radius=8"):
        pretrain.main(["--job_dir", str(tmp_path / "small"), "--spatial_shards", "2"] + small)


def _serve(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _read(d):
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))]).astype(np.float32)


def test_spatial_shards_vsr_entry_points(tmp_path):
    """The full 'basic' model (nf 24, 8 blocks: rt 17) on 36x36 LR frames, S
    = 2 with --spatial_max_disp 1 (R 18 <= 18 rows a shard): cli.train_vsr
    (a step and its eval) against the unsharded run, cli.test_vsr on the
    unsharded run's npz against that run's eval, and cli.serve plain and
    flow-cached against the unsharded stream. Synthetic motion is below a
    pixel a frame, so the clip is inactive and every pair agrees to float
    order: the loss and PSNR within 1e-5, weights within 2e-5, served PNGs
    within one 8-bit level."""
    from PIL import Image

    data = ["--device", "cpu", "--dataset", "synthetic_vsr", "--eval_datasets", "synthetic_vsr", "--synthetic_frames",
            "2", "--image_batch", "2", "--synthetic_clips", "1", "--synthetic_size", "144", "--spatial_max_disp", "1"]
    train = data + ["--epochs", "1", "--lr_patch_size", "36", "--ignored_boundary_size", "0", "--train_batch_size",
                    "1", "--num_patches", "1"]
    sp = ["--spatial_shards", "2"]
    runs = {k: train_vsr.main(["--job_dir", str(tmp_path / k)] + train + f) for k, f in (("p", []), ("s", sp))}
    np.testing.assert_allclose([s["loss"] for s in runs["s"]["steps"]], [s["loss"] for s in runs["p"]["steps"]],
                               atol=1e-5)
    psnr = {k: r["eval"][-1]["synthetic_vsr"]["PSNR"] for k, r in runs.items()}
    np.testing.assert_allclose(psnr["s"], psnr["p"], atol=1e-5)
    a, b = (np.load(tmp_path / k / "weights" / "models.npz") for k in ("p", "s"))
    for key in a:
        np.testing.assert_allclose(b[key], a[key], atol=2e-5, err_msg=key)
    npz = str(tmp_path / "p" / "weights" / "models.npz")
    ev = test_vsr.main(["--job_dir", str(tmp_path / "e"), "--eval_model", npz] + data + sp)
    np.testing.assert_allclose(ev["synthetic_vsr"]["PSNR"], psnr["p"], atol=1e-5)

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.random((36, 20, 3)) * 255).astype(np.uint8)).save(frames / f"{i:04d}.png")
    served = {}
    for k, f in (("p", []), ("s", sp), ("sc", sp + ["--flow_cache"])):
        job = tmp_path / f"serve_{k}"
        stats = _serve(["--job_dir", str(job), "--input_dir", str(frames), "--eval_model", npz, "--chunk_frames", "2",
                        "--chunk_overlap", "1", "--device", "cpu", "--spatial_max_disp", "1"] + f)
        assert stats["frames"] == 4
        served[k] = _read(job / "serve")
    assert served["p"].shape == (4, 144, 80, 3)
    for k in ("s", "sc"):  # the flow-cached stream is the plain one's to float tolerance
        assert np.abs(served[k] - served["p"]).max() <= 1
