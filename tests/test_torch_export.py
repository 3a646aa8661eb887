"""Port parity for the deployment side on the CPU: ``export/`` and
``cli/export.py`` (a ``.pt2`` through ``torch.export``), exact tiled eval
(``train/eval_tiling.py``, ``--eval_tile``), the approximation ladder
(``analysis/approx_ladder.py``) and ``core/maths.py``, against the JAX
package where it has a counterpart.

Tolerances: an exported program against JAX's forward 1e-5 of the largest
output (float32 convs summed in other orders); the program against the
port's own eager forward, the tiled forward against the whole image, the
ladder's video and the tile starts against JAX's, exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.analysis.approx_ladder import make_translating_video as j_make_translating_video
from mobilesuperresolution_tpu.core.maths import softmax2 as j_softmax2
from mobilesuperresolution_tpu.models.basicvsr import BasicVSR as JBasicVSR
from mobilesuperresolution_tpu.models.result_net import ResultNet as JResultNet
from mobilesuperresolution_tpu.parallel.halo import receptive_radius_wdsr as j_radius
from mobilesuperresolution_tpu.train.eval_tiling import tile_starts as j_tile_starts
from mobilesuperresolution_tpu_torch.analysis.approx_ladder import format_table, make_translating_video, run_ladder
from mobilesuperresolution_tpu_torch.cli import export as export_cli
from mobilesuperresolution_tpu_torch.cli import pretrain
from mobilesuperresolution_tpu_torch.core.maths import softmax2
from mobilesuperresolution_tpu_torch.export import FixedSizeForward, export_onnx, export_pt2, export_tflite, load_pt2
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
from mobilesuperresolution_tpu_torch.models.result_net import ResultNet
from mobilesuperresolution_tpu_torch.models.wdsr_basic import BasicModel
from mobilesuperresolution_tpu_torch.parallel.halo import receptive_radius_wdsr
from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params
from mobilesuperresolution_tpu_torch.train.eval_tiling import make_tiled_forward, tile_starts

torch.set_num_threads(2)
IDX = ((8, 8, 3), (8, 6, 5))
ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "search_depth_tpu", "block_index.txt")


def _tree(flat):
    out = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        d = out
        for s in scope:
            d = d.setdefault(s, {})
        d[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("kind", ["result", "basic"])
def test_pt2_round_trip_matches_jax(tmp_path, kind):
    """A .pt2 of a tiny ResultNet and of a 2-frame BasicVSR, saved and
    loaded, equals the port's eager forward exactly and JAX's forward within
    1e-5 of the largest output."""
    if kind == "result":
        m, jm, shape, args = ResultNet(2, IDX), JResultNet(2, IDX), (1, 12, 14, 3), ()
    else:
        m, jm, shape, args = BasicVSR(8, 1, 4), JBasicVSR(num_feat=8, num_block=1, scale=4), (1, 2, 16, 16, 3), (64, 64)
    flat = random_jax_params(m, seed=2)
    load_params_npz(m, flat).eval()
    module = FixedSizeForward(m, *args) if args else m
    x = torch.from_numpy(np.random.default_rng(2).random(shape, dtype=np.float32))
    path = export_pt2(module, x, str(tmp_path / f"{kind}.pt2"))
    with torch.inference_mode():
        got = load_pt2(path)(x)
        eager = module(x)
    want = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a, *args))(_tree(flat), jnp.asarray(x.numpy())))
    assert torch.equal(got, eager)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_export_cli_and_refused_formats(tmp_path, monkeypatch, capsys):
    """cli.export writes the searched net's .pt2 (JAX's 'stablehlo' is its
    alias) and checks it on the CPU; onnx and tflite raise naming the
    missing package; onnx for a VSR type is a usage error, as in JAX."""
    out = export_cli.main(["--block_index", ARTIFACT, "--out", str(tmp_path / "r"), "--height", "12", "--width",
                           "16", "--format", "stablehlo", "--device", "cpu"])
    assert out["paths"] == {"pt2": str(tmp_path / "r.pt2")}
    assert out["check"]["max_abs_err"] == 0.0 and out["check"]["device"] == "cpu"
    assert '"artifact_check"' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        export_cli.main(["--model_type", "basic", "--out", str(tmp_path / "b"), "--format", "onnx"])
    net = ResultNet(2, IDX)
    try:
        import onnx  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="the 'onnx' package is required for ONNX export"):
            export_onnx(net, (1, 12, 14, 3), str(tmp_path / "r.onnx"))
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # as on a machine without it
    with pytest.raises(RuntimeError, match="tensorflow unavailable"):
        export_tflite(net, (1, 12, 14, 3), str(tmp_path / "r.tflite"))


def test_tile_starts_and_radius_match_jax():
    for n in (48, 65, 100, 130):
        for tile, stride in ((48, 36), (32, 20)):
            if n >= tile:
                assert tile_starts(n, tile, stride) == j_tile_starts(n, tile, stride)
    assert all(receptive_radius_wdsr(nb, k) == j_radius(nb, k) for nb in (1, 16) for k in (3, 7))


def test_tiled_forward_is_exact_and_runs_in_pretrain(tmp_path):
    """The tiled forward equals the whole-image forward bit for bit on the
    CPU (ragged, small, elongated images; the tile shapes recorded), and
    cli.pretrain --eval_only --eval_tile scores the eval set through it with
    the whole-image metrics."""
    m = load_params_npz(BasicModel(2, 8, 2), random_jax_params(BasicModel(2, 8, 2), seed=1)).eval()

    def fwd(lr):
        with torch.inference_mode():
            return m(lr)

    tiled = make_tiled_forward(fwd, scale=2, radius=receptive_radius_wdsr(2, 3) + 2, tile=32)
    rng = np.random.default_rng(0)
    for h, w in ((45, 61), (32, 32), (20, 70), (70, 20)):
        lr = torch.from_numpy(rng.random((1, h, w, 3), dtype=np.float32))
        assert torch.equal(tiled(lr), fwd(lr)), (h, w)
    assert {(32, 32), (20, 32), (32, 20)} <= tiled.shapes_used
    base = ["--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--device", "cpu", "--eval_only",
            "--num_blocks", "2", "--num_residual_units", "8"]
    whole = pretrain.main(["--job_dir", str(tmp_path / "w"), *base])["synthetic_isr"]
    tiles = pretrain.main(["--job_dir", str(tmp_path / "t"), *base, "--eval_tile", "48"])["synthetic_isr"]
    assert tiles == whole


def test_translating_video_matches_jax():
    for kw in (dict(t=4, h=16, w=16, scale=2), dict(t=3, h=10, w=12, scale=4, lr_noise=0.05)):
        lr, hr = make_translating_video(0, **kw)
        jlr, jhr = j_make_translating_video(0, **kw)
        np.testing.assert_array_equal(lr, jlr)
        np.testing.assert_array_equal(hr, jhr)


def test_run_ladder_has_jax_keys():
    """A few-step ladder on the CPU: the JAX package's keys, every number
    finite, and a table line per rung."""
    res = run_ladder(train_steps=2, t_eval=6, h=16, w=16, chunk=2, downscales=(2,), overlaps=(0, 1))
    assert set(res) == {"exact_psnr", "flow_downscale", "chunk_overlap", "quantize_int8"}
    assert set(res["flow_downscale"]) == {2} and set(res["chunk_overlap"]) == {0, 1}
    rungs = [res["quantize_int8"], *res["flow_downscale"].values(), *res["chunk_overlap"].values()]
    assert all({"agreement", "psnr", "delta"} <= set(r) for r in rungs)
    assert np.isfinite(res["exact_psnr"]) and all(np.isfinite(v) for r in rungs for v in r.values())
    assert "interior_agreement" in res["chunk_overlap"][1]
    assert len(format_table(res).splitlines()) == 4 + 1 + 2 + 1


def test_softmax2_matches_jax():
    for a, b in ((0.3, -1.2), (1e4, 1e4 - 1.0), (-50.0, 50.0)):
        pa, pb = softmax2(a, b)
        ja, jb = j_softmax2(jnp.float32(a), jnp.float32(b))
        # XLA's CPU flushes a subnormal exp to zero where torch keeps it
        np.testing.assert_allclose([float(pa), float(pb)], [float(ja), float(jb)], rtol=1e-6, atol=1e-37)
        assert abs(float(pa + pb) - 1.0) < 1e-6
