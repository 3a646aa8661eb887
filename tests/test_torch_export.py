"""Port parity for the deployment side on the CPU: ``export/`` and
``cli/export.py`` (a ``.pt2`` through ``torch.export``, a ``.tflite`` of the
searched net and of each VSR type through tensorflow), exact tiled eval
(``train/eval_tiling.py``, ``--eval_tile``), the approximation ladder
(``analysis/approx_ladder.py``) and ``core/maths.py``, against the JAX
package where it has a counterpart.

Tolerances: an exported program against JAX's forward 1e-5 of the largest
output (float32 convs summed in other orders); a float ``.tflite`` against
the port's CPU forward and JAX's, ``cli.export.check_tolerance`` (1e-4 +
1e-4 of the largest output: TF's convs sum in other orders and the
recurrence carries the flow's difference on); a ``--quantize`` one within
1e-2 of the largest output; the program against the port's own eager
forward, the tiled forward against the whole image, the ladder's video and
the tile starts against JAX's, exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers.jax_compile import unoptimized_xla  # noqa: F401 (a fixture)

from mobilesuperresolution_tpu.analysis.approx_ladder import make_translating_video as j_make_translating_video
from mobilesuperresolution_tpu.core.maths import softmax2 as j_softmax2
from mobilesuperresolution_tpu.models.basicvsr import BasicVSR as JBasicVSR
from mobilesuperresolution_tpu.models.basicvsr import BasicVSROrigin as JBasicVSROrigin
from mobilesuperresolution_tpu.models.mvvsr import MotionVectorVSR as JMotionVectorVSR
from mobilesuperresolution_tpu.models.naive_multi import NaiveMultiModel as JNaiveMultiModel
from mobilesuperresolution_tpu.models.result_net import ResultNet as JResultNet
from mobilesuperresolution_tpu.models.single_image import SingleImageModel as JSingleImageModel
from mobilesuperresolution_tpu.parallel.halo import receptive_radius_wdsr as j_radius
from mobilesuperresolution_tpu.train.eval_tiling import tile_starts as j_tile_starts
from mobilesuperresolution_tpu_torch.analysis.approx_ladder import format_table, make_translating_video, run_ladder
from mobilesuperresolution_tpu_torch.cli import export as export_cli
from mobilesuperresolution_tpu_torch.cli import pretrain
from mobilesuperresolution_tpu_torch.core.maths import softmax2
from mobilesuperresolution_tpu_torch.export import FixedSizeForward, export_onnx, export_pt2, export_tflite, load_pt2
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR, BasicVSROrigin
from mobilesuperresolution_tpu_torch.models.mvvsr import MotionVectorVSR
from mobilesuperresolution_tpu_torch.models.naive_multi import NaiveMultiModel
from mobilesuperresolution_tpu_torch.models.result_net import ResultNet
from mobilesuperresolution_tpu_torch.models.single_image import SingleImageModel
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
def test_pt2_round_trip_matches_jax(tmp_path, kind, unoptimized_xla):
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
    with pytest.raises(RuntimeError, match="tensorflow unavailable"):
        export_tflite(FixedSizeForward(BasicVSR(8, 1, 4), 64, 64), (1, 2, 16, 16, 3), str(tmp_path / "v.tflite"))


def test_tflite_export_of_the_searched_net(tmp_path, capsys):
    """The searched ResultNet (the artifact's 16 blocks of 21 channels, x2,
    seeded weights) as .tflite at 16x16, run in tf.lite.Interpreter: float
    within 1e-4 of the port's CPU forward, --quantize (TFLite's dynamic-range
    int8) within 1e-2 of the largest output, the bound of
    tests/test_torch_quant.py's MODEL_TOL; then cli.export --format tflite
    --quantize with its interpreter check. A quantized port model is
    refused: the converter quantizes the float one."""
    pytest.importorskip("tensorflow")
    from mobilesuperresolution_tpu_torch.export import run_tflite

    m = ResultNet.from_artifact(ARTIFACT, scale=2)
    load_params_npz(m, random_jax_params(m, 4)).eval()
    x = np.random.default_rng(4).random((1, 16, 16, 3), dtype=np.float32)
    with torch.inference_mode():
        want = m(torch.from_numpy(x)).numpy()
    top = np.abs(want).max()
    for quantize, tol in ((False, 1e-4), (True, 1e-2 * top)):
        path = export_tflite(m, x.shape, str(tmp_path / f"r{int(quantize)}.tflite"), quantize=quantize)
        got = run_tflite(path, x)
        assert got.shape == want.shape == (1, 32, 32, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert os.path.getsize(tmp_path / "r1.tflite") < os.path.getsize(tmp_path / "r0.tflite") / 2  # int8 weights
    out = export_cli.main(["--block_index", ARTIFACT, "--out", str(tmp_path / "c"), "--height", "16", "--width", "16",
                           "--format", "tflite", "--quantize"])
    assert out["paths"] == {"tflite": str(tmp_path / "c.tflite")}
    assert out["tflite_check"]["max_abs_err"] <= out["tflite_check"]["tol"]
    assert '"tflite_check"' in capsys.readouterr().out
    with pytest.raises(ValueError, match="export the float BasicVSR"):
        export_tflite(FixedSizeForward(BasicVSR(8, 1, 4, quantized=True), 8, 8), (1, 2, 2, 2, 3), str(tmp_path / "q"))


# each VSR type at a tiny width (nf 8 and 1 block, 'single' 8 channels and 2
# blocks, 'multi' IDX), x4, on 2 frames: (port model, JAX model, LR size,
# input channels)
VSR_TFLITE = {
    "basic": (lambda: BasicVSR(8, 1, 4), lambda: JBasicVSR(num_feat=8, num_block=1, scale=4), 32, 3),
    "basic_origin": (lambda: BasicVSROrigin(8, 1, 4), lambda: JBasicVSROrigin(num_feat=8, num_block=1, scale=4), 32,
                     3),
    "basic_mv": (lambda: MotionVectorVSR(8, 1, 4), lambda: JMotionVectorVSR(num_feat=8, num_block=1, scale=4), 16, 5),
    "single": (lambda: SingleImageModel(4, 8, 2), lambda: JSingleImageModel(scale=4, channel=8, blocks=2), 16, 3),
    "multi": (lambda: NaiveMultiModel(4, IDX), lambda: JNaiveMultiModel(scale=4, idx=IDX), 32, 3),
}


@pytest.mark.parametrize("kind", list(VSR_TFLITE))
def test_tflite_vsr_matches_port_and_jax(tmp_path, kind, unoptimized_xla):
    """Each VSR type the JAX CLI exports as .tflite, from the bridge's seeded
    weights: the interpreter's output within check_tolerance of the port's
    CPU forward and of the JAX package's jitted forward on the same weights
    (16x16 LR, 32x32 for the SpyNet types, whose pyramid then reaches 1x1;
    'basic_mv''s motion vectors up to 3 pixels)."""
    pytest.importorskip("tensorflow")
    from mobilesuperresolution_tpu_torch.export import run_tflite

    make, make_j, hw, c = VSR_TFLITE[kind]
    m = make()
    flat = random_jax_params(m, seed=5)
    load_params_npz(m, flat).eval()
    x = np.random.default_rng(5).random((1, 2, hw, hw, c), dtype=np.float32)
    if c == 5:
        x[..., 3:] = 6 * x[..., 3:] - 3
    module = FixedSizeForward(m, 4 * hw, 4 * hw)
    with torch.inference_mode():
        want = module(torch.from_numpy(x))
    got = run_tflite(export_tflite(module, x.shape, str(tmp_path / f"{kind}.tflite")), x)
    jm = make_j()
    jwant = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a, 4 * hw, 4 * hw))(_tree(flat), jnp.asarray(x)))
    tol = export_cli.check_tolerance(want)
    assert got.shape == tuple(want.shape) == (1, 2, 4 * hw, 4 * hw, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got, jwant, rtol=0, atol=tol)


def test_tflite_vsr_cli_float_and_quantized(tmp_path, capsys):
    """cli.export --model_type basic --format tflite at its full width (nf
    24, 8 blocks, x4) on 2 frames of 32x32, float and --quantize, each
    checked by the CLI in the interpreter (float within check_tolerance,
    int8 within 1e-2 of the largest output); the int8 file under half the
    float one (int8 weights)."""
    pytest.importorskip("tensorflow")
    base = ["--model_type", "basic", "--scale", "4", "--height", "32", "--width", "32", "--frames", "2", "--format",
            "tflite"]
    for name, extra in (("f", []), ("q", ["--quantize"])):
        out = export_cli.main([*base, "--out", str(tmp_path / name), *extra])
        assert out["paths"] == {"tflite": str(tmp_path / f"{name}.tflite")}
        assert out["tflite_check"]["max_abs_err"] <= out["tflite_check"]["tol"]
    assert capsys.readouterr().out.count('"tflite_check"') == 2
    assert os.path.getsize(tmp_path / "q.tflite") < os.path.getsize(tmp_path / "f.tflite") / 2


@pytest.mark.parametrize("n_in,n_out", [(7, 16), (16, 7), (13, 13), (5, 1), (1, 4)])
def test_tflite_resize_and_warp_builders(n_in, n_out):
    """The TF builders alone against the port's ops: ``resize_bilinear``
    (half-pixel centres and align_corners) at odd, up and down sizes, and
    ``flow_warp`` with flows that reach past the frame, in both padding
    modes. The warp's arithmetic is the port's: within 1e-6 of the largest
    input (the blends round in another order). The resize blends with
    ``linear_resize_matrix``'s float64 weights, where torch computes its
    source coordinates in float32, off by up to one ulp of the larger size:
    within 4 such ulps of the largest input."""
    tf = pytest.importorskip("tensorflow")
    from mobilesuperresolution_tpu_torch.export.tflite_vsr import TFOps
    from mobilesuperresolution_tpu_torch.ops.resize import resize_bilinear
    from mobilesuperresolution_tpu_torch.ops.warp import flow_warp

    ops = TFOps()
    rng = np.random.default_rng(n_in * 31 + n_out)
    x = rng.standard_normal((2, n_in, n_in + 2, 3)).astype(np.float32)
    top = np.abs(x).max()
    for ac in (False, True):
        want = resize_bilinear(torch.from_numpy(x), (n_out, n_out + 3), align_corners=ac).numpy()
        got = ops.resize(tf.constant(x), (n_out, n_out + 3), align_corners=ac).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0 ** -23 * max(n_in, n_out + 3) * top)
    flow = (rng.random((2, n_in, n_in + 2, 2)) * (n_in + 5) - (n_in + 5) / 2).astype(np.float32)
    for mode in ("zeros", "border"):
        want = flow_warp(torch.from_numpy(x), torch.from_numpy(flow), mode).numpy()
        got = ops.flow_warp(tf.constant(x), tf.constant(flow), mode).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * top)


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
