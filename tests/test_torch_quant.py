"""Port parity for the int8 dynamic-range path (ops/quant.py, kernel Q1's
plain version kernels/qconv_int8.py, the quantized models and the entry
points that take ``--quantize int8``) against the JAX package, on the CPU.

The quantization primitives and ``qconv2d`` equal JAX's bit for bit: the
same float32 scales, round half to even, an exact integer conv (float64
here, int32 in XLA) and the rescale ``acc * (xs * ks) + bias`` in the same
order. The models get the bridge's seeded weights on both sides (no JAX
init compiled) and one jitted JAX forward each at the tiniest shape.

Model tolerance: 1e-2 of the largest output, a little over one int8 step
(1/127 of a sample's max). Upstream of each quantized conv the two sides'
float32 convs sum in other orders, and a weight-normed kernel's norm too, so
an activation whose x / scale lies within an ulp of a rounding midpoint can
round to the neighbouring int8 on one side: one step in one input of one
conv, which the layers after it carry on. Seen: 1e-7 of the largest output
for the SISR nets, up to 2.6e-3 for 'multi' (SpyNet's flows feed a warp).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilesuperresolution_tpu.models import get_model as j_get_model
from mobilesuperresolution_tpu.models import get_vsr_model as j_get_vsr_model
from mobilesuperresolution_tpu.models.basicvsr import BasicVSR as JBasicVSR
from mobilesuperresolution_tpu.models.mvvsr import MotionVectorVSR as JMotionVectorVSR
from mobilesuperresolution_tpu.models.naive_multi import NaiveMultiModel as JNaiveMultiModel
from mobilesuperresolution_tpu.models.result_net import ResultNet as JResultNet
from mobilesuperresolution_tpu.models.single_image import SingleImageModel as JSingleImageModel
from mobilesuperresolution_tpu.models.wdsr_basic import BasicModel as JBasicModel
from mobilesuperresolution_tpu.ops import quant as jq
from mobilesuperresolution_tpu_torch.cli import pretrain, retrain_searched, serve, test_vsr, train_vsr
from mobilesuperresolution_tpu_torch.kernels.qconv_int8 import (
    act_scale,
    act_scale_plain,
    co_tile,
    n_tile,
    pack_weights,
    packed_shape,
    qconv_int8,
    qconv_int8_plain,
    quantize_plain,
    tensor_cores,
)
from mobilesuperresolution_tpu_torch.models import get_model, get_vsr_model
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
from mobilesuperresolution_tpu_torch.models.mvvsr import MotionVectorVSR
from mobilesuperresolution_tpu_torch.models.naive_multi import NaiveMultiModel
from mobilesuperresolution_tpu_torch.models.result_net import ResultNet
from mobilesuperresolution_tpu_torch.models.single_image import SingleImageModel
from mobilesuperresolution_tpu_torch.models.wdsr_basic import BasicModel
from mobilesuperresolution_tpu_torch.ops import quant as tq
from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
ARTIFACT = os.path.join(ROOT, "artifacts", "search_depth_tpu", "block_index.txt")
IDX = ((8, 8, 3), (8, 6, 5))
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
MODEL_TOL = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


def _tree(flat):
    out = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        d = out
        for s in scope:
            d = d.setdefault(s, {})
        d[leaf] = jnp.asarray(v)
    return out


@pytest.fixture(scope="module")
def conv_case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17, 19, 54)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 54, 48)) * 0.1).astype(np.float32)  # HWIO
    b = rng.standard_normal(48).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_quantize_symmetric_and_kernel_match_jax(conv_case, dt):
    """The per-sample activation scales and int8 values, the per-tensor
    ones, the per-output-channel kernel's, and the all-zero tensor's floor,
    bit for bit; Q1s's plain version (and its wrapper on the CPU) gives the
    per-sample scales, and quantize_plain with them the int8 values."""
    x, w, _ = conv_case
    jdt, tdt = dt
    for dims in ((1, 2, 3), None):
        jqv, js = jq.quantize_symmetric(jnp.asarray(x).astype(jdt), axis=dims)
        tqv, ts = tq.quantize_symmetric(_t(x).to(tdt), dims=dims)
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        if dims is not None:
            xs = act_scale_plain(_t(x).to(tdt))
            assert xs.dtype == torch.float32 and torch.equal(act_scale(_t(x).to(tdt)), xs)
            np.testing.assert_array_equal(xs.numpy(), np.asarray(js).reshape(-1))
            np.testing.assert_array_equal(quantize_plain(_t(x).to(tdt), xs).numpy(), np.asarray(jqv))
    jkq, jks = jq.quantize_kernel(jnp.asarray(w).astype(jdt))
    tkq, tks = tq.quantize_kernel(_t(w).to(tdt).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(tkq.permute(2, 3, 1, 0).numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    zq, zs = tq.quantize_symmetric(torch.zeros(2, 3, 4, 5, dtype=tdt), dims=(1, 2, 3))
    jzq, jzs = jq.quantize_symmetric(jnp.zeros((2, 3, 4, 5), jdt), axis=(1, 2, 3))
    assert not zq.any() and np.array_equal(zs.numpy(), np.asarray(jzs)) and float(zs.flatten()[0]) == np.float32(1e-12)


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_qconv2d_matches_jax_bit_for_bit(conv_case, dt, bias):
    """qconv2d (Q1s's and Q1's plain versions on the CPU) equals JAX's
    qconv2d bit for bit in f32 and bf16, with and without bias, and so does
    Q1's plain version called on its own with Q1s's scales; a sample alone
    gives the same numbers as in its batch (per-sample scales)."""
    x, w, b = conv_case
    jdt, tdt = dt
    want = jq.qconv2d(jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b) if bias else None)
    got = tq.qconv2d(_t(x).to(tdt), _t(w).permute(3, 2, 0, 1), _t(b) if bias else None)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), _np32(want))
    alone = tq.qconv2d(_t(x[1:2]).to(tdt), _t(w).permute(3, 2, 0, 1), _t(b) if bias else None)
    assert torch.equal(alone[0], got[1])
    wq, ks = tq.quantize_kernel(_t(w).permute(3, 2, 0, 1))
    xt = _t(x).to(tdt)
    plain = qconv_int8_plain(xt, act_scale_plain(xt), wq, ks, _t(b) if bias else None)
    assert plain.dtype == tdt and torch.equal(plain, got)
    one = qconv_int8_plain(xt[2:], act_scale_plain(xt[2:]), wq, ks, _t(b) if bias else None)
    assert torch.equal(one[0], plain[2])


@pytest.mark.parametrize("ci,co,k", [(3, 12, 5), (54, 48, 3), (8, 2, 7), (46, 40, 3), (20, 24, 1)])
def test_q1_packing_is_exact(ci, co, k):
    """The packed weight Q1 reads holds every int8 value once, zero past Ci
    and Co: on the tensor cores (Ci >= 16, Co >= 8) K-major k-steps in
    (N tile, Ci chunk of 32 or 64, ky, kx, k-step, n, 32-byte row) order
    with the row's 16-byte halves swapped in rows 4-7 of every 8; on the
    CUDA cores (Co tile, Ci chunk of 16, ky, kx, word, co, byte) order. The
    plain version's integer conv is exact at the int32 edge (all ±127 over
    6,400 products is < 2^31)."""
    g = torch.Generator().manual_seed(ci)
    wq = torch.randint(-127, 128, (co, ci, k, k), generator=g, dtype=torch.int8)
    if tensor_cores(ci, co):
        t = n_tile(co)
        for kc in (32, 64):
            p = pack_weights(wq, kc)
            assert p.dtype == torch.int8 and p.is_contiguous()
            assert p.shape == packed_shape(co, ci, k, kc) == (-(-co // t), -(-ci // kc), k, k, kc // 32, t, 2, 16)
            swap = ((torch.arange(t) >> 2) & 1).bool()
            rows = p.clone()
            rows[:, :, :, :, :, swap] = p[:, :, :, :, :, swap].flip(6)  # undo the swizzle
            back = rows.permute(0, 5, 1, 4, 6, 7, 2, 3).reshape(p.shape[0] * t, p.shape[1] * kc, k, k)
            assert torch.equal(back[:co, :ci], wq) and not back[co:].any() and not back[:, ci:].any()
    else:
        t = co_tile(co)
        p = pack_weights(wq)
        assert p.dtype == torch.int32 and p.shape == packed_shape(co, ci, k) == (-(-co // t), -(-ci // 16), k, k, 4,
                                                                                t, 1)
        b = p.view(torch.int8).reshape(p.shape[0], p.shape[1], k, k, 4, t, 4)
        back = b.permute(0, 5, 1, 4, 6, 2, 3).reshape(p.shape[0] * t, p.shape[1] * 16, k, k)
        assert torch.equal(back[:co, :ci], wq) and not back[co:].any() and not back[:, ci:].any()
    x = torch.full((1, 6, 7, 256), 127.0)
    we = torch.full((3, 256, 5, 5), -127, dtype=torch.int8)
    y = qconv_int8_plain(x, torch.ones(1), we, torch.ones(3))
    assert float(y[0, 3, 3, 0]) == -127.0 * 127 * 6400
    assert torch.equal(qconv_int8(x, act_scale(x), we, torch.ones(3)), y)


def test_qconv2d_refuses_groups():
    with pytest.raises(ValueError, match=r"groups=2.*\(1, 4, 4, 4\)"):
        tq.qconv2d(torch.zeros(1, 4, 4, 4), torch.zeros(4, 2, 3, 3), groups=2)


def _with_biases(flat, seed):
    rng = np.random.default_rng(seed)
    for k in flat:  # non-zero biases, so the bias paths count
        if k.endswith(("bias", "/b")):
            flat[k] = (rng.standard_normal(flat[k].shape) * 0.05).astype(np.float32)
    return flat


def _model_case(kind):
    """(port model, JAX model, input shape, JAX apply args) of a tiny
    quantized model."""
    if kind == "wdsr":
        return BasicModel(2, 8, 2, quantized=True), JBasicModel(2, 8, 2, quantized=True), (1, 12, 14, 3), ()
    if kind == "result":
        return ResultNet(2, IDX, quantized=True), JResultNet(2, IDX, quantized=True), (1, 12, 14, 3), ()
    if kind == "basic":
        return (BasicVSR(8, 1, 4, quantized=True), JBasicVSR(num_feat=8, num_block=1, scale=4, quantized=True),
                (1, 2, 16, 16, 3), (64, 64))
    if kind == "multi":
        return (NaiveMultiModel(4, IDX, quantized=True), JNaiveMultiModel(scale=4, idx=IDX, quantized=True),
                (1, 2, 16, 16, 3), (64, 64))
    if kind == "single":
        return (SingleImageModel(4, 8, 2, 3, quantized=True),
                JSingleImageModel(scale=4, channel=8, blocks=2, kernel=3, quantized=True), (1, 2, 12, 12, 3), (48, 48))
    return (MotionVectorVSR(8, 1, 4, quantized=True), JMotionVectorVSR(num_feat=8, num_block=1, scale=4,
                                                                        quantized=True), (1, 2, 12, 12, 5), (48, 48))


@pytest.mark.parametrize("kind", ["wdsr", "result", "basic", "multi", "single", "basic_mv"])
def test_quantized_model_matches_jax(kind):
    """Each model JAX offers --quantize int8 for, quantized, against JAX's
    quantized forward on the same weights and input (MODEL_TOL, see the
    module note); and not the float model's output."""
    m, jm, shape, args = _model_case(kind)
    flat = _with_biases(random_jax_params(m, seed=3), 3)
    load_params_npz(m, flat).eval()
    x = np.random.default_rng(5).random(shape, dtype=np.float32)
    if kind == "basic_mv":
        x[..., 3:] = (x[..., 3:] - 0.5) * 4  # motion vectors of up to 2 pixels
    want = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a, *args))(_tree(flat), jnp.asarray(x)))
    with torch.inference_mode():
        got = m(_t(x), *args).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_TOL * top)
    assert np.abs(got - want).mean() < 1e-3 * top  # the flips are rare


def test_refusals_match_jax():
    """The registry's and the entry points' int8 refusals carry the JAX
    package's messages."""
    params = argparse_ns(model_type="NAS_MODEL", quantize="int8", num_blocks=2, num_residual_units=8, scale=2)
    with pytest.raises(ValueError) as jax_err:
        j_get_model(params)
    with pytest.raises(ValueError) as port_err:
        get_model(params, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as jax_err:
        j_get_vsr_model("multi_v1", block_index_path=ARTIFACT, quantized=True)
    with pytest.raises(ValueError) as port_err:
        get_vsr_model("multi_v1", block_index_path=ARTIFACT, quantized=True, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    # a quantized layer runs its int8 conv in train mode too
    layer = BasicModel(1, 8, 2, quantized=True).WNConv_0
    x = torch.rand(1, 4, 4, 3)
    assert torch.equal(layer.forward_live(x), layer(x))


def argparse_ns(**kw):
    import argparse

    return argparse.Namespace(**kw)


def test_quantized_entry_points(tmp_path):
    """--quantize int8 through cli.pretrain and cli.retrain_searched (with
    --eval_only; without it they raise JAX's message), cli.test_vsr and
    cli.serve on the CPU; cli.train_vsr refuses it as JAX's trainer does."""
    sisr = ["--dataset", "synthetic_isr", "--eval_datasets", "synthetic_isr", "--device", "cpu", "--quantize", "int8"]
    res = pretrain.main(["--job_dir", str(tmp_path / "p"), "--num_blocks", "2", "--num_residual_units", "8",
                         "--eval_only", *sisr])["synthetic_isr"]
    assert all(np.isfinite(v) for v in res.values())
    res = retrain_searched.main(["--job_dir", str(tmp_path / "r"), "--block_index", ARTIFACT, "--eval_only",
                                 *sisr])["synthetic_isr"]
    assert all(np.isfinite(v) for v in res.values())
    for main, argv in ((pretrain.main, ["--num_blocks", "1"]), (retrain_searched.main, ["--block_index", ARTIFACT])):
        with pytest.raises(SystemExit, match="--quantize is inference-only: add --eval_only"):
            main(["--job_dir", str(tmp_path / "x"), *argv, *sisr])
    vsr = ["--job_dir", str(tmp_path / "v"), "--device", "cpu", "--dataset", "synthetic_vsr", "--eval_datasets",
           "synthetic_vsr", "--synthetic_clips", "1", "--synthetic_frames", "3", "--synthetic_size", "32",
           "--image_batch", "3", "--quantize", "int8"]
    res = test_vsr.main(vsr)["synthetic_vsr"]
    assert all(np.isfinite(v) for v in res.values())
    with pytest.raises(SystemExit, match="--quantize is inference-only \\(use test_vsr / serve\\)"):
        train_vsr.main(vsr)
    from PIL import Image

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(frames / f"{i:03d}.png")
    stats = serve.main(["--job_dir", str(tmp_path / "s"), "--input_dir", str(frames), "--device", "cpu", "--scale",
                        "2", "--chunk_frames", "2", "--chunk_overlap", "1", "--quantize", "int8", "--flow_cache"])
    assert stats["frames"] == 3 and len(os.listdir(stats["out"])) == 3
