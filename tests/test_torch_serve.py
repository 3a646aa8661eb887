"""Port serving: StreamingVSR equals chunked_vsr_apply (port, bit for bit)
and the JAX package's streaming output (float32, 1e-4 absolute: the model
tolerance of tests/test_torch_models.py); the flow-cached stream equals the
plain one (1e-5: SpyNet sees another batch size), computes each pair once
and stays bounded; BasicVSR with flow_downscale 2 matches JAX's (1e-5); plus
the serve CLI on PNG frames with --device cpu."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers.jax_compile import unoptimized_xla  # noqa: F401 (a fixture)

from mobilesuperresolution_tpu.models.basicvsr import BasicVSR as JBasicVSR
from mobilesuperresolution_tpu.serve import StreamingVSR as JStreamingVSR
from mobilesuperresolution_tpu_torch.models.basicvsr import BasicVSR
from mobilesuperresolution_tpu_torch.parallel.temporal import chunked_vsr_apply
from mobilesuperresolution_tpu_torch.serve import FlowCachedStreamingVSR, StreamingVSR, make_flow_sr_fns
from mobilesuperresolution_tpu_torch.train.checkpoint import load_params_npz, random_jax_params

torch.set_num_threads(2)
H, W, OH, OW = 16, 20, 32, 40


def _models(flow_downscale=1):
    """(JAX jitted apply, port model) of one tiny x2 BasicVSR, both on the
    same seeded random weights in the JAX layout (the bridge's: no jitted
    JAX init to compile)."""
    jm = JBasicVSR(num_feat=8, num_block=1, scale=2, flow_downscale=flow_downscale)
    tm = BasicVSR(num_feat=8, num_block=1, scale=2, flow_downscale=flow_downscale)
    flat = random_jax_params(tm, seed=0)
    load_params_npz(tm, flat)
    params = {}
    for key, arr in flat.items():
        node = params
        *scopes, leaf = key.split("/")
        for sc in scopes:
            node = node.setdefault(sc, {})
        node[leaf] = jnp.asarray(arr)
    return jax.jit(lambda x, oh, ow: jm.apply({"params": params}, x, oh, ow), static_argnums=(1, 2)), tm


@pytest.fixture(scope="module")
def pair():
    """(JAX jitted apply, port apply, port model) of one tiny x2 BasicVSR."""
    j_apply, tm = _models()

    def t_apply(x, oh, ow):
        with torch.inference_mode():
            return tm(x, oh, ow)

    return j_apply, t_apply, tm


def _stream(stream, clip):
    got = []
    for i in range(clip.shape[1]):
        got.extend(stream.push(clip[:, i] if stream.num_streams > 1 else clip[0, i]))
    got.extend(stream.flush())
    return got


def test_streaming_matches_chunked_and_jax(pair, rng):
    j_apply, t_apply, _ = pair
    t, chunk, overlap = 7, 2, 1  # 4 windows of 4 frames, the last one short
    clip = rng.random((1, t, H, W, 3)).astype(np.float32)
    want = chunked_vsr_apply(t_apply, torch.from_numpy(clip), OH, OW, chunk, overlap).numpy()
    got = _stream(StreamingVSR(t_apply, OH, OW, chunk=chunk, overlap=overlap, device="cpu"), clip)
    assert len(got) == t
    np.testing.assert_array_equal(np.stack(got)[None], want)
    j_got = _stream(JStreamingVSR(j_apply, OH, OW, chunk=chunk, overlap=overlap), clip)
    np.testing.assert_allclose(np.stack(got), np.stack(j_got), atol=1e-4)


def test_chunked_short_clip_runs_unwindowed(pair, rng):
    _, t_apply, _ = pair
    clip = torch.from_numpy(rng.random((1, 4, H, W, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        chunked_vsr_apply(t_apply, clip, OH, OW, chunk=2, overlap=1).numpy(), t_apply(clip, OH, OW).numpy()
    )
    with pytest.raises(ValueError):
        chunked_vsr_apply(t_apply, clip, OH, OW, chunk=0)


def test_streaming_emission_order_and_lookahead(pair, rng):
    _, t_apply, _ = pair
    t, chunk, overlap = 9, 2, 1
    clip = rng.random((1, t, H, W, 3)).astype(np.float32)
    stream = StreamingVSR(t_apply, OH, OW, chunk=chunk, overlap=overlap, device="cpu")
    emitted = 0
    for i in range(t):
        emitted += len(stream.push(clip[0, i]))
        max_dispatched = max(0, i + 1 - chunk - overlap + 1)
        assert emitted <= ((max_dispatched + chunk - 1) // chunk) * chunk
    emitted += len(stream.flush())
    assert emitted == t
    with pytest.raises(RuntimeError):
        stream.push(clip[0, 0])


def test_multistream_matches_solo(pair, rng):
    _, t_apply, _ = pair
    clip = rng.random((2, 7, H, W, 3)).astype(np.float32)
    multi = np.stack(_stream(StreamingVSR(t_apply, OH, OW, chunk=2, overlap=1, num_streams=2, device="cpu"), clip))
    for s in range(2):
        solo = np.stack(_stream(StreamingVSR(t_apply, OH, OW, chunk=2, overlap=1, device="cpu"), clip[s : s + 1]))
        np.testing.assert_allclose(multi[:, s], solo, atol=1e-6)


def test_streaming_rejects_bad_config(pair, monkeypatch):
    _, t_apply, _ = pair
    for kw in (dict(chunk=0), dict(chunk=2, overlap=-1), dict(num_streams=0)):
        with pytest.raises(ValueError):
            StreamingVSR(t_apply, OH, OW, device="cpu", **kw)
    s = StreamingVSR(t_apply, OH, OW, num_streams=2, device="cpu")
    with pytest.raises(ValueError):
        s.push(np.zeros((3, H, W, 3), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingVSR(t_apply, OH, OW)


def _cached(tm, chunk, overlap, num_streams=1):
    flow_fn, sr_fn = make_flow_sr_fns(tm, OH, OW)
    return FlowCachedStreamingVSR(flow_fn, sr_fn, OH, OW, chunk=chunk, overlap=overlap, num_streams=num_streams,
                                  device="cpu")


def test_flow_cached_stream_matches_plain(pair, rng):
    """Two lockstep streams, flow-cached, equal the plain stream and
    chunked_vsr_apply over the clip."""
    _, t_apply, tm = pair
    t, chunk, overlap = 9, 3, 2
    clip = rng.random((2, t, H, W, 3)).astype(np.float32)
    want = chunked_vsr_apply(t_apply, torch.from_numpy(clip), OH, OW, chunk, overlap).numpy()
    plain = np.stack(_stream(StreamingVSR(t_apply, OH, OW, chunk=chunk, overlap=overlap, num_streams=2,
                                          device="cpu"), clip), axis=1)
    stream = _cached(tm, chunk, overlap, num_streams=2)
    stream.warmup((H, W, 3))
    got = np.stack(_stream(stream, clip), axis=1)
    assert got.shape == (2, t, OH, OW, 3)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flow_cached_computes_each_pair_once(pair, rng, monkeypatch):
    """No pair flow is computed twice, every pair the windows need is
    computed, and the cache and frame buffer stay bounded by the window,
    not the stream; flush() clears the cache."""
    _, _, tm = pair
    t, chunk, overlap = 17, 3, 2
    clip = rng.random((t, H, W, 3)).astype(np.float32)
    stream = _cached(tm, chunk, overlap)
    computed = []
    orig = FlowCachedStreamingVSR._ensure_flows

    def spying(self, pairs):
        computed.extend(k for k in dict.fromkeys(pairs) if k not in self._pair_flows)
        return orig(self, pairs)

    monkeypatch.setattr(FlowCachedStreamingVSR, "_ensure_flows", spying)
    n_out = max_cache = max_frames = 0
    for i in range(t):
        n_out += len(stream.push(clip[i]))
        max_cache = max(max_cache, len(stream._pair_flows))
        max_frames = max(max_frames, len(stream._frames))
    n_out += len(stream.flush())
    assert n_out == t
    assert len(computed) == len(set(computed))
    assert set(computed) == {(i, i + 1) for i in range(t - 1)} | {(0, 0), (t - 1, t - 1)}
    assert max_frames <= stream.window + chunk
    assert max_cache <= stream.window + 2 * chunk
    assert not stream._pair_flows


def test_flow_downscale_matches_jax(rng, unoptimized_xla):
    """BasicVSR with SpyNet on half-size frames (flow_downscale 2) against the
    JAX model on the same weights; and get_vsr_model's check of the value."""
    j_apply, tm = _models(flow_downscale=2)
    x = rng.random((1, 3, H, W, 3)).astype(np.float32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), OH, OW).numpy()
    np.testing.assert_allclose(got, np.asarray(j_apply(jnp.asarray(x), OH, OW)), atol=1e-5)
    from mobilesuperresolution_tpu_torch.models import get_vsr_model

    assert get_vsr_model("basic", device="cpu", flow_downscale=2).flow_downscale == 2
    with pytest.raises(ValueError, match="flow_downscale"):
        get_vsr_model("basic", device="cpu", flow_downscale=0)
    # the height-sharded split (tests/test_torch_parallel.py) checks its shards first
    _, sr_fn = make_flow_sr_fns(tm, OH, OW, mesh=3)
    f = torch.zeros(1, 1, H, W, 2)
    with pytest.raises(ValueError, match="not divisible by 3 spatial shards"):
        sr_fn(torch.zeros(1, 2, H, W, 3), f, f)


def _frames(tmp_path, rng, name, t):
    from PIL import Image

    d = tmp_path / name
    d.mkdir()
    for i in range(t):
        Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(d / f"{i:04d}.png")
    return str(d)


def _serve(argv):
    from mobilesuperresolution_tpu_torch.cli import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_serve_cli(tmp_path, rng):
    from PIL import Image

    d = _frames(tmp_path, rng, "frames", 7)
    job = tmp_path / "job"
    stats = _serve(["--job_dir", str(job), "--input_dir", d, "--scale", "2", "--chunk_frames", "2",
                    "--chunk_overlap", "1", "--device", "cpu"])
    out = sorted(os.listdir(job / "serve"))
    assert len(out) == 7 and stats["frames"] == 7 and stats["lookahead_frames"] == 2
    assert np.asarray(Image.open(job / "serve" / out[0])).shape == (2 * H, 2 * W, 3)


def test_serve_cli_flow_cache(tmp_path, rng):
    d = _frames(tmp_path, rng, "frames", 6)
    job = tmp_path / "job"
    stats = _serve(["--job_dir", str(job), "--input_dir", d, "--scale", "2", "--chunk_frames", "2",
                    "--chunk_overlap", "1", "--flow_cache", "--flow_downscale", "2", "--device", "cpu"])
    assert stats["frames"] == 6 and len(os.listdir(job / "serve")) == 6


def test_serve_cli_multistream_bf16_paced(tmp_path, rng):
    dirs = [_frames(tmp_path, rng, f"frames{s}", 5) for s in range(2)]
    job = tmp_path / "job"
    stats = _serve(["--job_dir", str(job), "--input_dir", ",".join(dirs), "--scale", "2",
                    "--height", "30", "--width", "44", "--chunk_frames", "2", "--chunk_overlap", "1",
                    "--bf16", "--arrival_fps", "100", "--device", "cpu"])
    assert stats["streams"] == 2 and stats["frames"] == 10 and stats["arrival_fps"] == 100
    for s in range(2):
        assert len(os.listdir(job / "serve" / f"stream{s}")) == 5


def test_serve_cli_eval_model_no_save(tmp_path, rng):
    """--eval_model loads a JAX checkpoint through the bridge (the shipped
    x4 weights are nf 16, not the CLI's nf 24: the bridge refuses them)."""
    d = _frames(tmp_path, rng, "frames", 4)
    npz = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "artifacts", "convergence", "basicvsr_x4", "weights", "models.npz")
    with pytest.raises(KeyError):
        _serve(["--job_dir", str(tmp_path / "job"), "--input_dir", d, "--eval_model", npz, "--device", "cpu"])
    from mobilesuperresolution_tpu_torch.models import get_vsr_model

    ours = str(tmp_path / "models.npz")
    np.savez(ours, **random_jax_params(get_vsr_model("basic", device="cpu"), seed=3))
    stats = _serve(["--job_dir", str(tmp_path / "job"), "--input_dir", d, "--eval_model", ours,
                    "--no_save", "--device", "cpu"])
    assert stats["out"] is None and stats["frames"] == 4


def test_serve_cli_needs_cuda_or_cpu_flag(tmp_path, rng, monkeypatch):
    d = _frames(tmp_path, rng, "frames", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _serve(["--job_dir", str(tmp_path / "job"), "--input_dir", d])
