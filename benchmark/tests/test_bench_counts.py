"""The yardstick's operation and byte counts against values worked by hand at
small shapes, and the trace arithmetic on made-up events."""

import os

import pytest

from benchmark.harness import cell as cells
from benchmark.harness import counts, trace


def _config(name):
    return cells.load_json(os.path.join(cells.ROOT, "benchmark", "configs", name + ".json"))


def test_live_taps():
    assert counts.live_taps(4, 3) == 3 + 4 + 3
    assert counts.live_taps(5, 7) == 2 + 3 + 4 + 5 + 4 + 3 + 2
    assert counts.live_taps(1, 7) == 1
    assert counts.live_taps(10, 1) == 10


def test_conv_counts():
    # 3x3 SAME on a 4x4 map, 2 -> 3 channels: 10 x 10 live (pixel, tap) pairs
    assert counts.conv_flops(1, 4, 4, 2, 3, 3) == 2 * 2 * 3 * 10 * 10
    assert counts.conv_flops(5, 4, 4, 2, 3, 3) == 5 * 1200
    # bf16: input 4*4*2, output 4*4*3, weights 9*2*3 + bias 3, 2 bytes each
    assert counts.conv_bytes(1, 4, 4, 2, 3, 3, 2) == 2 * (32 + 48 + 54 + 3)


def test_least_seconds():
    assert counts.least_seconds(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert counts.least_seconds(495e12, 0, "float32") == pytest.approx(1.0)
    assert counts.least_seconds(1.0, 3.35e12, "bfloat16") == pytest.approx(1.0)


def test_spynet_levels_and_routes():
    assert counts.spynet_levels(64, 64) == [(2, 2), (4, 4), (8, 8), (16, 16), (32, 32), (64, 64)]
    assert counts.spynet_levels(120, 213) == [(4, 7), (8, 14), (16, 28), (32, 56), (64, 112), (128, 224)]
    assert len(counts.spynet_convs(120, 213, "bfloat16")) == 30
    assert len(counts.spynet_convs(120, 213, "bfloat16", even_only=True)) == 25  # 4x7 runs off B1
    # one level's first conv (8 -> 32, 7x7) at 2x2: every tap of a 7-wide kernel
    # meets live pixels 2 + 1 + 1 times per axis for d in -1..1, 0 beyond
    first = counts.spynet_convs(64, 64, "float32")[0]
    assert first[0] == 2 * 8 * 32 * counts.live_taps(2, 7) ** 2 == 2 * 8 * 32 * 16
    assert first[1] == 4 * (2 * 2 * 8 + 2 * 2 * 32 + 49 * 8 * 32 + 32)


def test_mobile_reconstruction_counts():
    cfg = _config("basicvsr_mobile_x4")
    flops, nbytes = counts.transpose_conv(cfg, 1, 1, "bfloat16")
    assert flops == 2 * 25 * 48 * 3
    assert nbytes == 2 * (48 + 5 * 5 * 3 + 25 * 48 * 3 + 3)
    # fusion 1x1 48 -> 48 on one pixel plus the transpose conv
    assert counts.reconstruction_flops(cfg, 1, 1) == 2 * 48 * 48 + 7200


def test_trunk_counts():
    cfg = _config("basicvsr_mobile_x4")
    # on a 1x1 frame only the centre tap is live: conv0 27 -> 24, 16 convs 24 -> 24
    assert counts.trunk_flops(cfg, 1, 1) == 2 * 27 * 24 + 16 * 2 * 24 * 24
    origin = _config("basicvsr_x4")
    up = counts.upconvs(origin, 1, 1, "float32")
    assert up[0][0] == 2 * 64 * 256
    assert up[1][0] == 2 * 64 * 256 * 4 * 4  # a 2x2 map: (1 + 2 + 1) live (pixel, tap) pairs per axis
    assert counts.frame_flops(origin, 1, 1) == (
        2 * (2 * 67 * 64 + 60 * 2 * 64 * 64) + 2 * 128 * 64 + up[0][0] + up[1][0]
        + counts.conv_flops(1, 4, 4, 64, 64, 3) + counts.conv_flops(1, 4, 4, 64, 3, 3))


def test_serve_window_and_train_step_work():
    cfg = _config("basicvsr_mobile_x4")
    tr = {"streams": 2, "lr_hw": [32, 32], "dtype": "bfloat16", "chunk": 4, "overlap": 4,
          "flow_cache": True, "flow_downscale": 1}
    flops, calls, b1, b2 = counts.serve_window(cfg, tr)
    spy = sum(f for f, _ in counts.spynet_convs(32, 32, "bfloat16"))
    assert calls == 2 * 2 * 4
    assert flops == 2 * 12 * counts.frame_flops(cfg, 32, 32) + calls * spy
    plain = dict(tr, flow_cache=False)
    assert counts.serve_window(cfg, plain)[1] == 2 * 2 * 11
    assert b1 > 0 and b2 > 0
    step = counts.train_step(cfg, {"batch": 2, "frames": 3, "lr_hw": [32, 32], "dtype": "float32"})
    assert step[0] == 3 * 6 * counts.frame_flops(cfg, 32, 32) + 2 * 2 * 2 * spy


def test_union_and_breakdown():
    ev = [("void k1<int>(int)", 0.0, 1.0, "kernel"), ("k2", 0.5, 1.5, "kernel"),
          ("Memcpy DtoH (Device -> Pageable)", 2.0, 3.0, "memcpy"), ("k1", 4.0, 4.5, "kernel")]
    assert trace.union(ev) == [[0.0, 1.5], [2.0, 3.0], [4.0, 4.5]]
    assert trace.busy_seconds(ev) == pytest.approx(3.0)
    assert trace.seconds_of(ev, ("k1",)) == pytest.approx(1.5)
    assert trace.seconds_of(ev, ("DtoH",), kind="memcpy") == pytest.approx(1.0)
    assert trace.count_of(ev) == 3
    b = trace.breakdown(ev)
    assert b["device_ops"][0] == ["k1", pytest.approx(1.5)]
    assert b["idle_gaps"][0] == ["Memcpy DtoH -> k1", pytest.approx(1.0)]
    assert trace.short_name("void at::native::(anonymous namespace)::f<float>(int)") == "at::native::f"


def test_readers_find_nothing_without_their_kernel():
    ctx = {"events": [("k2", 0.0, 1.0, "kernel")], "b1_least_s": 0.1, "b2_least_s": 0.1, "frames": 4,
           "frames_harvested": 4, "steps": 2, "window_s": 2.0, "busy_s": 1.0, "useful_flops": 989e12,
           "dtype": "bfloat16"}
    assert trace.roofline_pct(ctx, trace.B1_KERNELS, "b1_least_s") is None
    assert trace.idle_pct(ctx) == pytest.approx(50.0)
    assert trace.mfu_pct(ctx) == pytest.approx(50.0)
    ctx["events"].append(("void conv5x5_wgmma_kernel<1>(...)", 1.0, 1.2, "kernel"))
    assert trace.roofline_pct(ctx, trace.B1_KERNELS, "b1_least_s") == pytest.approx(50.0)


def test_manifest_readers_load():
    import importlib.util

    for m in cells.manifest()["per_layer"]:
        path = os.path.join(cells.ROOT, "benchmark", "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("m_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
