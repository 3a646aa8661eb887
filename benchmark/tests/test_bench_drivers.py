"""Each driver rehearsed on the CPU at a tiny size, through the port's plain
paths: the same loop, bookkeeping and check as on the card. In float32 the
port and the reference agree to rounding, so the whole served path (flow
cache, window scheme, batching of streams) and the training step are held
to tight tolerances here."""

import pytest
import torch

from benchmark.harness import cell as cells

CPU = torch.device("cpu")
SEED = 2**31 + 99  # more than 32 signed bits hold
TINY_SERVE = {"lr_hw": [32, 48], "out_hw": [136, 200], "clip_frames": 7, "check_windows": 2}
TINY_TRAIN = {"frames": 3, "lr_hw": [16, 16], "pool_batches": 4}


@pytest.mark.parametrize("name,streams", [("serve.basicvsr_mobile.s4_cached", 2), ("serve.basicvsr.s1_plain", 1)])
def test_serve_driver_float32_matches_reference(name, streams):
    tiny = dict(TINY_SERVE, streams=streams, dtype="float32")
    if name == "serve.basicvsr.s1_plain":
        tiny.update(lr_hw=[16, 24], out_hw=[72, 100])
    res = cells.run_driver(name, SEED, 0.5, CPU, traffic_override=tiny)
    errors = res["notes"]["errors"]
    assert errors["max_abs_err"] < 1e-5 and errors["rms_err"] < 1e-6
    e2e = res["end_to_end"]
    assert e2e["frames_per_s"] > 0 and e2e["frame_latency_p95_ms"] > 0 and e2e["setup_s"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    checked = res["notes"]["checked_windows"]
    assert checked[0] == 0 and len(checked) >= 3  # the first window, the sample, the flushed last


@pytest.mark.parametrize("variant", ["bf16", "int8", "bf16+int8"])
def test_serve_driver_runs_the_control_paths(variant):
    """The port's own lower-precision paths, which the control readings
    serve through the same driver: each runs the cell's mix and its check."""
    from benchmark.harness import control

    res = control.run("serve.basicvsr_mobile.s4_cached", SEED, 0.5, variant, CPU,
                      traffic_override=dict(TINY_SERVE, streams=2))
    assert {c["name"] for c in res["checks"]} == set(
        cells.find("serve.basicvsr_mobile.s4_cached")[3]["limits"])
    errors = res["notes"]["errors"]
    assert 1e-4 < errors["rel_err"] and errors["max_abs_err"] < 0.1


def test_train_driver_matches_reference():
    res = cells.run_driver("train.basicvsr_mobile.b2t10p64", SEED, 0.5, CPU, traffic_override=TINY_TRAIN)
    values = {c["name"]: c["value"] for c in res["checks"]}
    assert values["loss_gap"] < 1e-5 and values["grad_norm_gap"] < 1e-4 and values["change_norm_gap"] < 1e-4
    assert res["end_to_end"]["step_ms"] > 0 and res["attempted"] >= 1 and res["failed"] == 0


def test_run_refuses_without_a_card(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "serve.basicvsr_mobile.s4_cached", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys

    from benchmark import run

    assert run.forbidden_modules() == [] or "jax" in sys.modules  # this sandbox's tests may load JAX elsewhere
    monkeypatch.setitem(sys.modules, "mobilesuperresolution_tpu_torch_fake", sys)
    assert "mobilesuperresolution_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mobilesuperresolution_tpu.fake", sys)
    assert "mobilesuperresolution_tpu" in run.forbidden_modules()
