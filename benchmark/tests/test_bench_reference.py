"""The plain reference against the port's CPU path (its kernels' plain
versions) at a tiny size, in float32: the comparison lives here, never in the
reference, which imports nothing of the port."""

import os

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import traffic, weights
from benchmark.reference import basicvsr as ref

CPU = torch.device("cpu")


def _config(name):
    return cells.load_json(os.path.join(cells.ROOT, "benchmark", "configs", name + ".json"))


def _port_model(config, flow_downscale=1):
    from mobilesuperresolution_tpu_torch.models import get_vsr_model

    return get_vsr_model(config["model_type"], scale=config["scale"], device="cpu", flow_downscale=flow_downscale)


def _clip(seed, frames, h, w):
    pool = traffic.clip_pool(seed, 1, frames, h, w, [[1, 0], [-2, 1]])
    return torch.from_numpy(pool[0])  # (T, h, w, 3)


@pytest.mark.parametrize("name,hw,downscale", [("basicvsr_mobile_x4", (32, 48), 1), ("basicvsr_mobile_x4", (32, 48), 2),
                                               ("basicvsr_x4", (16, 24), 1)])
def test_forward_matches_port(name, hw, downscale):
    config = _config(name)
    model = _port_model(config, downscale)
    params = weights.make(config, 11, CPU)
    weights.load_into(model, params)
    clip = _clip(3, 5, *hw)
    out_hw = (hw[0] * 4 + 8, hw[1] * 4 + 8)
    with torch.inference_mode():
        got = model(clip[None], *out_hw)  # (1, T, H, W, 3)
    want = ref.forward(params, config, clip.permute(0, 3, 1, 2)[None], out_hw, downscale)
    assert float((got - want.permute(0, 1, 3, 4, 2)).abs().max()) < 2e-5
    # keep: only the requested frames, each equal to the full forward's
    part = ref.forward(params, config, clip.permute(0, 3, 1, 2)[None], out_hw, downscale, keep=[1, 3])
    assert torch.allclose(part, want[:, [1, 3]], atol=1e-6)


def test_window_indices_replicate_edges():
    assert ref.window_indices(0, 4, 4, 7) == [0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7]
    assert ref.window_indices(8, 4, 4, 15) == list(range(4, 16))
    assert ref.window_indices(8, 4, 4, 9) == [4, 5, 6, 7, 8, 9, 9, 9, 9, 9, 9, 9]


def test_training_steps_match_port():
    from mobilesuperresolution_tpu_torch.parallel.mesh import shard_batch
    from mobilesuperresolution_tpu_torch.train.checkpoint import jax_named_parameters
    from mobilesuperresolution_tpu_torch.train.state import spynet_frozen_mask, vsr_multistep_adam
    from mobilesuperresolution_tpu_torch.train.steps import make_vsr_step

    config = _config("basicvsr_mobile_x4")
    model = _port_model(config)
    params = weights.make(config, 5, CPU)
    weights.load_into(model, params)
    model.train()
    named = jax_named_parameters(model)
    mask = spynet_frozen_mask(named)
    opt = vsr_multistep_adam(named, 1e-4, 100, 10, trainable_mask=mask)
    step = make_vsr_step(model, opt, (64, 64))
    batches = traffic.train_batches(9, 2, 2, 3, (16, 16), 4, [[1, 0], [0, 1]])
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(step(shard_batch(CPU, b))["loss"]))
        if i == 0:
            first = {k: opt.opt.state[named[k]]["exp_avg"] / 0.1 for k in named if mask[k]}
    clips = [tuple(torch.from_numpy(a).permute(0, 1, 4, 2, 3) for a in b) for b in batches]
    want_losses, want_first, want_after = ref.train_steps(params, config, clips, 1e-4, (0.9, 0.99),
                                                          lambda k: not k.startswith("spynet/"), (64, 64))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for k, g in want_first.items():
        assert float((first[k] - g).abs().max()) <= 1e-4 * float(g.abs().max()) + 1e-9, k
    # the parameters' change by the check's own measure (drivers/train_step.py::gaps): Adam moves an element
    # whose gradient is round-off by a full step either way, so single elements would compare the CPU's
    # summation order
    from benchmark.drivers.train_step import gaps

    trainable = [k for k in named if mask[k]]
    got = {"losses": losses, "first": first, "after": {k: named[k].detach() for k in trainable}}
    want = {"losses": want_losses, "first": want_first, "after": {k: want_after[k] for k in trainable}}
    g = gaps(got, want, params)
    assert g["change_norm_gap"] < 1e-5 and not g["quiet_leaves"]
    for k in named:
        if not mask[k]:
            assert torch.equal(named[k].detach(), params[k]) and torch.equal(want_after[k], params[k]), k


def test_weights_seeded_and_shaped():
    config = _config("basicvsr_x4")
    a, b = weights.make(config, 2**31 + 7, CPU), weights.make(config, 2**31 + 7, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert {k: tuple(v.shape) for k, v in a.items()} == weights.shapes(config)
    assert not torch.equal(a["upconv1/Conv_0/kernel"], weights.make(config, 8, CPU)["upconv1/Conv_0/kernel"])
    assert all(float(a[f"spynet/level_{i}/conv4_bias"].abs().max()) == 0.0 for i in range(6))
